"""Policy-set compiler v2: validate rules → tri-state status programs.

Compiles pattern / anyPattern / deny / preconditions rules into
:class:`StatusExpr` trees that mirror the reference's anchor walk
(reference: pkg/engine/validate/validate.go, pkg/engine/anchor/handlers.go)
and condition evaluation (reference: pkg/engine/variables/operator/*.go).
Rules outside the vocabulary — context entries, foreach, manifests,
unresolvable variables, exotic operand shapes — fall back to the host
engine, preserving exact semantics.  Individual undecidable *checks*
(long strings, overflowing arrays, runtime wildcards) surface as
STATUS_HOST per resource instead of forcing the whole rule to host.
"""

from __future__ import annotations

import json
import re
from fractions import Fraction
from typing import Any, List, Optional, Tuple

from ..api.policy import Policy
from ..autogen.autogen import compute_rules
from ..engine import anchor as anchor_mod
from ..engine import pattern as leaf_pattern
from ..engine.validate_pattern import has_nested_anchors
from ..engine.variables import is_reference, is_variable
from ..observability.coverage import (REASON_HOST_CLOSURE,
                                      PLACEMENT_DEVICE, PLACEMENT_HOST,
                                      RulePlacement)
from ..utils.duration import parse_duration
from ..utils.quantity import Quantity
from .ir import (CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE, STR_LEN,
                 TAIL_LEN, BoolExpr, CompileError, CompiledPolicySet,
                 CondCheck, GatherSlot, Leaf, RuleProgram, Slot, StatusExpr)

_CMP_OF_OP = {
    leaf_pattern.OP_MORE: CMP_GT,
    leaf_pattern.OP_MORE_EQUAL: CMP_GE,
    leaf_pattern.OP_LESS: CMP_LT,
    leaf_pattern.OP_LESS_EQUAL: CMP_LE,
    leaf_pattern.OP_EQUAL: CMP_EQ,
    leaf_pattern.OP_NOT_EQUAL: CMP_NE,
}

# a condition key of exactly one {{ ... }} expression
_SINGLE_VAR_RE = re.compile(r'^\{\{(.*)\}\}$', re.DOTALL)


def compile_policies(policies: List[Policy]) -> CompiledPolicySet:
    cps = CompiledPolicySet()
    cps.policies = policies
    for p_idx, policy in enumerate(policies):
        for r_idx, rule in enumerate(compute_rules(policy)):
            name = rule.get('name', '')
            validate = rule.get('validate')
            path = 'pss' if isinstance(validate, dict) and \
                validate.get('podSecurity') is not None else 'validate'
            if not validate:
                # mutate/generate-only rules produce no validate responses
                # in a background scan (engine.py:254-260 _process_rule);
                # verifyImages validation stays host-side (network-bound)
                if any(iv.get('verifyDigest', True) or
                       iv.get('required', True)
                       for iv in rule.get('verifyImages') or []):
                    cps.host_rules.append((p_idx, rule, policy))
                    cps.placements.append(RulePlacement(
                        policy.name, name, path, PLACEMENT_HOST,
                        REASON_HOST_CLOSURE,
                        'verifyImages rules are network-bound', p_idx))
                continue
            try:
                program = _compile_rule(cps, policy, p_idx, r_idx, rule)
            except CompileError as e:
                cps.host_rules.append((p_idx, rule, policy))
                cps.placements.append(RulePlacement(
                    policy.name, name, path, PLACEMENT_HOST, e.reason,
                    str(e), p_idx))
                continue
            cps.programs.append(program)
            cps.placements.append(RulePlacement(
                policy.name, name, path, PLACEMENT_DEVICE, None, '',
                p_idx))
    return cps


def _compile_rule(cps: CompiledPolicySet, policy: Policy, p_idx: int,
                  r_idx: int, rule: dict) -> RuleProgram:
    if not rule.get('validate'):
        raise CompileError('not a validate rule')
    validate = rule['validate']
    context_spec = None
    context_inputs = None
    if rule.get('context'):
        # compilable when every entry is a cluster-data lookup whose
        # value feeds NO compiled lane — the load's success/failure
        # semantics are enforced per resource by the scanner (imageData
        # entries stay host-side: network-bound)
        entries = rule['context']
        if not isinstance(entries, list):
            raise CompileError('malformed context block')
        for entry in entries:
            e = entry or {}
            if not (e.get('configMap') or e.get('apiCall') or
                    e.get('variable')):
                raise CompileError(
                    'imageRegistry context entries require the host '
                    'engine', reason='api_call')
        body = json.dumps({'v': validate,
                           'p': rule.get('preconditions')})
        for entry in entries:
            nm = str((entry or {}).get('name', ''))
            if nm and re.search(r'\b' + re.escape(nm) + r'\b', body):
                raise CompileError(
                    'context entry value feeds compiled lanes')
        context_spec = tuple(entries)
        # cacheable when every consumed variable is request.object-rooted
        # AND no entry evaluates bare (un-braced) expressions per
        # resource — 'variable' entries run a jmesPath against the full
        # context, so their outcome can depend on more than the captured
        # inputs (the load then re-runs per resource)
        from ..engine.variables import RE_VARIABLES as _RV
        exprs = []
        cacheable = all((e or {}).get('configMap') or (e or {}).get('apiCall')
                        for e in entries)
        if cacheable:
            for m in _RV.finditer(json.dumps(entries)):
                expr = m.group(2)[2:-2].strip()
                if not expr.startswith('request.object'):
                    cacheable = False
                    break
                exprs.append(expr)
        context_inputs = tuple(sorted(set(exprs))) if cacheable else None
    if validate.get('manifests') is not None:
        raise CompileError('manifests rules require the host engine',
                           reason='host_closure')
    if not isinstance(rule.get('match', {}) or {}, dict) or \
            not isinstance(rule.get('exclude', {}) or {}, dict):
        raise CompileError('bad match/exclude block')

    name = rule.get('name', '')
    units: List[StatusExpr] = []
    pass_messages = (f"validation rule '{name}' passed.",)
    error_messages: List[str] = []
    pss = None
    skip_message = None
    fail_sites: Optional[List[str]] = None
    fail_prefix = None
    deny_fail_message = None
    any_fail_sites = None
    any_fail_prefix = None
    msg = (validate.get('message') or '') if isinstance(validate, dict) else ''
    static_msg = isinstance(msg, str) and '{{' not in msg and '$(' not in msg

    # preconditions gate everything (engine.py Validator.validate order)
    if rule.get('preconditions') is not None:
        pre = _compile_conditions(cps, rule['preconditions'])
        plan = _error_plan(cps, rule['preconditions'],
                           'failed to evaluate preconditions', error_messages)
        units.append(StatusExpr('precond', expr=pre, operand=plan))

    if validate.get('deny') is not None:
        conditions = (validate['deny'] or {}).get('conditions')
        deny = _compile_conditions(cps, conditions)
        plan = _error_plan(
            cps, conditions,
            'failed to substitute variables in deny conditions',
            error_messages)
        units.append(StatusExpr('deny', expr=deny, operand=plan))
        if static_msg:
            # deny FAIL message is the (static) message verbatim, or the
            # no-message fallback (engine.py:446 _deny_message)
            deny_fail_message = msg or \
                f'validation error: rule {name} failed'
    elif validate.get('pattern') is not None:
        if static_msg:
            # FAIL messages with a non-empty path are fully determined by
            # (static message, rule name, failing path) — engine.py:543
            # _error_message / reference validation.go:722
            fail_sites = []
            if msg:
                dot = msg if msg.endswith('.') else msg + '.'
                fail_prefix = (f'validation error: {dot} rule {name} '
                               f'failed at path ')
            else:
                fail_prefix = (f'validation error: rule {name} '
                               f'failed at path ')
        units.append(_compile_pattern_status(cps, validate['pattern'],
                                             sites=fail_sites))
    elif validate.get('anyPattern') is not None:
        pats = validate['anyPattern']
        if not isinstance(pats, list):
            raise CompileError('anyPattern must be a list')
        any_sites: Optional[List[List[str]]] = \
            [[] for _ in pats] if static_msg else None
        children = [
            _compile_pattern_status(
                cps, p, in_any_pattern=True,
                sites=any_sites[i] if any_sites is not None else None)
            for i, p in enumerate(pats)]
        units.append(StatusExpr('any', children=tuple(children)))
        # pass message carries the index of the sub-pattern that matched
        # (engine.py:514, reference: pkg/engine/validation.go:640)
        pass_messages = tuple(
            f"validation rule '{name}' anyPattern[{i}] passed."
            for i in range(len(pats)))
        if any_sites is not None:
            any_fail_sites = tuple(tuple(s) for s in any_sites)
            # buildAnyPatternErrorMessage prefix (engine.py:565)
            if not msg:
                any_fail_prefix = 'validation error: '
            elif msg.endswith('.'):
                any_fail_prefix = f'validation error: {msg} '
            else:
                any_fail_prefix = f'validation error: {msg}. '
    elif validate.get('podSecurity') is not None:
        # host dispatch order: podSecurity before foreach (engine.py:403)
        from .pss_compile import compile_pod_security
        units.append(compile_pod_security(cps, validate['podSecurity'],
                                          rule))
        # PSS pass messages are capitalized (engine.py:605)
        pass_messages = (f"Validation rule '{name}' passed.",)
        ps = validate['podSecurity']
        pss = (ps.get('level', ''), ps.get('version', ''))
    elif validate.get('foreach') is not None:
        units.append(_compile_foreach(cps, validate['foreach']))
        # foreach pass/skip messages are static (engine.py:625-630)
        pass_messages = ('rule passed',)
        skip_message = 'rule skipped'
        if static_msg:
            # a deny-decided element failure wraps the (static) deny
            # message (engine.py:665 'validation failure: …'); the
            # evaluator emits fdet>=0 only for unambiguous deny fails
            inner = msg or f'validation error: rule {name} failed'
            deny_fail_message = f'validation failure: {inner}'
    else:
        raise CompileError('no compilable validate sub-key')

    return RuleProgram(
        policy_name=policy.name, rule_name=name,
        policy_index=p_idx, rule_index=r_idx,
        status=StatusExpr.seq(units),
        pass_messages=pass_messages,
        error_messages=tuple(error_messages), pss=pss,
        skip_message=skip_message,
        background=policy.background, rule_raw=rule,
        context_spec=context_spec, context_inputs=context_inputs,
        fail_sites=tuple(fail_sites) if fail_sites is not None else None,
        fail_prefix=fail_prefix, deny_fail_message=deny_fail_message,
        any_fail_sites=any_fail_sites, any_fail_prefix=any_fail_prefix)


def _error_plan(cps: CompiledPolicySet, conditions: Any, prefix: str,
                messages: List[str]) -> Tuple[Tuple[GatherSlot, int], ...]:
    """Ordered (gather, message-index) plan for unresolvable condition
    variables.  Mirrors the substitution traversal order
    (variables.py _traverse, reference: pkg/engine/jsonutils/traverse.go)
    so the first missing variable produces the host's exact
    substitution-error message (engine.py:388,431)."""
    leaves: List[Tuple[str, str]] = []

    def walk(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f'{path}/{k}')
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f'{path}/{i}')
        elif isinstance(node, str):
            m = _SINGLE_VAR_RE.match(node.strip())
            if m:
                leaves.append((m.group(1).strip(), path))

    walk(conditions, '')
    plan: List[Tuple[GatherSlot, int]] = []
    for var, path in leaves:
        gather = GatherSlot(var)
        if gather not in cps.gather_index:
            raise CompileError(f'unplanned variable {var!r} in conditions')
        messages.append(
            f'{prefix}: failed to resolve {var} at path {path}: '
            f'Unknown key "{var}" in path')
        plan.append((gather, len(messages) - 1))
    return tuple(plan)


# ---------------------------------------------------------------------------
# Pattern compilation (tree-walk → StatusExpr)

def _check_no_vars(value: Any) -> None:
    if isinstance(value, str) and (is_variable(value) or is_reference(value)):
        raise CompileError(f'variable in pattern: {value!r}')
    if isinstance(value, dict):
        for k, v in value.items():
            _check_no_vars(k)
            _check_no_vars(v)
    if isinstance(value, list):
        for v in value:
            _check_no_vars(v)


# wildcard pattern-key path segment: '\x00wk:<pattern>' resolves, per
# resource, to the FIRST map key matching <pattern> (the device form of
# wildcards.ExpandInMetadata — reference pkg/engine/wildcards/wildcards.go:62)
WILD_KEY_MARK = '\x00wk:'
# site template sentinel: the failing path embeds a per-resource resolved
# key, so the message cannot be synthesized — FAIL cells go to the host
DYNAMIC_SITE = '\x00dyn'


def _wild_key_allowed(path: Tuple[str, ...]) -> bool:
    """Wildcard pattern keys resolve per-resource only under
    metadata.labels / metadata.annotations — the exact scope of the
    reference's ExpandInMetadata (wildcards.go:62, applied at every
    validateMap level, so any autogen prefix is fine)."""
    return len(path) >= 2 and path[-1] in ('labels', 'annotations') \
        and path[-2] == 'metadata'


def _path_template(path: Tuple[str, ...], parent: bool = False) -> str:
    """Host walk path for a slot path: '/spec/containers/{e0}/image/'.
    ``parent`` drops the last component (the map-level '*' shortcut
    reports the parent map's path — anchor.py:214)."""
    parts = path[:-1] if parent else path
    if any(p.startswith(WILD_KEY_MARK) for p in parts):
        return DYNAMIC_SITE
    out = '/'
    e = 0
    for p in parts:
        if p == '*':
            out += '{e%d}/' % e
            e += 1
        else:
            out += f'{p}/'
    return out


def _new_site(sites: Optional[List[str]], path: Tuple[str, ...],
              parent: bool = False) -> Optional[int]:
    if sites is None:
        return None
    sites.append(_path_template(path, parent))
    return len(sites) - 1


def _compile_pattern_status(cps: CompiledPolicySet, pattern: Any,
                            in_any_pattern: bool = False,
                            sites: Optional[List[str]] = None) -> StatusExpr:
    """Compile one pattern tree rooted at the resource document."""
    _check_no_vars(pattern)
    if not isinstance(pattern, dict):
        raise CompileError('top-level pattern must be a map')
    tracked: List[Slot] = []
    status = _compile_map(cps, pattern, (), tracked, sites)
    if in_any_pattern:
        # anyPattern sub-failures stay failures regardless of missing anchor
        # keys (engine.py:524 treats empty-path errors as plain failures) —
        # but an empty-path failure has a different message ('failed: {pe}'
        # vs 'failed at path {p}'), so the fail-detail is guarded on all
        # tracked anchor keys being present
        if sites is not None and tracked:
            guards = [BoolExpr.of(Leaf(s, 'star')) for s in tracked]
            return StatusExpr('failguard', expr=BoolExpr.all(guards),
                              sub=status)
        return status
    if not tracked:
        return status
    # single-pattern quirk (validate_pattern.match_pattern:38 +
    # engine.py:493): a plain FAIL while any tracked condition/existence/
    # negation anchor key was missing (null counts as missing) surfaces as
    # ERROR with empty path → undecidable on device, send to host
    guards = [BoolExpr.of(Leaf(s, 'star')) for s in tracked]
    return StatusExpr('trackfail', expr=BoolExpr.all(guards), sub=status)


def _phase1_sort_key(key: str) -> str:
    return key


def _compile_map(cps: CompiledPolicySet, pattern: dict,
                 path: Tuple[str, ...], tracked: List[Slot],
                 sites: Optional[List[str]] = None) -> StatusExpr:
    """Compile a pattern map at ``path`` (``'*'`` marks element scope).

    Mirrors _validate_map: phase 1 anchors in sorted key order, then plain
    keys with nested-anchor/global keys first (validate_pattern.py:77-92).
    The caller has already guarded that the resource node is a map.
    """
    anchors, plains = {}, {}
    for key, value in pattern.items():
        a = anchor_mod.parse(key)
        if anchor_mod.is_condition(a) or anchor_mod.is_existence(a) or \
                anchor_mod.is_equality(a) or anchor_mod.is_negation(a):
            anchors[key] = (a, value)
        else:
            plains[key] = (a, value)

    children: List[StatusExpr] = []

    for key in sorted(anchors, key=_phase1_sort_key):
        a, value = anchors[key]
        if _key_has_wildcard(a.key):
            # first-match key resolution happens at encode time (the
            # encoder sees the document); the host sorts phase-1 anchors
            # by the RESOLVED key, so sibling ordering is only exact
            # when the wildcard key is alone in its map
            if not _wild_key_allowed(path) or anchor_mod.is_existence(a) \
                    or len(pattern) != 1:
                raise CompileError(
                    f'wildcard pattern key not vectorized: {key}')
            if not isinstance(value, (str, int, float, bool)) \
                    and value is not None:
                raise CompileError(
                    f'wildcard pattern key with non-scalar value: {key}')
            # ExpandInMetadata stringifies the pattern values it rewrites
            value = str(value)
            child_path = path + (WILD_KEY_MARK + a.key,)
        else:
            child_path = path + (a.key,)
        slot = Slot(child_path)
        _require_depth(slot)
        cps.slot_id(slot)
        if anchor_mod.is_condition(a):
            tracked.append(slot)
            sub = _compile_element(cps, value, child_path, tracked, sites)
            children.append(StatusExpr('cond', slot=slot, sub=sub))
        elif anchor_mod.is_equality(a):
            sub = _compile_element(cps, value, child_path, tracked, sites)
            children.append(StatusExpr('equality', slot=slot, sub=sub))
        elif anchor_mod.is_negation(a):
            tracked.append(slot)
            children.append(StatusExpr(
                'negation', slot=slot,
                fail_site=_new_site(sites, child_path)))
        elif anchor_mod.is_existence(a):
            tracked.append(slot)
            if not isinstance(value, list) or not value or \
                    not all(isinstance(e, dict) for e in value):
                raise CompileError('existence anchor pattern must be a '
                                   'list of maps')
            for elem_pattern in value:
                # existence failures always report the anchored key's
                # path (anchor.py:250), so element subtrees need no sites
                elem_sub = _compile_elem_map(cps, elem_pattern,
                                             child_path + ('*',), tracked,
                                             None)
                children.append(StatusExpr(
                    'exists', slot=slot, sub=elem_sub,
                    fail_site=_new_site(sites, child_path)))

    for key in _plain_order(plains):
        a, value = plains[key]
        bare = a.key if a else key
        if _key_has_wildcard(bare):
            if not _wild_key_allowed(path) or a is not None \
                    or len(pattern) != 1:
                raise CompileError(
                    f'wildcard pattern key not vectorized: {key}')
            if not isinstance(value, (str, int, float, bool)) \
                    and value is not None:
                raise CompileError(
                    f'wildcard pattern key with non-scalar value: {key}')
            if value != '*':
                value = str(value)
            child_path = path + (WILD_KEY_MARK + bare,)
        else:
            child_path = path + (bare,)
        if a is not None and anchor_mod.is_global(a):
            slot = Slot(child_path)
            _require_depth(slot)
            cps.slot_id(slot)
            sub = _compile_element(cps, value, child_path, tracked, sites)
            children.append(StatusExpr('global', slot=slot, sub=sub))
            continue
        if a is not None and anchor_mod.is_add_if_not_present(a):
            continue  # mutation-only anchor: no-op during validation
        # default key (anchor.py handle_element default branch): the
        # "*" pattern passes on any non-null value, fails when missing —
        # reported at the parent map's path (anchor.py:214)
        if value == '*':
            slot = Slot(child_path)
            _require_depth(slot)
            cps.slot_id(slot)
            children.append(StatusExpr(
                'leaf', expr=BoolExpr.of(Leaf(slot, 'star')),
                fail_site=_new_site(sites, child_path, parent=True)))
            continue
        children.append(_compile_element(cps, value, child_path, tracked,
                                         sites))

    return StatusExpr.seq(children)


def _plain_order(plains: dict) -> List[str]:
    """validate_pattern._sorted_nested_anchor_keys ordering."""
    front, back = [], []
    for k in sorted(plains):
        a, v = plains[k]
        if anchor_mod.is_global(a) or has_nested_anchors(v):
            front.insert(0, k)
        else:
            back.append(k)
    return front + back


def _require_depth(slot: Slot) -> None:
    if slot.depth > 2:
        raise CompileError('more than two element dimensions not vectorized')


def _compile_element(cps: CompiledPolicySet, pattern: Any,
                     path: Tuple[str, ...], tracked: List[Slot],
                     sites: Optional[List[str]] = None) -> StatusExpr:
    """Compile _validate_element dispatch for the value at ``path``.

    Mirrors validate_pattern._validate_element: maps need a map resource,
    lists need a list resource, scalars compare leaf-wise (arrays of
    scalars must all match — handled in eval via the array-addendum).
    """
    slot = Slot(path)
    _require_depth(slot)
    cps.slot_id(slot)
    if isinstance(pattern, dict):
        is_map = StatusExpr('leaf', expr=BoolExpr.of(Leaf(slot, 'is_map')),
                            fail_site=_new_site(sites, path))
        sub = _compile_map(cps, pattern, path, tracked, sites)
        return StatusExpr.seq([is_map, sub])
    if isinstance(pattern, list):
        if not pattern:
            raise CompileError('empty pattern array')
        first = pattern[0]
        is_arr = StatusExpr('leaf', expr=BoolExpr.of(Leaf(slot, 'is_array')),
                            fail_site=_new_site(sites, path))
        if isinstance(first, dict):
            # validateArrayOfMaps uses only the first pattern element
            # (reference: pkg/engine/validate/validate.go:168-173)
            elem_sub = _compile_elem_map(cps, first, path + ('*',), tracked,
                                         sites)
            forall = StatusExpr('forall', slot=slot, sub=elem_sub,
                                fail_site=_new_site(sites, path))
            return StatusExpr.seq([is_arr, forall])
        if isinstance(first, (str, int, float, bool)) or first is None:
            # scalar array pattern: every element must match the scalar
            # (validate.go:104 routes the array through the scalar leaf,
            # validate_pattern.py:61-66 checks each element); failures
            # report the ARRAY's path, no element index
            check = _compile_leaf(cps, path + ('*',), first)
            return StatusExpr.seq(
                [is_arr, StatusExpr('scalars', slot=slot, expr=check,
                                    fail_site=_new_site(sites, path))])
        raise CompileError('typed array patterns not vectorized')
    if isinstance(pattern, (str, int, float, bool)) or pattern is None:
        return StatusExpr('leaf', expr=_compile_leaf(cps, path, pattern),
                          fail_site=_new_site(sites, path))
    raise CompileError(f'unsupported pattern type {type(pattern).__name__}')


def _compile_elem_map(cps: CompiledPolicySet, elem_pattern: dict,
                      elem_path: Tuple[str, ...], tracked: List[Slot],
                      sites: Optional[List[str]] = None) -> StatusExpr:
    """Compile the per-element pattern of an array-of-maps walk.

    validateArrayOfMaps calls validateResourceElement per element, so a
    non-map element is a plain FAIL (is_map guard at element scope).
    """
    if not isinstance(elem_pattern, dict):
        raise CompileError('element pattern must be a map')
    slot = Slot(elem_path)
    _require_depth(slot)
    cps.slot_id(slot)
    is_map = StatusExpr('leaf', expr=BoolExpr.of(Leaf(slot, 'is_map')),
                        fail_site=_new_site(sites, elem_path))
    sub = _compile_map(cps, elem_pattern, elem_path, tracked, sites)
    return StatusExpr.seq([is_map, sub])


def _key_has_wildcard(key: str) -> bool:
    return '*' in key or '?' in key


# ---------------------------------------------------------------------------
# Leaf compilation

def _compile_leaf(cps: CompiledPolicySet, path: Tuple[str, ...],
                  pattern: Any) -> BoolExpr:
    slot = Slot(path)
    _require_depth(slot)
    cps.slot_id(slot)

    def L(op, operand=None):
        return BoolExpr.of(Leaf(slot, op, operand))

    if isinstance(pattern, bool):
        return L('eq_bool', pattern)
    if pattern is None:
        return L('eq_null')
    if isinstance(pattern, int):
        if abs(pattern) * 1000 > (1 << 63) - 1:
            raise CompileError('integer pattern exceeds the milli lane')
        return L('eq_int', pattern)
    if isinstance(pattern, float):
        milli = Fraction(str(pattern)) * 1000
        if milli.denominator != 1:
            raise CompileError('sub-milli float pattern not exact on device')
        return L('eq_float', pattern)
    if isinstance(pattern, str):
        return _compile_string_pattern(slot, pattern)
    raise CompileError(f'unsupported leaf type {type(pattern).__name__}')


def _compile_string_pattern(slot: Slot, pattern: str) -> BoolExpr:
    """Compile the string operator grammar
    (reference: pkg/engine/pattern/pattern.go:152 validateStringPatterns)."""
    # the host short-circuits when the value equals the whole pattern
    # string literally (pattern.py:133) — e.g. value '>5' vs pattern '>5'
    ors = []
    if len(pattern.encode('utf-8')) <= STR_LEN:
        ors.append(BoolExpr.of(Leaf(slot, 'eq_str', pattern)))
    for condition in pattern.split('|'):
        ands = []
        for term in condition.strip(' ').split('&'):
            ands.append(_compile_string_term(slot, term.strip(' ')))
        ors.append(BoolExpr.all(ands))
    return BoolExpr.any(ors)


def _compile_string_term(slot: Slot, term: str) -> BoolExpr:
    op = leaf_pattern.get_operator_from_string_pattern(term)
    if op == leaf_pattern.OP_IN_RANGE:
        m = leaf_pattern.IN_RANGE_RE.match(term)
        return BoolExpr.all([
            _compile_string_term(slot, f'>= {m.group(1)}'),
            _compile_string_term(slot, f'<= {m.group(2)}')])
    if op == leaf_pattern.OP_NOT_IN_RANGE:
        m = leaf_pattern.NOT_IN_RANGE_RE.match(term)
        return BoolExpr.any([
            _compile_string_term(slot, f'< {m.group(1)}'),
            _compile_string_term(slot, f'> {m.group(2)}')])
    operand = term[len(op):].strip(' ') if op else term
    cmp = _CMP_OF_OP[op] if op else CMP_EQ
    if not op:
        operand = term

    def L(lop, loperand=None):
        return BoolExpr.of(Leaf(slot, lop, loperand))

    alternatives: List[BoolExpr] = []
    # 1. duration comparison (only if operand parses as Go duration)
    try:
        nanos = parse_duration(operand)
        alternatives.append(L('cmp_dur', (cmp, nanos)))
    except (ValueError, TypeError):
        pass
    # 2. quantity comparison (only if operand parses as k8s quantity)
    try:
        q = Quantity.parse(operand)
        milli = q.value * 1000
        if milli.denominator == 1:
            alternatives.append(L('cmp_qty', (cmp, int(milli))))
        # sub-milli operands skip the quantity alternative; strings that
        # parse as quantities still hit the wildcard/string alternative
    except ValueError:
        pass
    # 3. wildcard string comparison (only for == / !=)
    if cmp in (CMP_EQ, CMP_NE):
        str_check = _compile_wildcard_eq(slot, operand)
        if cmp == CMP_NE:
            str_check = BoolExpr.all([
                BoolExpr.of(Leaf(slot, 'convertible')),
                BoolExpr.negate(str_check)])
        alternatives.append(str_check)
    if not alternatives:
        raise CompileError(f'no vectorizable interpretation for {term!r}')
    return BoolExpr.any(alternatives)


def _compile_wildcard_eq(slot: Slot, operand: str) -> BoolExpr:
    """Classify a wildcard pattern into a vectorizable string class
    (shared classification: ir.classify_wildcard)."""
    from .ir import classify_wildcard

    def L(op, loperand=None):
        return BoolExpr.of(Leaf(slot, op, loperand))

    if len(operand.encode()) > STR_LEN:
        raise CompileError('operand longer than encoded string window')
    kind, parts = classify_wildcard(operand)
    if kind == 'eq':
        return L('eq_str', operand)
    if kind == 'any':
        return L('any_str')
    if kind == 'nonempty':
        return L('nonempty')
    if kind == 'prefix':
        return L('prefix', parts[0])
    if kind == 'suffix':
        return L('suffix', parts[0])
    if kind == 'prefix_suffix':
        # "a*b": prefix a AND suffix b AND len >= len(a)+len(b)
        return BoolExpr.all([
            L('prefix', parts[0]), L('suffix', parts[1]),
            L('min_len',
              len(parts[0].encode()) + len(parts[1].encode()))])
    # general wildcard: DP over the byte window (exact when the value fits
    # the window; else → unknown → host)
    return L('wildcard', operand)


# ---------------------------------------------------------------------------
# Condition compilation (deny / preconditions)

# the deprecated In/NotIn have enough extra quirks (strict string slices,
# _set_in json semantics) that they stay host-side
_SUPPORTED_COND_OPS = {
    'equal', 'equals', 'notequal', 'notequals',
    'anyin', 'allin', 'anynotin', 'allnotin',
    'greaterthanorequals', 'greaterthan', 'lessthanorequals', 'lessthan',
}


def _compile_conditions(cps: CompiledPolicySet, conditions: Any,
                        elem_list_expr: Optional[str] = None,
                        err_gathers: Optional[List] = None) -> BoolExpr:
    """Compile any/all condition blocks to a BoolExpr
    (semantics: kyverno_tpu/engine/operators.py evaluate_conditions).
    With ``elem_list_expr`` set, conditions compile at foreach-element
    scope (either side may be an element variable)."""
    def one(c):
        if elem_list_expr is not None:
            if not isinstance(c, dict):
                raise CompileError('bad condition')
            return _compile_condition_elem(cps, elem_list_expr, c,
                                           err_gathers)
        return _compile_condition(cps, c)

    if conditions is None:
        return BoolExpr.of(Leaf(Slot(()), 'true'))
    if isinstance(conditions, dict):
        return _compile_any_all(cps, conditions, one)
    if isinstance(conditions, list):
        if conditions and all(isinstance(c, dict) and
                              ('any' in c or 'all' in c)
                              for c in conditions):
            return BoolExpr.all([_compile_any_all(cps, c, one)
                                 for c in conditions])
        if not conditions:
            raise CompileError('empty legacy condition list')
        return BoolExpr.all([one(c) for c in conditions])
    raise CompileError('bad conditions shape')


def _compile_any_all(cps: CompiledPolicySet, block: dict, one) -> BoolExpr:
    parts: List[BoolExpr] = []
    any_conditions = block.get('any')
    all_conditions = block.get('all')
    if any_conditions is not None:
        if not isinstance(any_conditions, list):
            raise CompileError('bad any block')
        if not any_conditions:
            # any([]) is False in the host evaluator
            parts.append(BoolExpr.negate(
                BoolExpr.of(Leaf(Slot(()), 'true'))))
        else:
            parts.append(BoolExpr.any([one(c) for c in any_conditions]))
    if all_conditions:
        if not isinstance(all_conditions, list):
            raise CompileError('bad all block')
        parts.append(BoolExpr.all([one(c) for c in all_conditions]))
    if not parts:
        return BoolExpr.of(Leaf(Slot(()), 'true'))
    return BoolExpr.all(parts)


def _compile_condition(cps: CompiledPolicySet, cond: Any) -> BoolExpr:
    if not isinstance(cond, dict):
        raise CompileError('bad condition')
    op = str(cond.get('operator', '')).lower()
    if op not in _SUPPORTED_COND_OPS:
        raise CompileError(f'operator {op!r} not vectorized')
    key = cond.get('key')
    value = cond.get('value')
    _check_constant(value)
    gather, _ = _compile_condition_key(key)
    cps.gather_id(gather)
    return BoolExpr.of_cond(CondCheck(
        gather=gather, op=op, values=_normalize_values(value),
        list_value=isinstance(value, list)))


def _check_constant(value: Any, top: bool = True) -> None:
    """Condition values must be flat, variable-free constants."""
    if isinstance(value, str) and (is_variable(value) or is_reference(value)):
        raise CompileError(f'variable in condition value: {value!r}')
    if isinstance(value, list):
        if not top:
            raise CompileError('nested list condition value not vectorized')
        for v in value:
            _check_constant(v, top=False)
    if isinstance(value, dict):
        raise CompileError('map-typed condition value not vectorized')


def _normalize_values(value: Any) -> Tuple[Any, ...]:
    if isinstance(value, list):
        return tuple(value)
    return (value,)


# JMESPath custom functions whose results vary between evaluations —
# encode-time projection would diverge from a host re-run
_STATEFUL_FN_RE = re.compile(
    r'\b(random|time_now|time_now_utc)\s*\(')


def _compile_condition_key(key: Any) -> Tuple[GatherSlot, bool]:
    """Compile a condition key — a single ``{{ jmespath }}`` — into a
    gather projection.

    The expression is evaluated verbatim at encode time by the in-repo
    JMESPath interpreter against the same ``{'request': {'object': doc}}``
    context the host engine builds for background scans
    (engine/api.py:172-178), so gather semantics are host-exact for ANY
    expression the parser accepts; only stateful functions are barred.
    """
    if not isinstance(key, str):
        raise CompileError('non-string condition key not vectorized')
    m = _SINGLE_VAR_RE.match(key.strip())
    if not m:
        raise CompileError(f'condition key is not a single variable: {key!r}')
    expr = m.group(1).strip()
    if '{{' in expr:
        raise CompileError('nested variables not vectorized')
    if _STATEFUL_FN_RE.search(expr):
        raise CompileError('stateful function in condition key')
    from ..engine.jmespath import compile as jp_compile
    try:
        jp_compile(expr)
    except Exception as e:  # noqa: BLE001 - parser errors → host
        raise CompileError(f'unparseable condition key: {e}')
    return GatherSlot(expr), True


# ---------------------------------------------------------------------------
# foreach compilation (deny-conditions form)

def _compile_foreach(cps: CompiledPolicySet, entries: Any) -> StatusExpr:
    """Compile ``validate.foreach`` into per-element condition programs
    (engine.py:611 _validate_foreach, reference: pkg/engine/validation.go:319).

    Supported entry shape: ``list`` + ``deny`` (+ element-scoped
    ``preconditions``); context entries, nested foreach, pattern forms,
    and explicit elementScope fall back to the host."""
    from .ir import ElemGather, ForEachEntryIR
    if not isinstance(entries, list) or not entries:
        raise CompileError('foreach must be a non-empty list')
    ir_entries: List[ForEachEntryIR] = []
    for entry in entries:
        if not isinstance(entry, dict):
            raise CompileError('bad foreach entry')
        if entry.get('context'):
            raise CompileError('foreach context entries not vectorized')
        for k in ('foreach', 'pattern', 'anyPattern', 'podSecurity'):
            if entry.get(k) is not None:
                raise CompileError(f'foreach {k} not vectorized')
        if entry.get('elementScope'):
            raise CompileError('explicit elementScope not vectorized')
        if entry.get('deny') is None:
            raise CompileError('foreach entry without deny')
        list_expr = entry.get('list') or ''
        if not isinstance(list_expr, str) or not list_expr.strip():
            raise CompileError('foreach entry without list')
        list_expr = list_expr.strip()
        if _STATEFUL_FN_RE.search(list_expr):
            raise CompileError('stateful function in foreach list')
        from ..engine.jmespath import compile as jp_compile
        try:
            jp_compile(list_expr)
        except Exception as e:  # noqa: BLE001
            raise CompileError(f'unparseable foreach list: {e}')
        list_gather = GatherSlot(list_expr)
        cps.gather_id(list_gather)

        err_gathers: List[ElemGather] = []
        precond = None
        if entry.get('preconditions') is not None:
            precond = _compile_conditions(
                cps, entry['preconditions'],
                elem_list_expr=list_expr, err_gathers=err_gathers)
        deny = _compile_conditions(
            cps, (entry['deny'] or {}).get('conditions'),
            elem_list_expr=list_expr, err_gathers=err_gathers)
        ir_entries.append(ForEachEntryIR(
            list_gather=list_gather, precond=precond, deny=deny,
            err_gathers=tuple(err_gathers)))
    return StatusExpr('foreach', operand=tuple(ir_entries))


def _compile_condition_elem(cps: CompiledPolicySet, list_expr: str,
                            cond: dict, err_gathers: List) -> BoolExpr:
    """Compile one foreach condition: either side may be an element-scoped
    variable (exactly one side; both-constant folds at compile time)."""
    from ..engine import operators as host_ops
    from .ir import ElemGather
    op = str(cond.get('operator', '')).lower()
    key = cond.get('key')
    value = cond.get('value')
    key_var = isinstance(key, str) and \
        _SINGLE_VAR_RE.match(key.strip()) is not None
    value_var = isinstance(value, str) and \
        _SINGLE_VAR_RE.match(value.strip()) is not None

    def elem_gather(expr_str: str) -> 'ElemGather':
        m = _SINGLE_VAR_RE.match(expr_str.strip())
        expr = m.group(1).strip()
        if '{{' in expr:
            raise CompileError('nested variables not vectorized')
        if _STATEFUL_FN_RE.search(expr):
            raise CompileError('stateful function in condition')
        from ..engine.jmespath import compile as jp_compile
        try:
            jp_compile(expr)
        except Exception as e:  # noqa: BLE001
            raise CompileError(f'unparseable condition expr: {e}')
        eg = ElemGather(list_expr, expr)
        cps.elem_gather_id(eg)
        err_gathers.append(eg)
        return eg

    if key_var and not value_var:
        if op not in _SUPPORTED_COND_OPS:
            raise CompileError(f'operator {op!r} not vectorized')
        _check_constant(value)
        return BoolExpr.of_cond(CondCheck(
            gather=elem_gather(key), op=op, values=_normalize_values(value),
            list_value=isinstance(value, list)))
    if value_var and not key_var:
        if op not in ('equal', 'equals', 'notequal', 'notequals',
                      'anyin', 'allin', 'anynotin', 'allnotin'):
            raise CompileError(f'operator {op!r} not vectorized for '
                               'variable values')
        if isinstance(key, str) and (is_variable(key) or is_reference(key)):
            raise CompileError('partial-variable key not vectorized')
        if isinstance(key, (list, dict)):
            raise CompileError('non-scalar key with variable value not '
                               'vectorized')
        _check_constant(key)
        return BoolExpr.of_cond(CondCheck(
            gather=None, op=op, key_const=key,
            value_gather=elem_gather(value)))
    if not key_var and not value_var:
        # both sides constant: fold through the host operators
        if isinstance(key, str) and (is_variable(key) or is_reference(key)):
            raise CompileError('partial-variable key not vectorized')
        _check_constant(key)
        _check_constant(value)
        handler = host_ops._HANDLERS.get(op)
        if handler is None:
            raise CompileError(f'unknown operator {op!r}')
        result = handler(key, value)
        const = BoolExpr.of(Leaf(Slot(()), 'true'))
        return const if result else BoolExpr.negate(const)
    raise CompileError('variables on both condition sides not vectorized')
