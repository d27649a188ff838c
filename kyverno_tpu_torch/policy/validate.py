"""Policy / PolicyException admission validation.

Self-protection of the control plane: Policy CRs are validated on
create/update before they enter the cache (reference:
pkg/policy/validate.go:128 Validate, served by
pkg/webhooks/policy/handlers.go:43).  Implements the structural rule
checks, the background-mode variable allow-list, JSON-patch path checks
and wildcard restrictions; cluster-discovery-dependent checks (namespaced
kinds, openapi mutation dry-runs) are host concerns wired in later.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from ..api.policy import Policy
from ..engine.variables import RE_VARIABLES

# variables permitted in background-mode policies (reference:
# pkg/policy/background.go:21 containsUserVariables and the allow-list in
# pkg/policy/allowed_vars_test.go)
_ALLOWED_BACKGROUND_PREFIX = re.compile(
    r'^(request\.object|request\.namespace|request\.operation|'
    r'images|element|elementIndex|@|serviceAccountName|'
    r'serviceAccountNamespace)')

_RULE_TYPES = ('validate', 'mutate', 'generate', 'verifyImages')

_VALID_OPERATORS = {
    'equal', 'equals', 'notequal', 'notequals', 'in', 'anyin', 'allin',
    'notin', 'anynotin', 'allnotin', 'greaterthanorequals', 'greaterthan',
    'lessthanorequals', 'lessthan', 'durationgreaterthanorequals',
    'durationgreaterthan', 'durationlessthanorequals', 'durationlessthan',
}


class PolicyValidationError(Exception):
    pass


def validate_policy(doc: dict, client=None) -> List[str]:
    """Validate a Policy/ClusterPolicy document; returns warnings, raises
    PolicyValidationError on rejection.

    ``client`` enables the generate permission pre-flight (SSAR probes,
    reference: pkg/policy/actions.go:50); without one the mock allow-all
    auth is used, matching the reference's offline mode."""
    warnings: List[str] = []
    if not isinstance(doc, dict):
        raise PolicyValidationError('policy must be an object')
    spec = doc.get('spec') or {}
    rules = spec.get('rules')
    if not isinstance(rules, list) or not rules:
        raise PolicyValidationError('spec.rules must be a non-empty list')

    action = str(spec.get('validationFailureAction', 'Audit'))
    if action.lower() not in ('enforce', 'audit'):
        raise PolicyValidationError(
            f'spec.validationFailureAction must be Enforce or Audit, '
            f'got {action!r}')
    if action in ('enforce', 'audit'):
        # reference: checkValidationFailureAction (validate.go:138)
        warnings.append(
            'Field \'validationFailureAction\' should have the value '
            '\'Audit\' or \'Enforce\'')

    background = spec.get('background', True)
    names = set()
    for i, rule in enumerate(rules):
        path = f'spec.rules[{i}]'
        if not isinstance(rule, dict):
            raise PolicyValidationError(f'{path} must be an object')
        name = rule.get('name', '')
        if not name:
            raise PolicyValidationError(f'{path}.name is required')
        if len(name) > 63:
            raise PolicyValidationError(
                f'{path}.name must be no more than 63 characters')
        if name in names:
            raise PolicyValidationError(
                f'duplicate rule name: {name!r}')
        names.add(name)

        present = [t for t in _RULE_TYPES if rule.get(t) is not None]
        if len(present) != 1:
            raise PolicyValidationError(
                f'{path}: exactly one of {_RULE_TYPES} is required, '
                f'found {present or "none"}')

        _validate_match_block(rule.get('match'), f'{path}.match',
                              required=True)
        _validate_match_block(rule.get('exclude'), f'{path}.exclude',
                              required=False)
        if rule.get('validate') is not None:
            _validate_validate_rule(rule['validate'], f'{path}.validate')
        if rule.get('mutate') is not None:
            _validate_mutate_rule(rule['mutate'], f'{path}.mutate')
        if rule.get('generate') is not None:
            from .generate_validate import validate_generate_rule
            policy_ns = (doc.get('metadata') or {}).get('namespace', '') \
                if doc.get('kind') == 'Policy' else ''
            err = validate_generate_rule(rule, i, client, policy_ns)
            if err is not None:
                raise PolicyValidationError(err)
        _validate_conditions_shape(rule.get('preconditions'),
                                   f'{path}.preconditions')
        if background:
            _check_background_vars(rule, path, i)
        _check_wildcard_kinds(rule, path, background=bool(background))
    return warnings


def _validate_match_block(block: Any, path: str, required: bool) -> None:
    if block is None:
        if required:
            raise PolicyValidationError(f'{path} is required')
        return
    if not isinstance(block, dict):
        raise PolicyValidationError(f'{path} must be an object')
    any_f, all_f = block.get('any'), block.get('all')
    if any_f is not None and all_f is not None:
        # reference: api/kyverno/v1/match_resources_types.go validation
        raise PolicyValidationError(
            f"{path}: 'any' and 'all' cannot be used together")
    has_direct = any(k in block for k in
                     ('resources', 'subjects', 'roles', 'clusterRoles'))
    if has_direct and (any_f is not None or all_f is not None):
        raise PolicyValidationError(
            f"{path}: cannot mix 'any'/'all' with direct match filters")
    if required and not has_direct and any_f is None and all_f is None:
        raise PolicyValidationError(f'{path} must specify resources')


def _validate_validate_rule(validate: Any, path: str) -> None:
    if not isinstance(validate, dict):
        raise PolicyValidationError(f'{path} must be an object')
    forms = [k for k in ('pattern', 'anyPattern', 'deny', 'podSecurity',
                         'foreach', 'manifests', 'cel')
             if validate.get(k) is not None]
    if len(forms) != 1:
        raise PolicyValidationError(
            f'{path}: exactly one validation form is required, '
            f'found {forms or "none"}')
    if validate.get('deny') is not None:
        _validate_conditions_shape(
            (validate['deny'] or {}).get('conditions'),
            f'{path}.deny.conditions')


def _validate_mutate_rule(mutate: Any, path: str) -> None:
    if not isinstance(mutate, dict):
        raise PolicyValidationError(f'{path} must be an object')
    patches = mutate.get('patchesJson6902')
    if patches:
        # reference: validateJSONPatchPathForForwardSlash (validate.go:194)
        import yaml
        try:
            ops = yaml.safe_load(patches) if isinstance(patches, str) \
                else patches
        except Exception as e:  # noqa: BLE001
            raise PolicyValidationError(f'{path}.patchesJson6902: {e}')
        for op in ops if isinstance(ops, list) else []:
            p = (op or {}).get('path', '')
            if p and not str(p).startswith('/'):
                raise PolicyValidationError(
                    f'path must begin with a forward slash: {path}')


def _validate_conditions_shape(conditions: Any, path: str) -> None:
    if conditions is None:
        return
    blocks: List[Tuple[str, Any]] = []
    if isinstance(conditions, dict):
        blocks = [(k, conditions.get(k)) for k in ('any', 'all')
                  if conditions.get(k) is not None]
    elif isinstance(conditions, list):
        for c in conditions:
            if isinstance(c, dict) and ('any' in c or 'all' in c):
                blocks.extend((k, c.get(k)) for k in ('any', 'all')
                              if c.get(k) is not None)
            else:
                blocks.append(('', [c]))
    for _, conds in blocks:
        if not isinstance(conds, list):
            raise PolicyValidationError(f'{path} blocks must be lists')
        for c in conds:
            if not isinstance(c, dict):
                raise PolicyValidationError(
                    f'{path} entries must be objects')
            op = str(c.get('operator', ''))
            if op and op.lower() not in _VALID_OPERATORS:
                raise PolicyValidationError(
                    f'{path}: invalid operator {op!r}')


def _iter_strings(node: Any):
    if isinstance(node, str):
        yield node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _iter_strings(k)
            yield from _iter_strings(v)
    elif isinstance(node, list):
        for v in node:
            yield from _iter_strings(v)


_FORBIDDEN_BACKGROUND_VARS = [
    re.compile(p) for p in (
        r'(?:^|[^.])(serviceAccountName)\b',
        r'(?:^|[^.])(serviceAccountNamespace)\b',
        r'(?:^|[^.])(request\.userInfo)',
        r'(?:^|[^.])(request\.roles)',
        r'(?:^|[^.])(request\.clusterRoles)',
    )]


def _userinfo_field(block: Any) -> str:
    f = block or {}
    for key in ('roles', 'clusterRoles', 'subjects'):
        if f.get(key):
            return key
    return ''


def _check_background_vars(rule: dict, path: str, idx: int = 0) -> None:
    """Background policies cannot filter on user info or reference
    admission-only variables (reference: pkg/policy/background.go:20
    containsUserVariables + :42 hasUserMatchExclude)."""
    for block_name in ('match', 'exclude'):
        block = rule.get(block_name) or {}
        p = _userinfo_field(block)
        if p:
            raise PolicyValidationError(
                f'invalid variable used at path: '
                f'spec/rules[{idx}]/{block_name}/{p}')
        for sub in ('any', 'all'):
            for i, f in enumerate(block.get(sub) or []):
                p = _userinfo_field(f)
                if p:
                    raise PolicyValidationError(
                        f'invalid variable used at path: '
                        f'spec/rules[{idx}]/{block_name}/{sub}[{i}]/{p}')
    # mutate-existing rules legitimately reference the admission request
    # (reference: background.go:28)
    if (rule.get('mutate') or {}).get('targets'):
        return
    for s in _iter_strings(rule):
        for m in RE_VARIABLES.finditer(s):
            var = m.group(2)  # the {{...}} form, as the reference reports
            for banned in _FORBIDDEN_BACKGROUND_VARS:
                if banned.search(var):
                    raise PolicyValidationError(
                        f'variable {var} is not allowed')


def _check_wildcard_kinds(rule: dict, path: str,
                          background: bool = True) -> None:
    """Wildcard kinds restrict the usable features
    (reference: pkg/policy/validate.go:1192 validateWildcard)."""
    kinds = []
    match = rule.get('match') or {}
    for f in [match] + (match.get('any') or []) + (match.get('all') or []):
        kinds.extend((f.get('resources') or {}).get('kinds') or [])
    if '*' in [str(k) for k in kinds]:
        if background:
            raise PolicyValidationError(
                'wildcard policy not allowed in background mode. Set '
                'spec.background=false to disable background mode for '
                'this policy rule')
        if len(kinds) > 1:
            raise PolicyValidationError(
                'wildard policy can not deal more than one kind')
        validate = rule.get('validate') or {}
        if rule.get('generate') is not None or \
                rule.get('verifyImages') is not None or \
                validate.get('foreach') is not None:
            raise PolicyValidationError(
                'wildcard policy does not support rule type')
    if any('*' in str(k) for k in kinds):
        validate = rule.get('validate') or {}
        if validate.get('pattern') is not None or \
                validate.get('anyPattern') is not None:
            raise PolicyValidationError(
                f'{path}: wildcard policy can only deal with the '
                f'metadata field of the resource if none of the '
                f"'request.object.spec' fields are used")


# ---------------------------------------------------------------------------
# admission endpoints (reference: pkg/webhooks/policy/handlers.go:43)

def validate_policy_admission(request: dict, client=None) -> dict:
    from ..webhooks import admission
    uid = request.get('uid', '')
    doc = admission.request_resource(request)
    try:
        warnings = validate_policy(doc, client)
    except PolicyValidationError as e:
        return admission.response(uid, False, str(e))
    return admission.response(uid, True, '', warnings)


def validate_exception_admission(request: dict) -> dict:
    from ..webhooks import admission
    uid = request.get('uid', '')
    doc = admission.request_resource(request)
    spec = (doc or {}).get('spec') or {}
    errs = []
    if not spec.get('match'):
        errs.append('spec.match is required')
    exceptions = spec.get('exceptions')
    if not isinstance(exceptions, list) or not exceptions:
        errs.append('spec.exceptions must be a non-empty list')
    else:
        for i, ex in enumerate(exceptions):
            if not (ex or {}).get('policyName'):
                errs.append(f'spec.exceptions[{i}].policyName is required')
    if errs:
        return admission.response(uid, False, '; '.join(errs))
    return admission.response(uid, True)
