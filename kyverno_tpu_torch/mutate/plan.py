"""Lowering: mutate rules → fixed device edit-site programs.

A mutate rule lowers when its whole patch is expressible as a fixed set
of **edit sites** — (slot path, static scalar value) pairs with an
optional add-if-absent anchor or json6902 ``replace`` existence guard —
over the same wildcard-free slot-path vocabulary the validate encoder
resolves at encode time (``compiler/encode.py``).  The device program
then decides, per (resource, site), whether the edit applies, and emits
a compact per-rule edit bitmask the host decodes back into patched JSON
(``scanner.py``).  Anything outside that vocabulary — foreach, contexts,
preconditions, variables, anchors needing live lookups, list patches,
null values (RFC-7386 deletes), non-scalar values — does NOT lower and
keeps the host engine, attributed on the coverage ledger.

Set-level coupling: the admission mutate chain is CUMULATIVE (policy
k+1 sees policy k's patched output — handlers.py Mutate loop), while
the device decides every rule against the ORIGINAL document.  The two
agree exactly when (a) every lowered rule's match block is simple
(kinds/namespaces/operations — unaffected by scalar edits that cannot
touch identity fields) and (b) no two rules' edit sites overlap in the
prefix-or-equal sense.  ``compile_mutate_set`` enforces both; a set
that violates them places every mutate rule on the host with reason
``edit_site_conflict`` / ``policy_coupling``.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

from ..api.policy import Policy, Rule
from ..observability import coverage
from ..compiler.mutate_compile import _compile_overlay, parse_json6902_sets

#: edit bitmask budget: one i32 lane per (resource, rule)
MAX_SITES = 32

#: resource-identity paths no lowered edit may write: match/exclude and
#: namespace gating read them, so a rule that mutates them could change
#: a later rule's match decision mid-chain
_IDENTITY_PATHS = (('kind',), ('apiVersion',), ('metadata', 'name'),
                   ('metadata', 'namespace'))


class LowerError(Exception):
    """A mutate rule cannot lower; carries its taxonomy reason."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason
        self.detail = detail


class EditSite(NamedTuple):
    path: Tuple[str, ...]   # slot path of the written leaf
    add_only: bool          # ``+(key)`` anchor: write only when absent
    value: Any              # static scalar (str | bool | int | float)
    replace: bool           # json6902 replace: whole path must exist


class RuleMutateProgram:
    """One lowered mutate rule: its edit sites + response metadata.

    ``path``/``pss`` satisfy the coverage ledger's program duck type
    (``ScanTally`` reads both), so mutate rows land on the ledger as
    ``path="mutate"`` next to validate/pss rows.
    """

    pss = None
    path = 'mutate'

    __slots__ = ('policy_name', 'rule_name', 'rule', 'kind', 'sites',
                 'policy_index', 'rule_index')

    def __init__(self, policy_name: str, rule_name: str, rule: Rule,
                 kind: str, sites: Tuple[EditSite, ...]):
        self.policy_name = policy_name
        self.rule_name = rule_name
        self.rule = rule
        self.kind = kind              # 'strategic' | 'json6902'
        self.sites = sites
        self.policy_index = -1        # filled by compile_mutate_set
        self.rule_index = -1


def _identity_site(path: Tuple[str, ...]) -> bool:
    return any(path[:len(idp)] == idp for idp in _IDENTITY_PATHS)


def _check_sites(sites: List[EditSite]) -> Tuple[EditSite, ...]:
    if len(sites) > MAX_SITES:
        raise LowerError(
            coverage.REASON_UNSUPPORTED_OPERATOR,
            f'{len(sites)} edit sites exceed the {MAX_SITES}-bit '
            f'per-rule edit bitmask')
    for site in sites:
        if site.value is None:
            raise LowerError(
                coverage.REASON_UNSUPPORTED_OPERATOR,
                'null patch values delete keys under RFC-7386 — '
                'outside the device edit vocabulary')
        if not isinstance(site.value, (str, bool, int, float)):
            raise LowerError(
                coverage.REASON_UNSUPPORTED_OPERATOR,
                f'non-scalar patch value at {"/".join(site.path)}')
        if _identity_site(site.path):
            raise LowerError(
                coverage.REASON_UNSUPPORTED_OPERATOR,
                f'edit writes the identity field {"/".join(site.path)} '
                f'— later rules\' match decisions could change '
                f'mid-chain')
    return tuple(sites)


def lower_mutate_rule(rule: Rule, policy_name: str) -> RuleMutateProgram:
    """Lower one mutate rule or raise :class:`LowerError` with the
    taxonomy reason the placement record carries."""
    raw = rule.raw
    if raw.get('context'):
        raise LowerError(coverage.REASON_API_CALL,
                         'rule context entries need live loads')
    if raw.get('preconditions') is not None:
        raise LowerError(coverage.REASON_UNSUPPORTED_OPERATOR,
                         'preconditions keep the engine path')
    mutation = raw.get('mutate') or {}
    if mutation.get('targets'):
        raise LowerError(coverage.REASON_HOST_CLOSURE,
                         'mutate-existing rides the UpdateRequest '
                         'pipeline')
    if mutation.get('foreach') is not None:
        raise LowerError(coverage.REASON_UNSUPPORTED_OPERATOR,
                         'foreach mutation keeps the host fast path')
    from ..compiler.scan import _rule_match_is_simple
    if not _rule_match_is_simple(raw):
        raise LowerError(
            coverage.REASON_UNSUPPORTED_OPERATOR,
            'non-simple match: the cumulative chain re-matches per '
            'policy, so only kind/namespace/operation matches are '
            'stable under device edits')
    overlay = mutation.get('patchStrategicMerge')
    json6902 = mutation.get('patchesJson6902')
    if overlay is not None and not json6902:
        sets = _compile_overlay(overlay)
        if sets is None:
            raise LowerError(
                coverage.REASON_UNSUPPORTED_OPERATOR,
                'overlay outside the static scalar vocabulary '
                '(anchors needing live lookups, lists, or variables)')
        sites = _check_sites([EditSite(path, add_only, value, False)
                              for path, add_only, value in sets])
        return RuleMutateProgram(policy_name, str(raw.get('name', '')),
                                 rule, 'strategic', sites)
    if json6902 and overlay is None:
        parsed = parse_json6902_sets(json6902)
        if parsed is None:
            raise LowerError(
                coverage.REASON_UNSUPPORTED_OPERATOR,
                'json6902 patch outside the static add/replace '
                'object-path vocabulary')
        sets, replace_paths = parsed
        rset = set(replace_paths)
        sites = _check_sites([EditSite(path, False, value, path in rset)
                              for path, _ao, value in sets])
        return RuleMutateProgram(policy_name, str(raw.get('name', '')),
                                 rule, 'json6902', sites)
    raise LowerError(coverage.REASON_UNSUPPORTED_OPERATOR,
                     'empty or mixed patch document')


def _paths_conflict(a: Tuple[str, ...], b: Tuple[str, ...]) -> bool:
    n = min(len(a), len(b))
    return a[:n] == b[:n]


class MutateSetProgram:
    """A whole mutate policy set lowered (or not) for device serving.

    ``device_ok`` is all-or-nothing: the cumulative admission chain
    means one unlowered or conflicting rule invalidates original-
    document device decisions for everything after it, so a set either
    serves entirely on device (with per-row host fallback) or entirely
    on the host engine.
    """

    def __init__(self, policies: List[Policy]):
        self.policies = list(policies)
        self.programs: List[RuleMutateProgram] = []
        self.per_policy: List[List[RuleMutateProgram]] = []
        self.placements: List[coverage.RulePlacement] = []
        self.device_ok = True
        failures: List[Tuple[int, Rule, LowerError]] = []
        lowered: List[Tuple[int, RuleMutateProgram]] = []
        for pi, policy in enumerate(self.policies):
            mutate_rules = [r for r in policy.rules if r.has_mutate()]
            if (policy.apply_rules or 'All') == 'One' and \
                    len(mutate_rules) > 1:
                self.device_ok = False
                for r in mutate_rules:
                    failures.append((pi, r, LowerError(
                        coverage.REASON_POLICY_COUPLING,
                        'applyRules=One early-exits between rules')))
                continue
            for r in mutate_rules:
                try:
                    prog = lower_mutate_rule(r, policy.name)
                except LowerError as e:
                    self.device_ok = False
                    failures.append((pi, r, e))
                    continue
                prog.policy_index = pi
                lowered.append((pi, prog))
        # cross-rule edit-site conflicts: prefix-or-equal overlap makes
        # original-document decisions order-dependent
        conflicted: set = set()
        for i in range(len(lowered)):
            for j in range(i + 1, len(lowered)):
                pa, a = lowered[i]
                pb, b = lowered[j]
                if a is b:
                    continue
                for sa in a.sites:
                    for sb in b.sites:
                        if _paths_conflict(sa.path, sb.path):
                            conflicted.add(id(a))
                            conflicted.add(id(b))
        if conflicted:
            self.device_ok = False
        # placements: device across the board, or host with the most
        # specific reason each rule earned
        for pi, policy in enumerate(self.policies):
            progs = [prog for ppi, prog in lowered if ppi == pi]
            self.per_policy.append(progs if self.device_ok else [])
            for prog in progs:
                if self.device_ok:
                    prog.rule_index = len(self.programs)
                    self.programs.append(prog)
                    self.placements.append(coverage.RulePlacement(
                        policy.name, prog.rule_name, 'mutate',
                        coverage.PLACEMENT_DEVICE, None, '', pi))
                elif id(prog) in conflicted:
                    self.placements.append(coverage.RulePlacement(
                        policy.name, prog.rule_name, 'mutate',
                        coverage.PLACEMENT_HOST,
                        coverage.REASON_SITE_CONFLICT,
                        'edit sites overlap another lowered rule — '
                        'cumulative ordering leaves the device '
                        'vocabulary', pi))
                else:
                    self.placements.append(coverage.RulePlacement(
                        policy.name, prog.rule_name, 'mutate',
                        coverage.PLACEMENT_HOST,
                        coverage.REASON_POLICY_COUPLING,
                        'rule lowered but a sibling mutate rule keeps '
                        'the set on the host engine', pi))
        for pi, r, e in failures:
            self.placements.append(coverage.RulePlacement(
                self.policies[pi].name, str(r.raw.get('name', '')),
                'mutate', coverage.PLACEMENT_HOST, e.reason, e.detail,
                pi))

    @property
    def n_sites(self) -> int:
        return sum(len(p.sites) for p in self.programs)


def compile_mutate_set(policies: List[Policy]) -> MutateSetProgram:
    return MutateSetProgram(policies)
