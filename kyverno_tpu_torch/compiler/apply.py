"""Bulk mutate + generate over a resource dump (BASELINE config 5).

The reference applies mutate/generate policies one admission request or
one UpdateRequest at a time (reference: pkg/engine/mutation.go rule
loop, pkg/background/generate/generate.go).  A dump-scale apply
(millions of resources) is a batch problem: the per-rule *match*
decision is group/label-cacheable exactly like the validate scan
(compiler/scan.py match_matrix), and the per-hit mutation work is
embarrassingly parallel across resources.  ``BatchApplier`` does the
cached match sieve first, then fans the matched (resource × policy)
work over a process pool — each worker holds its own Engine, results
are bit-identical to the serial engine loop.

Generate rules don't mutate the trigger; they emit the same UpdateRequest
specs the webhook hands to the background controller
(reference: pkg/webhooks/resource/updaterequest.go:20), so a dump apply
feeds the identical UR pipeline.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..api.policy import Policy
from ..api.unstructured import Resource
from ..engine.api import PolicyContext
from ..engine.engine import Engine
from ..engine.match import matches_resource_description
from ..observability import coverage
from .scan import _group_key, _rule_match_is_label_simple, \
    _rule_match_is_simple, policy_namespace_gate


def mutate_placements(policies: List[Policy]) -> list:
    """Per-(policy, rule) placement of the bulk-apply path, mirroring
    BatchApplier's fast-path qualification: ``device`` = precompiled
    fast applier (mutate_compile), ``host`` = engine loop, with the
    attributed reason.  Generate rules are host-bound by design (they
    emit UpdateRequest specs through the background pipeline)."""
    import os as _os
    from .mutate_compile import compile_mutate_rule
    fast_enabled = _os.environ.get('KTPU_FAST_MUTATE', '1') == '1'
    out = []
    for i, p in enumerate(policies):
        mutate_rules = [r for r in p.rules if r.has_mutate()]
        compiled = {r.name: fast_enabled and
                    compile_mutate_rule(r.raw, p.name) is not None
                    for r in mutate_rules}
        policy_ok = fast_enabled and bool(mutate_rules) and \
            all(compiled.values()) and \
            (p.apply_rules or 'All') != 'One' and not p.is_namespaced
        for r in mutate_rules:
            if policy_ok:
                out.append(coverage.RulePlacement(
                    p.name, r.name, 'mutate',
                    coverage.PLACEMENT_DEVICE, None, '', i))
            elif compiled.get(r.name):
                out.append(coverage.RulePlacement(
                    p.name, r.name, 'mutate', coverage.PLACEMENT_HOST,
                    coverage.REASON_POLICY_COUPLING,
                    'rule compiled but the policy leaves the fast path '
                    '(sibling rule, applyRules=One, or namespaced)', i))
            else:
                out.append(coverage.RulePlacement(
                    p.name, r.name, 'mutate', coverage.PLACEMENT_HOST,
                    coverage.REASON_UNSUPPORTED_OPERATOR,
                    'mutation shape outside the fast-applier '
                    'vocabulary (mutate_compile.py)', i))
        for r in p.rules:
            if r.has_generate():
                out.append(coverage.RulePlacement(
                    p.name, r.name, 'generate', coverage.PLACEMENT_HOST,
                    coverage.REASON_HOST_CLOSURE,
                    'generate rules feed the UpdateRequest pipeline', i))
    return out


class ApplyResult:
    """Per-resource outcome of a bulk apply.

    ``rule_results`` is a compact [(policy, rule, status, message), ...]
    list — identical whether the apply ran in-process or on the pool
    (EngineResponse objects don't cross process boundaries cheaply)."""

    __slots__ = ('patched', 'rule_results', 'ur_specs')

    def __init__(self, patched: dict, rule_results: list, ur_specs: list):
        self.patched = patched        # resource after cumulative mutation
        self.rule_results = rule_results
        self.ur_specs = ur_specs      # UpdateRequest specs (generate)


def _ur_spec(policy: Policy, doc: dict) -> dict:
    r = Resource(doc)
    return {
        'requestType': 'generate',
        'policy': policy.name,
        'resource': {'kind': r.kind, 'apiVersion': r.api_version,
                     'namespace': r.namespace, 'name': r.name},
        'context': {'userInfo': {},
                    'admissionRequestInfo': {'operation': 'CREATE'}},
    }


class BatchApplier:
    """Compiles the match sieve once; applies mutate+generate to dumps.

    Mutation chains cumulatively per resource in policy order — the
    patched output of one policy is the next policy's input, matching
    the webhook's sequential mutate handler
    (reference: pkg/webhooks/resource/handlers.go Mutate loop).
    """

    def __init__(self, policies: List[Policy],
                 engine: Optional[Engine] = None,
                 processes: Optional[int] = None):
        self.engine = engine or Engine()
        self.mutate_policies = [p for p in policies
                                if any(r.has_mutate() for r in p.rules)]
        self.generate_policies = [p for p in policies
                                  if any(r.has_generate() for r in p.rules)]
        self.policies = self.mutate_policies + self.generate_policies
        # one match column per (policy, rule); a policy applies when any
        # of its rules match
        self._cols: List[Tuple[int, object]] = []  # (policy idx, Rule)
        for pi, p in enumerate(self.policies):
            for rule in p.rules:
                self._cols.append((pi, rule))
        self._simple = [_rule_match_is_simple(c[1].raw) for c in self._cols]
        self._label = [(not s) and _rule_match_is_label_simple(c[1].raw)
                       for s, c in zip(self._simple, self._cols)]
        self._match_cache: Dict[Tuple, tuple] = {}
        if processes is None:
            processes = 0 if len(self.policies) == 0 else \
                min(os.cpu_count() or 1,
                    int(os.environ.get('KTPU_APPLY_PROCS', '8')))
        self.processes = processes
        # precompiled fast appliers: a mutate policy qualifies when EVERY
        # mutate rule compiles (mutate_compile.py); per-resource shape
        # escapes fall back to the engine, so results stay bit-identical
        from .mutate_compile import compile_mutate_rule
        self._fast_mutate: Dict[int, list] = {}
        if os.environ.get('KTPU_FAST_MUTATE', '1') == '1':
            for pi, p in enumerate(self.mutate_policies):
                compiled = []
                ok = True
                for rule in p.rules:
                    if not rule.has_mutate():
                        continue
                    fast = compile_mutate_rule(rule.raw, p.name)
                    if fast is None:
                        ok = False
                        break
                    compiled.append((rule, fast))
                if ok and compiled and (p.apply_rules or 'All') != 'One' \
                        and not p.is_namespaced:
                    self._fast_mutate[pi] = compiled
        if coverage.enabled():
            # mutate/generate half of the coverage ledger (runtime
            # FALLBACK escapes are attributed inside the appliers; note
            # that process-pool applies count in the worker, so bulk
            # parallel runs under-report on the parent's ledger)
            coverage.record_placements(mutate_placements(self.policies))

    # -- match sieve --------------------------------------------------------

    def _match_col(self, col: int, res: Resource) -> bool:
        pi, rule = self._cols[col]
        if not policy_namespace_gate(self.policies[pi], res):
            return False
        return matches_resource_description(
            res, rule, None, [], {}, '') is None

    def matched_policies(self, doc: dict) -> List[int]:
        """Indices into self.policies whose rules match ``doc``; simple
        and label-simple columns are cached by group / (group, labels)."""
        res = Resource(doc)
        gkey = _group_key(doc)
        cached = self._match_cache.get(gkey)
        if cached is None:
            cached = tuple(self._match_col(c, res) if self._simple[c]
                           else False for c in range(len(self._cols)))
            self._match_cache[gkey] = cached
        cols = list(cached)
        if any(self._label):
            labels = (doc.get('metadata') or {}).get('labels') or {}
            lkey = (gkey, tuple(sorted(labels.items())))
            lcached = self._match_cache.get(lkey)
            if lcached is None:
                lcached = tuple(self._match_col(c, res)
                                for c in range(len(self._cols))
                                if self._label[c])
                self._match_cache[lkey] = lcached
            it = iter(lcached)
            for c in range(len(self._cols)):
                if self._label[c]:
                    cols[c] = next(it)
        for c in range(len(self._cols)):
            if not self._simple[c] and not self._label[c]:
                cols[c] = self._match_col(c, res)
        return sorted({self._cols[c][0] for c, hit in enumerate(cols)
                       if hit})

    # -- application --------------------------------------------------------

    def _apply_one(self, doc: dict) -> ApplyResult:
        hits = self.matched_policies(doc)
        patched = doc
        rule_results = []
        ur_specs = []
        n_mut = len(self.mutate_policies)
        for pi in hits:
            policy = self.policies[pi]
            if pi < n_mut:
                fast = self._fast_mutate.get(pi)
                if fast is not None:
                    out = self._apply_fast(policy, fast, patched)
                    if out is not None:
                        results, patched = out
                        rule_results.extend(results)
                        continue
                ctx = PolicyContext(policy, new_resource=patched)
                resp = self.engine.mutate(ctx)
                rule_results.extend(
                    (policy.name, rr.name, str(rr.status), rr.message)
                    for rr in resp.policy_response.rules)
                if resp.patched_resource is not None:
                    patched = resp.patched_resource
            else:
                ur_specs.append(_ur_spec(policy, patched))
        return ApplyResult(patched, rule_results, ur_specs)

    def _apply_fast(self, policy: Policy, compiled, doc: dict):
        """Run a policy's precompiled mutate appliers; None → the doc's
        shape needs the engine loop (bit-identical fallback)."""
        from .mutate_compile import FALLBACK
        results = []
        patched = doc
        res = Resource(doc)
        for rule, fast in compiled:
            if matches_resource_description(
                    res, rule, None, [], {}, '') is not None:
                continue
            out = fast.apply(patched)
            if out is FALLBACK:
                return None
            status, message, changed, new_doc = out
            results.append((policy.name, rule.name, str(status), message))
            if changed:
                patched = new_doc
                res = Resource(patched)
        return results, patched

    def apply(self, resources: List[dict],
              parallel: Optional[bool] = None) -> List[ApplyResult]:
        """Apply the pack to every resource; order-preserving.

        ``parallel=None`` auto-selects: dumps above ~2k resources fan
        out over the process pool, small batches stay in-process."""
        if parallel is None:
            parallel = self.processes > 1 and len(resources) >= 2048
        if not parallel:
            return [self._apply_one(doc) for doc in resources]
        return self._apply_parallel(resources)

    def _pool_executor(self):
        """Lazily created, reused process pool (worker startup rebuilds
        the engine per process — paying that per apply() call would
        dominate small dumps)."""
        if getattr(self, '_pool', None) is None:
            import weakref
            from concurrent.futures import ProcessPoolExecutor
            pool = ProcessPoolExecutor(
                max_workers=self.processes,
                initializer=_worker_init,
                initargs=([p.raw for p in self.policies],))
            self._pool = pool
            self._pool_finalizer = weakref.finalize(
                self, pool.shutdown, wait=False, cancel_futures=True)
        return self._pool

    def _apply_parallel(self, resources: List[dict]) -> List[ApplyResult]:
        chunk = max(256, len(resources) // (self.processes * 4))
        parts = [resources[i:i + chunk]
                 for i in range(0, len(resources), chunk)]
        try:
            outs = list(self._pool_executor().map(_worker_apply, parts))
        except Exception:  # noqa: BLE001 - pool loss degrades in-process
            # shut the workers down before dropping the reference — the
            # failure may be a bad input rather than pool death, and
            # orphaned workers would stack up across incidents
            fin = getattr(self, '_pool_finalizer', None)
            if fin is not None:
                fin()
            self._pool = None
            return [self._apply_one(doc) for doc in resources]
        results: List[ApplyResult] = []
        for part in outs:
            for patched, rule_results, urs in part:
                results.append(ApplyResult(patched, rule_results, urs))
        return results


# -- process-pool workers (module-level for pickling) -----------------------

_WORKER_APPLIER: Optional[BatchApplier] = None


def _worker_init(policy_docs: List[dict]) -> None:
    global _WORKER_APPLIER
    _WORKER_APPLIER = BatchApplier([Policy(d) for d in policy_docs],
                                   processes=0)


def _worker_apply(docs: List[dict]):
    return [(r.patched, r.rule_results, r.ur_specs)
            for r in map(_WORKER_APPLIER._apply_one, docs)]
