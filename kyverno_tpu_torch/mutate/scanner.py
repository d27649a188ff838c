"""MutateScanner: batched device-side mutate for admission serving.

Compiles a mutate policy set once (``plan.compile_mutate_set``) and
evaluates admission batches as one device dispatch:

1. host match sieve per (resource, rule) — the same
   ``matches_resource_description`` call the engine loop makes, against
   the ORIGINAL document (sound because lowered rules are simple-match
   and edits cannot touch identity fields; see plan.py)
2. encode the edit-site lanes, run the device kernel (K3,
   ``csrc/k3_mutate.cu``) → per-(resource, rule) status + edit bitmask
   + fallback reason (the *patch emit* stage, read back like fail
   details)
3. decode on the host: set bits → (slot, value) edit list →
   ``apply_edit_list`` copy-on-write patch → ``generate_patches`` diff
   → the exact ``EngineResponse`` the handler's engine loop would have
   produced (PASS message via ``_success_message``, SKIP as
   ``no patches applied``)

FALLBACK rows re-run the faulting policy on the host engine with the
row's cumulative ``PolicyContext`` — and every *later* policy of that
row also rides the engine, because an engine rerun may reshape the
document outside the device's original-document model.  Responses are
byte-identical to the host loop by construction either way; fallbacks
are attributed per rule on the coverage ledger (``path="mutate"``).

``scan`` accepts the same signature the admission batcher dispatches
(``resources/contexts/admission/pctx_factory/operations/
old_resources``), so mutate tickets ride the same queue and coalescing
loop as validate tickets.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import numpy as np

from ..api.policy import Policy
from ..api.unstructured import Resource
from ..engine.api import (EngineResponse, PolicyContext, RuleResponse,
                          RuleStatus, RuleType)
from ..engine.engine import Engine
from ..engine.match import matches_resource_description
from ..engine.mutate.jsonpatch import generate_patches
from ..engine.mutate.mutate import _success_message
from ..compiler.mutate_compile import apply_edit_list
from ..observability import coverage, tracing
from ..observability.metrics import global_registry
from .encode import encode_mutate_batch, string_window
from .kernel import (MUT_FALLBACK, MUT_PASS, MUT_SKIP, RC_NON_DICT,
                     RC_REPLACE_MISSING, RC_UNDECIDABLE, MutateKernel)
from .plan import MutateSetProgram, compile_mutate_set

MUTATE_PATCH_EMIT = 'kyverno_tpu_mutate_patch_emit_seconds'
MUTATE_DECODE = 'kyverno_tpu_mutate_decode_seconds'
MUTATE_EDITS = 'kyverno_tpu_mutate_device_edits_total'

_RC_REASON = {
    RC_REPLACE_MISSING: coverage.REASON_REPLACE_PATH_MISSING,
    RC_NON_DICT: coverage.REASON_NON_DICT,
    RC_UNDECIDABLE: coverage.REASON_PATCH_UNDECIDABLE,
}


class MutateScanner:
    """One compiled mutate policy set, served batch-at-a-time.

    ``ok`` is False when the set does not lower (see plan.py) — callers
    keep the host engine loop and the placement records already name
    why, per rule.  ``device`` is the CUDA card unless the caller names
    another (``device.resolve_device``: raises without CUDA).
    """

    def __init__(self, policies: List[Policy],
                 engine: Optional[Engine] = None, device=None):
        from ..device import resolve_device
        self.device = resolve_device(device)
        self.policies = list(policies)
        self.engine = engine or Engine()
        self.program: MutateSetProgram = compile_mutate_set(self.policies)
        self.ok = self.program.device_ok and bool(self.program.programs)
        # serving coalesces on the scanner serial alone: the match sieve
        # below runs per row with that row's own admission tuple, so
        # mixed-user/mixed-verb mutate bursts share a dispatch
        from ..compiler.scan import next_scanner_serial
        self.serial = next_scanner_serial()
        self.supports_row_admissions = True
        if coverage.enabled():
            coverage.record_placements(self.program.placements)
        from ..ops.eval import policy_set_fingerprint
        self.fingerprint = policy_set_fingerprint(self.policies)
        self._kernel = MutateKernel(self.program, self.device) \
            if self.ok else None
        self._width = string_window(self.program) if self.ok else 0

    def warmup(self) -> float:
        """Run one admission-shape dispatch before traffic (builds the
        K3 kernel and the site tables on the device on first use)."""
        if not self.ok:
            return 0.0
        from ..compiler.scan import WARM_POD
        import copy
        t0 = time.monotonic()
        self.scan([copy.deepcopy(WARM_POD)])
        return time.monotonic() - t0

    # -- match ------------------------------------------------------------

    def _match_row(self, doc: dict, admission: Optional[tuple]):
        """Per-program match bits for one resource — the engine mutate
        loop's exact call (mutate.py:167), against the original doc."""
        info, roles, ns_labels = (admission or (None, [], {}))[:3]
        res = Resource(doc)
        out = np.zeros(len(self.program.programs), bool)
        for j, prog in enumerate(self.program.programs):
            policy = self.policies[prog.policy_index]
            out[j] = matches_resource_description(
                res, prog.rule, info, roles, ns_labels,
                policy.namespace) is None
        return out

    # -- scan -------------------------------------------------------------

    def scan(self, resources: List[dict],
             contexts: Optional[List[dict]] = None,
             admission: Optional[tuple] = None,
             pctx_factory=None,
             operations: Optional[List[str]] = None,
             old_resources: Optional[List[Optional[dict]]] = None,
             admissions: Optional[List[Optional[tuple]]] = None):
        """Per resource: ``(steps, patched)`` where ``steps`` is the
        ordered ``[(policy, EngineResponse), ...]`` chain the handler's
        host loop would produce (stopping after the first unsuccessful
        policy) and ``patched`` the cumulative document.  ``admissions``
        carries one admission tuple per row (heterogeneous batches);
        the match sieve runs each row against its own.  ``contexts``/
        ``operations``/``old_resources`` are accepted for batcher
        signature compatibility; mutation evaluates the new object."""
        if not self.ok:
            raise RuntimeError('mutate set is not device-lowered')
        n = len(resources)
        if n == 0:
            return []
        adm_rows = admissions if admissions is not None \
            else [admission] * n
        match = np.stack([self._match_row(doc, adm_rows[i])
                          for i, doc in enumerate(resources)])
        registry = global_registry()
        t0 = time.monotonic()
        with tracing.start_span('kyverno/mutate/patch_emit',
                                {'rows': n,
                                 'sites': self.program.n_sites}):
            # canonical capacity (compiler/shapes.py): the kernel masks
            # padding rows via the `valid` lane, so the device sees one
            # shape for every admission occupancy
            from ..compiler.shapes import canonical_capacity
            lanes = encode_mutate_batch(resources, self.program,
                                        padded_n=canonical_capacity(n),
                                        width=self._width)
            status, edits, reason = self._kernel(lanes)
        if registry is not None:
            registry.observe(MUTATE_PATCH_EMIT, time.monotonic() - t0)
        t1 = time.monotonic()
        with tracing.start_span('kyverno/mutate/decode', {'rows': n}):
            rows = [self._decode_row(resources[i], match[i], status[i],
                                     edits[i], reason[i], pctx_factory)
                    for i in range(n)]
        if registry is not None:
            registry.observe(MUTATE_DECODE, time.monotonic() - t1)
        return rows

    # -- decode -----------------------------------------------------------

    def _decode_row(self, doc: dict, match, status, edits, reason,
                    pctx_factory) -> Tuple[list, dict]:
        tally = coverage.scan_tally()
        if pctx_factory is not None:
            pctx = pctx_factory(doc)
        else:
            pctx = PolicyContext(None, new_resource=doc)
        steps: List[Tuple[Policy, EngineResponse]] = []
        host_rest = False
        for pi, policy in enumerate(self.policies):
            progs = self.program.per_policy[pi]
            if not any(r.has_mutate() for r in policy.rules):
                continue
            matched = [(prog.rule_index, prog) for prog in progs
                       if match[prog.rule_index]]
            pol_fb = any(int(status[j]) == MUT_FALLBACK
                         for j, _ in matched)
            ctx = pctx.copy()
            ctx.policy = policy
            if host_rest or pol_fb:
                er = self.engine.mutate(ctx)
                self._tally_host(tally, matched, reason,
                                 fallback=pol_fb and not host_rest)
                host_rest = True
            else:
                er = self._device_policy(policy, matched, status, edits,
                                         ctx, tally)
            steps.append((policy, er))
            if not er.is_successful():
                break
            # cumulative chain: the patched output re-enters the
            # context for the next policy (handlers.py Mutate loop)
            pctx = pctx.copy()
            pctx.new_resource = er.patched_resource or pctx.new_resource
            pctx.json_context.add_resource(pctx.new_resource)
        if tally is not None:
            tally.finish()
        return steps, pctx.new_resource

    def _tally_host(self, tally, matched, reason, fallback: bool) -> None:
        """Attribute one policy's engine rerun: the faulting rules keep
        their device-reported reason, siblings ride with the policy."""
        if tally is None:
            return
        for j, prog in matched:
            if fallback and int(reason[j]):
                tally.host_rule(prog.policy_name, prog.rule_name,
                                _RC_REASON.get(int(reason[j]),
                                               coverage.REASON_NON_DICT),
                                path='mutate')
            else:
                tally.host_rule(prog.policy_name, prog.rule_name,
                                coverage.REASON_POLICY_COUPLING,
                                path='mutate')

    def _device_policy(self, policy: Policy, matched, status, edits,
                       ctx: PolicyContext, tally) -> EngineResponse:
        """Materialize one policy's EngineResponse from device cells —
        field-for-field what the engine mutate loop builds for this
        vocabulary (statuses, messages, patches, patched doc)."""
        start = time.time()
        resp = EngineResponse(policy)
        cum = ctx.new_resource
        registry = global_registry()
        for j, prog in matched:
            if tally is not None:
                tally.total_rows += 1
            st = int(status[j])
            rule_start = time.time()
            if st == MUT_SKIP:
                rr = RuleResponse(prog.rule_name, RuleType.MUTATION,
                                  'no patches applied', RuleStatus.SKIP,
                                  patches=None)
            else:  # MUT_PASS
                mask = int(edits[j])
                changes = [(site.path, site.value)
                           for k, site in enumerate(prog.sites)
                           if mask & (1 << k)]
                patched = apply_edit_list(cum, changes)
                if patched is None:
                    # cannot happen for conflict-free site sets; keep
                    # the exactness contract via the engine anyway
                    raise RuntimeError('edit list failed to apply')
                patches = generate_patches(cum, patched)
                rr = RuleResponse(prog.rule_name, RuleType.MUTATION,
                                  _success_message(patched),
                                  RuleStatus.PASS, patches=patches)
                cum = patched
                if registry is not None:
                    registry.inc(MUTATE_EDITS, float(len(changes)))
            rr.processing_time = time.time() - rule_start
            resp.policy_response.rules.append(rr)
            resp.policy_response.rules_applied_count += 1
            if tally is not None:
                tally.device(prog)
        resp.patched_resource = cum
        self.engine._build_response(ctx, resp, start)
        return resp
