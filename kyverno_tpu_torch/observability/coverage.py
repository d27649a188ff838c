"""Device-coverage ledger: attributed host-fallback telemetry.

The engine's premise is that policy evaluation compiles to batched
device kernels, yet three independent mechanisms silently shed work to
the host interpreter: compile-time rejection (``CompileError`` →
``CompiledPolicySet.host_rules``), per-resource ``STATUS_HOST`` device
verdicts replayed by the scanner, and the mutate fast-path ``FALLBACK``
sentinel (``compiler/mutate_compile.py``).  This module makes every one
of those falls *attributed*, never silent:

* a **stable fallback-reason taxonomy** (:data:`REASONS`) — the only
  legal values of the ``reason`` label;
* per-(policy, rule) **placement records** (device | host | partial,
  with reason) exported as the ``kyverno_tpu_rule_placement_info``
  gauge and queryable as JSON (``GET /debug/coverage`` on the profile
  server, ``scripts/coverage_report.py``);
* runtime counters ``kyverno_tpu_host_fallback_total{path, reason}``
  and a per-scan ``kyverno_tpu_device_coverage_ratio`` gauge, plus the
  ``coverage`` block ``bench.py`` embeds in its JSON line.

Everything is a no-op until :func:`configure` runs (the established
``observability/device.py`` contract): an unconfigured process records
nothing, creates no series, and starts no threads, and scan output is
bit-identical either way (the ledger only observes).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, global_registry

RULE_PLACEMENT_INFO = 'kyverno_tpu_rule_placement_info'
HOST_FALLBACK_TOTAL = 'kyverno_tpu_host_fallback_total'
DEVICE_COVERAGE_RATIO = 'kyverno_tpu_device_coverage_ratio'

#: per-rule placement values
PLACEMENT_DEVICE = 'device'
PLACEMENT_HOST = 'host'
PLACEMENT_PARTIAL = 'partial'

#: counter ``path`` label values (mutate covers the bulk-apply fast
#: path; generate rules appear in placement records only; serving
#: covers admission-batching fallbacks decided before any scan runs)
PATHS = ('validate', 'mutate', 'pss', 'serving')

# -- fallback-reason taxonomy ------------------------------------------------
# Compile time (whole-rule placement):
REASON_UNSUPPORTED_OPERATOR = 'unsupported_operator'  # outside the device
#   vocabulary (operator / pattern shape / operand type / depth)
REASON_HOST_CLOSURE = 'host_closure'      # inherently host-bound rule
#   (verifyImages, manifests signatures — network / crypto closures)
REASON_API_CALL = 'api_call'              # context entry needs a live
#   API transport (imageRegistry)
REASON_POLICY_COUPLING = 'policy_coupling'  # rule compiled, but a
#   sibling host rule or applyRules=One couples the whole policy to host
# Runtime (per-resource cells):
REASON_STATUS_HOST = 'status_host'        # device verdict undecidable
REASON_UNSYNTHESIZABLE = 'unsynthesizable_message'  # verdict known but
#   the host's exact message cannot be synthesized from templates
REASON_CONTEXT_LOAD = 'context_load_failed'  # rule context load failed;
#   host materialization produces the exact error response
# Runtime (mutate fast-path escapes):
REASON_NON_DICT = 'non_dict_intermediate'  # overlay path hit a non-map
REASON_DUP_ELEMENT_NAMES = 'duplicate_element_names'  # merge-by-name
#   list carries duplicate / non-string names
REASON_REPLACE_PATH_MISSING = 'replace_path_missing'  # json6902 replace
#   on a path the document does not have
REASON_PRECONDITION_ESCAPE = 'precondition_escape'  # per-element
#   precondition left the compiled vocabulary at runtime
# Device-side mutate (kyverno_tpu/mutate/):
REASON_SITE_CONFLICT = 'edit_site_conflict'  # two lowered mutate rules
#   write overlapping slot paths — cumulative ordering leaves the
#   original-document device vocabulary (compile time)
REASON_PATCH_UNDECIDABLE = 'patch_undecidable'  # the encoded lanes
#   cannot decide whether the live value equals the patch constant
#   (numeric outside the exact milli window) — host applies instead
# Per-row admission lanes (compiler/admission.py):
REASON_ADMISSION_UNENCODABLE = 'admission_unencodable'  # a request's
#   admission tuple did not intern exactly into the per-row lanes
#   (non-string values, lane-width overflow) — that ROW's admission
#   match runs on the host matcher; path="serving" counts batcher
#   tickets keyed on the whole canonical tuple because their scanner
#   cannot consume per-row admissions
# Degradation under failure (serving/batcher.py quarantine,
# serving/breaker.py lifecycle, compiler/pipeline.py retries):
REASON_POISON_ROW = 'poison_row'  # quarantine bisection isolated this
#   row as the one poisoning its shared dispatch — the host loop
#   serves it while its healthy batch riders stayed on device
REASON_BREAKER_OPEN = 'breaker_open'  # the policy set's circuit
#   breaker is open (or half-open with the probe slot taken): the
#   request host-serves without touching the device path
REASON_STAGE_RETRY_EXHAUSTED = 'stage_retry_exhausted'  # a scan
#   pipeline stage kept failing after its whole KTPU_STAGE_RETRIES
#   budget; the chunk's error surfaced to the consumer

REASONS = frozenset({
    REASON_UNSUPPORTED_OPERATOR, REASON_HOST_CLOSURE, REASON_API_CALL,
    REASON_POLICY_COUPLING, REASON_STATUS_HOST, REASON_UNSYNTHESIZABLE,
    REASON_CONTEXT_LOAD, REASON_NON_DICT, REASON_DUP_ELEMENT_NAMES,
    REASON_REPLACE_PATH_MISSING, REASON_PRECONDITION_ESCAPE,
    REASON_SITE_CONFLICT, REASON_PATCH_UNDECIDABLE,
    REASON_ADMISSION_UNENCODABLE, REASON_POISON_ROW,
    REASON_BREAKER_OPEN, REASON_STAGE_RETRY_EXHAUSTED,
})


@dataclass(frozen=True)
class RulePlacement:
    """Compile-time placement of one (policy, rule) pair."""
    policy: str
    rule: str
    path: str = 'validate'        # validate | pss | mutate | generate
    placement: str = PLACEMENT_DEVICE
    reason: Optional[str] = None  # taxonomy slug for host placements
    detail: str = ''              # free-text compile diagnostic
    policy_index: int = -1


def compile_placements(policies: List[Any], cps: Any) -> List[RulePlacement]:
    """Final per-rule placement for a compiled policy set.

    Applies the scanner's policy-coupling override to the raw
    ``cps.placements``: a policy with ANY host rule — or
    ``applyRules=One`` (early-exit coupling between rules) — runs
    entirely on the host engine, so its device-compiled rules become
    ``host`` with reason ``policy_coupling``.  Shared by
    ``BatchScanner`` and ``scripts/coverage_report.py`` so the live
    ledger and the CLI can never disagree on placement.
    """
    host_idx = {p.policy_index for p in cps.placements
                if p.placement == PLACEMENT_HOST}
    host_idx |= {i for i, p in enumerate(policies)
                 if (getattr(p, 'apply_rules', None) or 'All') == 'One'}
    out: List[RulePlacement] = []
    for p in cps.placements:
        if p.placement == PLACEMENT_DEVICE and p.policy_index in host_idx:
            p = _dc_replace(
                p, placement=PLACEMENT_HOST,
                reason=REASON_POLICY_COUPLING,
                detail='rule compiled but a sibling host rule or '
                       'applyRules=One couples the policy to the host '
                       'engine')
        out.append(p)
    return out


class ScanTally:
    """Per-scan accumulator: plain dict increments on the assembly hot
    path (no locks, no metric emission per cell), absorbed into the
    global ledger in one batch when the scan finishes."""

    __slots__ = ('_ledger', 'total_rows', 'device_rows', 'host_rows',
                 'by_reason', 'rule_device', 'rule_host', '_finished')

    def __init__(self, ledger: 'CoverageLedger'):
        self._ledger = ledger
        self.total_rows = 0
        self.device_rows = 0
        self.host_rows = 0
        # (path, reason) -> rows
        self.by_reason: Dict[Tuple[str, str], int] = {}
        # (policy, rule, path) -> rows
        self.rule_device: Dict[Tuple[str, str, str], int] = {}
        # (policy, rule, path, reason) -> rows
        self.rule_host: Dict[Tuple[str, str, str, str], int] = {}
        self._finished = False

    @staticmethod
    def _path(prog) -> str:
        # device-mutate programs carry an explicit .path ('mutate');
        # validate RulePrograms are distinguished by their PSS payload
        explicit = getattr(prog, 'path', None)
        if explicit:
            return explicit
        return 'pss' if prog.pss is not None else 'validate'

    def device(self, prog) -> None:
        """One device-synthesized (resource, rule) cell."""
        self.device_rows += 1
        key = (prog.policy_name, prog.rule_name, self._path(prog))
        self.rule_device[key] = self.rule_device.get(key, 0) + 1

    def device_n(self, prog, n: int) -> None:
        """``n`` device-synthesized cells of one program at once — the
        columnar report assembly accounts whole status groups per
        vectorized column sweep instead of per cell."""
        self.device_rows += n
        key = (prog.policy_name, prog.rule_name, self._path(prog))
        self.rule_device[key] = self.rule_device.get(key, 0) + n

    def fallback(self, prog, reason: str) -> None:
        """One host-replayed cell of a device-compiled program."""
        self._host(prog.policy_name, prog.rule_name, self._path(prog),
                   reason)

    def fallback_n(self, prog, reason: str, n: int) -> None:
        """``n`` host-replayed cells of one program at once."""
        if reason not in REASONS:
            reason = 'unknown'
        self.host_rows += n
        path = self._path(prog)
        rkey = (path, reason)
        self.by_reason[rkey] = self.by_reason.get(rkey, 0) + n
        hkey = (prog.policy_name, prog.rule_name, path, reason)
        self.rule_host[hkey] = self.rule_host.get(hkey, 0) + n

    def host_rule(self, policy: str, rule: str, reason: str,
                  path: str = 'validate') -> None:
        """One rule response served by a whole-policy host run."""
        self.total_rows += 1
        self._host(policy, rule, path, reason)

    def _host(self, policy: str, rule: str, path: str, reason: str) -> None:
        if reason not in REASONS:
            reason = 'unknown'
        self.host_rows += 1
        rkey = (path, reason)
        self.by_reason[rkey] = self.by_reason.get(rkey, 0) + 1
        hkey = (policy, rule, path, reason)
        self.rule_host[hkey] = self.rule_host.get(hkey, 0) + 1

    def ratio(self) -> Optional[float]:
        if not self.total_rows:
            return None
        return self.device_rows / self.total_rows

    def finish(self) -> None:
        """Flush into the ledger (idempotent; sets the per-scan ratio
        gauge)."""
        if self._finished:
            return
        self._finished = True
        self._ledger.absorb(self)


class CoverageLedger:
    """Process-global coverage state: placement records + runtime
    fallback aggregation, rendered as metrics and as the
    ``/debug/coverage`` JSON document."""

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry
        self._lock = threading.Lock()
        # (policy, rule, path) -> mutable record dict
        self._rules: Dict[Tuple[str, str, str], dict] = {}
        self._fallbacks: Dict[Tuple[str, str], int] = {}
        self.device_rows = 0
        self.host_rows = 0
        self.total_rows = 0
        self.scans = 0
        self.last_ratio: Optional[float] = None

    # -- placement ---------------------------------------------------------

    def record_placements(self, placements: List[RulePlacement]) -> None:
        with self._lock:
            for p in placements:
                self._upsert(p.policy, p.rule, p.path, p.placement,
                             p.reason, p.detail)

    def _upsert(self, policy: str, rule: str, path: str, placement: str,
                reason: Optional[str], detail: str = '') -> dict:
        key = (policy, rule, path)
        rec = self._rules.get(key)
        if rec is None:
            rec = {'policy': policy, 'rule': rule, 'path': path,
                   'placement': placement, 'reason': reason,
                   'detail': detail, 'device_rows': 0, 'host_rows': 0,
                   'emitted': None}
            self._rules[key] = rec
        else:
            rec['placement'] = placement
            rec['reason'] = reason
            if detail:
                rec['detail'] = detail
        self._emit_placement(rec)
        return rec

    @staticmethod
    def _effective(rec: dict) -> str:
        """Live placement: a device rule with observed host rows is
        ``partial`` (compile-time ``placement`` stays untouched in the
        JSON report so the CLI's compile-only view always agrees)."""
        if rec['placement'] == PLACEMENT_DEVICE and rec['host_rows']:
            return PLACEMENT_PARTIAL
        return rec['placement']

    def _emit_placement(self, rec: dict) -> None:
        labels = {'policy': rec['policy'], 'rule': rec['rule'],
                  'path': rec['path'], 'placement': self._effective(rec),
                  'reason': rec['reason'] or ''}
        emitted = rec['emitted']
        if emitted == labels:
            return
        if emitted is not None:
            self._registry.clear_gauge(RULE_PLACEMENT_INFO, **emitted)
        self._registry.set_gauge(RULE_PLACEMENT_INFO, 1.0, **labels)
        rec['emitted'] = labels

    # -- runtime -----------------------------------------------------------

    def record_fallback(self, path: str, reason: str, policy: str = '',
                        rule: str = '', rows: int = 1) -> None:
        """One attributed host fallback outside a scan tally (mutate
        fast-path escapes, mesh summaries)."""
        if reason not in REASONS:
            reason = 'unknown'
        with self._lock:
            self._registry.inc(HOST_FALLBACK_TOTAL, float(rows),
                               path=path, reason=reason)
            key = (path, reason)
            self._fallbacks[key] = self._fallbacks.get(key, 0) + rows
            self.host_rows += rows
            self.total_rows += rows
            if policy or rule:
                rec = self._rules.get((policy, rule, path))
                if rec is None:
                    rec = self._upsert(policy, rule, path,
                                       PLACEMENT_DEVICE, None)
                rec['host_rows'] += rows
                self._emit_placement(rec)

    def record_scan(self, device_rows: int, host_rows: int,
                    path: str = 'validate',
                    reason: str = REASON_STATUS_HOST) -> None:
        """One whole-scan outcome where per-cell attribution is a single
        reason (the mesh summary path: host rows are STATUS_HOST counts
        from the verdict histogram)."""
        with self._lock:
            if host_rows:
                self._registry.inc(HOST_FALLBACK_TOTAL, float(host_rows),
                                   path=path, reason=reason)
                key = (path, reason)
                self._fallbacks[key] = self._fallbacks.get(key, 0) + \
                    host_rows
            self.device_rows += device_rows
            self.host_rows += host_rows
            self.total_rows += device_rows + host_rows
            self.scans += 1
            total = device_rows + host_rows
            if total:
                self.last_ratio = device_rows / total
                self._registry.set_gauge(DEVICE_COVERAGE_RATIO,
                                         self.last_ratio)

    def absorb(self, tally: ScanTally) -> None:
        """Merge one finished scan tally: batched counter increments,
        per-rule row counts, partial-placement upgrades, and the
        per-scan coverage-ratio gauge."""
        with self._lock:
            for (path, reason), rows in tally.by_reason.items():
                self._registry.inc(HOST_FALLBACK_TOTAL, float(rows),
                                   path=path, reason=reason)
                key = (path, reason)
                self._fallbacks[key] = self._fallbacks.get(key, 0) + rows
            for (policy, rule, path), rows in tally.rule_device.items():
                rec = self._rules.get((policy, rule, path))
                if rec is None:
                    rec = self._upsert(policy, rule, path,
                                       PLACEMENT_DEVICE, None)
                rec['device_rows'] += rows
            for (policy, rule, path, reason) in tally.rule_host:
                rows = tally.rule_host[(policy, rule, path, reason)]
                rec = self._rules.get((policy, rule, path))
                if rec is None:
                    rec = self._upsert(policy, rule, path,
                                       PLACEMENT_DEVICE, None)
                rec['host_rows'] += rows
                self._emit_placement(rec)
            self.device_rows += tally.device_rows
            self.host_rows += tally.host_rows
            self.total_rows += tally.total_rows
            self.scans += 1
            ratio = tally.ratio()
            if ratio is not None:
                self.last_ratio = ratio
                self._registry.set_gauge(DEVICE_COVERAGE_RATIO, ratio)

    # -- reads -------------------------------------------------------------

    def report(self) -> dict:
        """The ``/debug/coverage`` JSON document."""
        with self._lock:
            rules = []
            for key in sorted(self._rules):
                rec = self._rules[key]
                rules.append({
                    'policy': rec['policy'], 'rule': rec['rule'],
                    'path': rec['path'],
                    'placement': rec['placement'],
                    'effective': self._effective(rec),
                    'reason': rec['reason'],
                    'detail': rec['detail'],
                    'device_rows': rec['device_rows'],
                    'host_rows': rec['host_rows'],
                })
            fallbacks: Dict[str, Dict[str, int]] = {}
            for (path, reason), rows in sorted(self._fallbacks.items()):
                fallbacks.setdefault(path, {})[reason] = rows
            return {
                'rules': rules,
                'fallbacks': fallbacks,
                'totals': self._totals_locked(),
            }

    def _totals_locked(self) -> dict:
        total = self.total_rows
        return {
            'device_rows': self.device_rows,
            'host_rows': self.host_rows,
            'total_rows': total,
            'ratio': round(self.device_rows / total, 6) if total else None,
            'scans': self.scans,
            'last_scan_ratio': round(self.last_ratio, 6)
            if self.last_ratio is not None else None,
        }

    def totals(self) -> dict:
        """The ``coverage`` block bench.py embeds in its JSON line."""
        with self._lock:
            out = self._totals_locked()
            by_reason: Dict[str, Dict[str, int]] = {}
            for (path, reason), rows in sorted(self._fallbacks.items()):
                by_reason.setdefault(path, {})[reason] = rows
            out['by_reason'] = by_reason
            return out


# -- module-level no-op-until-configured facade ------------------------------

_ledger: Optional[CoverageLedger] = None


def configure(registry: Optional[MetricsRegistry] = None) -> CoverageLedger:
    """Enable the coverage ledger.  ``registry`` defaults to the
    process-global registry, else a fresh one.  Idempotent;
    :func:`disable` undoes it."""
    global _ledger
    reg = registry or global_registry() or MetricsRegistry()
    _ledger = CoverageLedger(reg)
    return _ledger


def disable() -> None:
    global _ledger
    _ledger = None


def enabled() -> bool:
    return _ledger is not None


def ledger() -> Optional[CoverageLedger]:
    return _ledger


def scan_tally() -> Optional[ScanTally]:
    """A fresh per-scan accumulator, or None when unconfigured (the
    scanner's zero-overhead gate: one attribute read per scan)."""
    led = _ledger
    return ScanTally(led) if led is not None else None


def record_placements(placements: List[RulePlacement]) -> None:
    led = _ledger
    if led is not None:
        led.record_placements(placements)


def record_fallback(path: str, reason: str, policy: str = '',
                    rule: str = '', rows: int = 1) -> None:
    led = _ledger
    if led is not None:
        led.record_fallback(path, reason, policy=policy, rule=rule,
                            rows=rows)


def record_scan(device_rows: int, host_rows: int, path: str = 'validate',
                reason: str = REASON_STATUS_HOST) -> None:
    led = _ledger
    if led is not None:
        led.record_scan(device_rows, host_rows, path=path, reason=reason)


def last_ratio() -> Optional[float]:
    """Device-coverage ratio of the most recently completed scan (what
    the ``device_eval`` span attribute carries), or None."""
    led = _ledger
    return led.last_ratio if led is not None else None


def bench_block() -> Optional[dict]:
    led = _ledger
    return led.totals() if led is not None else None
