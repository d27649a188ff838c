"""Deterministic fault-injection harness for the serving hot paths.

The ``KTPU_FAULTS`` spec arms named injection sites threaded through
the layers that carry admission traffic — encode, h2d, device_eval,
d2h, the AOT executable load, the verdict-cache snapshot read, the
batcher dispatch, and the webhook handler.  Each armed clause raises a
configured error class at its site so the degradation machinery
(poison-batch quarantine, breaker lifecycle, pipeline retries, host
fallback) is exercised by REAL exceptions on the REAL code paths, not
by test doubles.

Spec grammar (clauses separated by ``;``, fields by ``,``)::

    site=<name>[,p=<prob>][,nth=<call>][,marker=<label>]
        [,error=<class>][,seed=<int>][,exhaust=1][,delay_ms=<ms>]

* ``p``      — fire with probability ``p`` per check, drawn
  deterministically from ``seed`` and the site's call counter (the
  same spec always fires on the same calls, so chaos runs replay).
* ``nth``    — fire on exactly the Nth check of that site (1-based),
  once.  Multiple ``nth`` clauses schedule a bounded, fully
  deterministic burst of device errors.
* ``marker`` — row-targeted poison: fires when any row passed to
  :func:`check_rows` carries ``metadata.labels.chaos == <label>``.
  This is how the chaos schedule plants poison rows that fail
  *deterministically per row* (so quarantine bisection can isolate
  them) instead of per call.
* ``error``  — error class name (:data:`ERROR_CLASSES`); default
  ``RuntimeError``.  Injected errors carry ``ktpu_injected = True``.
* ``delay_ms`` — fire as a *stall* instead of an error: the check
  sleeps ``delay_ms`` milliseconds and returns.  This is how a chaos
  schedule plants a deterministic straggler (a slow shard/stage is a
  different failure mode than a dead one — the ``mesh_shard`` site
  uses it to inflate exactly one shard's device-eval wall so the
  fleet skew analyzer can be exercised end to end).
* ``exhaust`` — mark the injected error retry-exhausted
  (``ktpu_retry_exhausted = True``), the shape a pipeline stage
  reports after burning its ``KTPU_STAGE_RETRIES`` budget.  The
  quarantine treats such failures as *wholesale* (infrastructure)
  evidence rather than row-attributed poison, so this is how a chaos
  schedule trips the circuit breaker on purpose.

Contract: with ``KTPU_FAULTS`` unset (or after :func:`disable`) every
check is a no-op behind a single ``is None`` test — scan output is
bit-identical to a build without this module, and nothing is imported,
counted, or drawn.  Every fired fault counts on
``kyverno_tpu_faults_injected_total{site}``.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, List, Optional, Sequence

FAULTS_INJECTED = 'kyverno_tpu_faults_injected_total'

#: injection sites, in hot-path order
SITE_ENCODE = 'encode'
SITE_H2D = 'h2d'
SITE_DEVICE_EVAL = 'device_eval'
SITE_D2H = 'd2h'
SITE_AOT_LOAD = 'aot_load'
SITE_VERDICT_SNAPSHOT = 'verdict_snapshot_read'
SITE_BATCHER_DISPATCH = 'batcher_dispatch'
SITE_WEBHOOK_HANDLER = 'webhook_handler'
#: checked once per shard inside the mesh per-shard readback-timing
#: loop (parallel/mesh.py) — the Nth check is shard (N-1) % mesh_size
#: of step (N-1) // mesh_size, so an nth+delay_ms clause stalls one
#: specific shard of one specific step, deterministically
SITE_MESH_SHARD = 'mesh_shard'

SITES = (SITE_ENCODE, SITE_H2D, SITE_DEVICE_EVAL, SITE_D2H,
         SITE_AOT_LOAD, SITE_VERDICT_SNAPSHOT, SITE_BATCHER_DISPATCH,
         SITE_WEBHOOK_HANDLER, SITE_MESH_SHARD)

#: the label key :func:`check_rows` inspects for ``marker`` clauses
MARKER_LABEL = 'chaos'

#: legal ``error=`` classes — the shapes real backends fail with
ERROR_CLASSES = {
    'RuntimeError': RuntimeError,
    'ValueError': ValueError,
    'OSError': OSError,
    'TimeoutError': TimeoutError,
    'MemoryError': MemoryError,
    'ConnectionError': ConnectionError,
}


class FaultSpecError(ValueError):
    """KTPU_FAULTS could not be parsed (bad site / field / value)."""


class _Clause:
    __slots__ = ('site', 'p', 'nth', 'marker', 'error', 'seed',
                 'exhaust', 'delay_ms', 'fired')

    def __init__(self, site: str, p: Optional[float], nth: Optional[int],
                 marker: Optional[str], error: type, seed: int,
                 exhaust: bool = False,
                 delay_ms: Optional[float] = None):
        self.site = site
        self.p = p
        self.nth = nth
        self.marker = marker
        self.error = error
        self.seed = seed
        self.exhaust = exhaust
        self.delay_ms = delay_ms
        self.fired = 0


def parse(spec: str) -> List[_Clause]:
    """Parse a ``KTPU_FAULTS`` spec string into clauses (see module
    docstring for the grammar); raises :class:`FaultSpecError` so a
    typo'd spec fails loudly at arm time, never silently no-ops."""
    clauses: List[_Clause] = []
    for part in spec.split(';'):
        part = part.strip()
        if not part:
            continue
        fields: Dict[str, str] = {}
        for kv in part.split(','):
            kv = kv.strip()
            if '=' not in kv:
                raise FaultSpecError(
                    f'fault clause field {kv!r} is not key=value '
                    f'(clause {part!r})')
            k, _, v = kv.partition('=')
            fields[k.strip()] = v.strip()
        site = fields.pop('site', None)
        if site not in SITES:
            raise FaultSpecError(
                f'unknown fault site {site!r} (clause {part!r}); '
                f'sites: {", ".join(SITES)}')
        try:
            p = float(fields.pop('p')) if 'p' in fields else None
            nth = int(fields.pop('nth')) if 'nth' in fields else None
            seed = int(fields.pop('seed', '0'))
            exhaust = bool(int(fields.pop('exhaust', '0')))
            delay_ms = float(fields.pop('delay_ms')) \
                if 'delay_ms' in fields else None
        except ValueError as e:
            raise FaultSpecError(
                f'bad numeric field in fault clause {part!r}: {e}')
        marker = fields.pop('marker', None)
        err_name = fields.pop('error', 'RuntimeError')
        error = ERROR_CLASSES.get(err_name)
        if error is None:
            raise FaultSpecError(
                f'unknown error class {err_name!r} (clause {part!r}); '
                f'classes: {", ".join(sorted(ERROR_CLASSES))}')
        if fields:
            raise FaultSpecError(
                f'unknown fault clause fields {sorted(fields)} '
                f'(clause {part!r})')
        if p is None and nth is None and marker is None:
            raise FaultSpecError(
                f'fault clause {part!r} needs one of p=, nth=, marker=')
        if p is not None and not (0.0 <= p <= 1.0):
            raise FaultSpecError(f'p={p} outside [0, 1] in {part!r}')
        if delay_ms is not None and delay_ms < 0:
            raise FaultSpecError(f'delay_ms={delay_ms} negative in '
                                 f'{part!r}')
        clauses.append(_Clause(site, p, nth, marker, error, seed,
                               exhaust, delay_ms))
    return clauses


class Injector:
    """Armed fault clauses plus per-site call counters.

    Thread-safe; the draw for a ``p`` clause is a pure function of
    (seed, site call index), so a given spec fires on the same calls
    in every run regardless of thread interleaving of OTHER sites.
    """

    def __init__(self, clauses: Sequence[_Clause]):
        self._clauses = list(clauses)
        self._calls: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _raise(self, clause: _Clause, detail: str):
        with self._lock:
            clause.fired += 1
            self._fired[clause.site] = self._fired.get(clause.site, 0) + 1
        registry = _registry()
        if registry is not None:
            registry.inc(FAULTS_INJECTED, site=clause.site)
        if clause.delay_ms is not None:
            # stall semantics: the injected failure is slowness, not an
            # error — the caller proceeds after the sleep
            import time
            time.sleep(clause.delay_ms / 1000.0)
            return
        err = clause.error(
            f'injected fault at {clause.site} ({detail})')
        err.ktpu_injected = True
        if clause.exhaust:
            err.ktpu_retry_exhausted = True
        raise err

    def check(self, site: str) -> None:
        """Raise if an armed call-indexed clause fires at ``site``."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
        for clause in self._clauses:
            if clause.site != site:
                continue
            if clause.nth is not None:
                if n == clause.nth:
                    self._raise(clause, f'nth={clause.nth}')
                continue
            if clause.p is not None:
                draw = random.Random((clause.seed << 32) ^ n).random()
                if draw < clause.p:
                    self._raise(clause, f'p={clause.p} call={n}')

    def check_rows(self, site: str, rows: Sequence[dict]) -> None:
        """:meth:`check`, then fire any ``marker`` clause whose label
        appears on a row — the row-deterministic poison path."""
        self.check(site)
        for clause in self._clauses:
            if clause.site != site or clause.marker is None:
                continue
            for row in rows:
                if not isinstance(row, dict):
                    continue
                labels = (row.get('metadata') or {}).get('labels') or {}
                if labels.get(MARKER_LABEL) == clause.marker:
                    self._raise(clause, f'marker={clause.marker}')

    def marked(self, rows: Sequence[dict]) -> int:
        """How many rows an armed marker clause would poison (test and
        bench bookkeeping, no side effects)."""
        markers = {c.marker for c in self._clauses if c.marker is not None}
        if not markers:
            return 0
        n = 0
        for row in rows:
            if isinstance(row, dict):
                labels = (row.get('metadata') or {}).get('labels') or {}
                if labels.get(MARKER_LABEL) in markers:
                    n += 1
        return n

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)


def _registry():
    from ..observability.metrics import global_registry
    return global_registry()


_injector: Optional[Injector] = None


def configure(spec: Optional[str]) -> Optional[Injector]:
    """Arm the process-wide injector from a spec string (None/'' →
    disarm).  Returns the installed injector so tests and the chaos
    bench can read its fire counts."""
    global _injector
    _injector = Injector(parse(spec)) if spec else None
    return _injector


def disable() -> None:
    global _injector
    _injector = None


def active() -> Optional[Injector]:
    return _injector


def check(site: str) -> None:
    """Hot-path hook: no-op behind one ``is None`` test when unarmed."""
    inj = _injector
    if inj is not None:
        inj.check(site)


def check_rows(site: str, rows: Sequence[dict]) -> None:
    """Hot-path hook for sites that see a batch of row documents."""
    inj = _injector
    if inj is not None:
        inj.check_rows(site, rows)


# arm from the environment once at import: the hot paths pay only the
# module-global None test afterwards (bit-identity when unset)
_env_spec = os.environ.get('KTPU_FAULTS', '')
if _env_spec.strip():
    configure(_env_spec)
