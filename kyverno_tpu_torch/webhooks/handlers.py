"""Resource admission handlers + middleware chain.

The serving pipeline mirrors the reference's handler composition
(reference: pkg/webhooks/handlers/*.go, pkg/webhooks/resource/handlers.go):
``with_admission`` decodes/encodes AdmissionReview JSON, ``with_filter``
drops config-excluded resources, ``with_protection`` denies edits to
kyverno-managed resources, ``with_dump`` keeps a debug ring buffer; the
terminal handlers run the engine over the policy cache.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import yaml

from ..api.unstructured import Resource
from ..engine.api import EngineResponse, RuleStatus
from ..engine.engine import Engine
from ..engine.match import matches_resource_description
from ..policycache import cache as pcache
from . import admission

Handler = Callable[[dict], dict]  # AdmissionRequest -> AdmissionResponse

SCANNER_HOT_SWAPS = 'kyverno_tpu_scanner_hot_swaps_total'
BREAKER_MIGRATIONS = 'kyverno_tpu_breaker_migrations_total'


# ---------------------------------------------------------------------------
# block / warning assembly (reference: pkg/webhooks/utils/block.go,
# warning.go; pkg/utils/engine/response.go:21)

def block_request(responses: List[EngineResponse],
                  failure_policy: str) -> bool:
    for er in responses:
        if er.is_failed() and _enforce(er):
            return True
        if er.is_error() and failure_policy == 'Fail':
            return True
    return False


def _enforce(er: EngineResponse) -> bool:
    action = er.get_validation_failure_action()
    return str(action).lower() == 'enforce'


import re as _re

_PLAIN_SCALAR_RE = _re.compile(r'^[A-Za-z0-9][A-Za-z0-9 _./()\[\]-]*$')
_NUMBERISH_RE = _re.compile(r'^[+-]?[0-9][0-9_.eE+-]*$')


def _yaml_scalar(s: str) -> str:
    """Block-style scalar: plain when unambiguous, single-quoted
    otherwise.  PyYAML's emitter costs ~0.5ms per rule message
    (analyze_scalar); deny messages at 1k policies made it the single
    largest admission-latency term, so the common map-of-strings shape
    is emitted directly."""
    if _PLAIN_SCALAR_RE.match(s) and not s.endswith(' ') and \
            not _NUMBERISH_RE.match(s) and \
            s.lower() not in ('null', 'true', 'false', 'yes', 'no', 'on',
                              'off'):
        return s
    return "'" + s.replace("'", "''") + "'"


_CTRL_CHAR_RE = _re.compile(r'[\x00-\x1f]')


def _dump_failures(failures: Dict[str, Dict[str, str]]) -> str:
    # multi-line / control-character scalars need real YAML escaping —
    # rare enough that the slow emitter handles the whole map then
    search = _CTRL_CHAR_RE.search
    for rules in failures.values():
        for k, v in rules.items():
            if search(k) or search(v):
                return yaml.safe_dump(failures, default_flow_style=False)
    lines = []
    for pol in sorted(failures):
        lines.append(f'{_yaml_scalar(pol)}:')
        rules = failures[pol]
        for rule in sorted(rules):
            lines.append(f'  {_yaml_scalar(rule)}: {_yaml_scalar(rules[rule])}')
    return '\n'.join(lines) + '\n'


def get_blocked_messages(responses: List[EngineResponse]) -> str:
    """reference: pkg/webhooks/utils/block.go:38 GetBlockedMessages"""
    if not responses:
        return ''
    failures: Dict[str, Dict[str, str]] = {}
    has_violations = False
    for er in responses:
        rule_to_reason: Dict[str, str] = {}
        for rule in er.policy_response.rules:
            if rule.status != RuleStatus.PASS:
                rule_to_reason[rule.name] = rule.message
                if rule.status == RuleStatus.FAIL:
                    has_violations = True
        if rule_to_reason:
            failures[er.policy_response.policy_name] = rule_to_reason
    if not failures:
        return ''
    pr = responses[0].policy_response
    resource_name = f'{pr.resource_kind}/{pr.resource_namespace}/' \
                    f'{pr.resource_name}'
    action = 'violation' if has_violations else 'error'
    if len(failures) > 1:
        action += 's'
    results = _dump_failures(failures)
    return f'\n\npolicy {resource_name} for resource {action}: ' \
           f'\n\n{results}'


def get_warning_messages(responses: List[EngineResponse]) -> List[str]:
    """reference: pkg/webhooks/utils/warning.go:9 GetWarningMessages"""
    warnings = []
    for er in responses:
        for rule in er.policy_response.rules:
            if rule.status not in (RuleStatus.PASS, RuleStatus.SKIP):
                warnings.append(
                    f'policy {er.policy_response.policy_name}.{rule.name}: '
                    f'{rule.message}')
    return warnings


# ---------------------------------------------------------------------------
# middleware (reference: pkg/webhooks/handlers/{filter,protect,dump}.go)

def with_filter(configuration, inner: Handler) -> Handler:
    """Skip resources excluded by the dynamic configuration
    (reference: pkg/webhooks/handlers/filter.go)."""
    def handler(request: dict) -> dict:
        if configuration is not None:
            kind = (request.get('kind') or {}).get('kind', '')
            ns = request.get('namespace', '')
            name = request.get('name', '') or \
                Resource(admission.request_resource(request)).name
            if configuration.to_filter(kind, ns, name):
                return admission.response(request.get('uid', ''), True)
        return inner(request)
    return handler


def with_protection(enabled: bool, inner: Handler) -> Handler:
    """Deny user modifications of kyverno-managed resources
    (reference: pkg/webhooks/handlers/protect.go)."""
    def handler(request: dict) -> dict:
        if enabled:
            new = admission.request_resource(request)
            old = admission.request_old_resource(request)
            for obj in (new, old):
                labels = (obj.get('metadata') or {}).get('labels') or {}
                if labels.get('app.kubernetes.io/managed-by') == 'kyverno':
                    username = (request.get('userInfo') or {}).get(
                        'username', '')
                    if not username.startswith(
                            'system:serviceaccount:kyverno:'):
                        return admission.response(
                            request.get('uid', ''), False,
                            'A kyverno managed resource can only be '
                            'modified by kyverno')
        return inner(request)
    return handler


class DumpBuffer:
    """Debug payload ring buffer (reference: handlers/dump.go)."""

    def __init__(self, size: int = 20):
        self._items = collections.deque(maxlen=size)
        self._lock = threading.Lock()

    def add(self, item: dict) -> None:
        with self._lock:
            self._items.append(item)

    def items(self) -> List[dict]:
        with self._lock:
            return list(self._items)


def with_dump(buffer: Optional[DumpBuffer], inner: Handler) -> Handler:
    def handler(request: dict) -> dict:
        resp = inner(request)
        if buffer is not None:
            buffer.add({'request': {
                'uid': request.get('uid'),
                'kind': request.get('kind'),
                'namespace': request.get('namespace'),
                'name': request.get('name'),
                'operation': request.get('operation'),
            }, 'response': {k: v for k, v in resp.items() if k != 'patch'},
                'timestamp': time.time()})
        return resp
    return handler


def with_admission(inner: Handler) -> Callable[[bytes], bytes]:
    """AdmissionReview JSON decode/encode wrapper
    (reference: pkg/webhooks/handlers/admission.go:18)."""
    def handler(body: bytes) -> bytes:
        review = json.loads(body)
        request = admission.parse_review(review)
        resp = inner(request)
        return json.dumps(
            admission.review_response(request, resp)).encode('utf-8')
    return handler


# ---------------------------------------------------------------------------
# resource handlers (reference: pkg/webhooks/resource/handlers.go)

class ResourceHandlers:
    """Terminal Validate / Mutate admission handlers.

    ``audit_sink`` receives (request, responses) for async audit-report
    construction; ``ur_sink`` receives UpdateRequest specs spawned for
    generate / mutate-existing policies (reference: handlers.go:146-155).
    ``device`` False keeps every request on the host engine loop;
    otherwise the scanners run on ``torch_device``, the CUDA card unless
    the caller names another (``device.resolve_device``, resolved once
    here: without CUDA the constructor raises instead of letting every
    scanner build fail behind the breaker).
    """

    # consecutive device-scan failures before the set's circuit
    # breaker opens and the host loop serves it for an exponential
    # backoff window (each failure already pays a scanner rebuild; a
    # persistently broken backend must not recompile the policy set on
    # every request).  A half-open probe after the backoff decides
    # between recovery and a re-trip (serving/breaker.py)
    DEVICE_FAILURE_LIMIT = 3
    # ceiling on simultaneous background scanner compiles (jax trace +
    # XLA compile are memory-heavy; a burst across many policy sets
    # serves the host loop rather than forking a compile per set)
    MAX_CONCURRENT_BUILDS = 2
    # distinct policy sets whose breakers are simultaneously open
    # before the failure is treated as systemic and the device path
    # disables globally
    GLOBAL_DEAD_LIMIT = 3

    def __init__(self, cache: 'pcache.Cache', engine: Optional[Engine] = None,
                 pc_builder: Optional[admission.PolicyContextBuilder] = None,
                 configuration=None,
                 namespace_labels: Optional[Callable[[str], dict]] = None,
                 audit_sink: Optional[Callable] = None,
                 ur_sink: Optional[Callable] = None,
                 event_sink: Optional[Callable] = None,
                 registry_client=None,
                 device: bool = True,
                 openapi_manager=None,
                 client=None,
                 serving_mode: Optional[str] = None,
                 torch_device=None):
        if device:
            from ..device import resolve_device
            torch_device = resolve_device(torch_device)
        self.torch_device = torch_device
        if openapi_manager is None:
            from ..openapi.manager import Manager
            openapi_manager = Manager()
        self.openapi_manager = openapi_manager
        self.cache = cache
        if engine is None and client is not None:
            # wire the engine's context loaders (ConfigMap resolution +
            # APICall urlPath entries) to the cluster client the daemon
            # serves (reference: cmd/kyverno/main.go engine construction
            # → pkg/engine/jsonContext.go:23 ContextLoaderFactory)
            from ..engine.apicall import make_context_loader
            engine = Engine(context_loader=make_context_loader(
                dclient=client, registry_client=registry_client))
        self.engine = engine or Engine()
        if pc_builder is None and client is not None:
            # short-TTL cache: the reference serves exceptions from an
            # informer cache — per-request LIST round trips would hammer
            # the API server under admission load
            _exc_cache = {'at': 0.0, 'items': []}

            def _list_exceptions():
                now = time.time()
                if now - _exc_cache['at'] > 1.0:
                    out = []
                    for api_version in ('kyverno.io/v2alpha1',
                                        'kyverno.io/v2beta1'):
                        try:
                            out += client.list_resource(
                                api_version, 'PolicyException')
                        except Exception:  # noqa: BLE001
                            pass
                    _exc_cache['items'] = out
                    _exc_cache['at'] = now
                return _exc_cache['items']
            pc_builder = admission.PolicyContextBuilder(
                configuration, exception_lister=_list_exceptions)
        self.pc_builder = pc_builder or admission.PolicyContextBuilder(
            configuration)
        self.configuration = configuration
        if namespace_labels is None and client is not None:
            # namespaceSelector match needs the live namespace's labels
            # (reference: pkg/utils/kube GetNamespaceSelectorsFromNamespaceLister
            # wired through the resource handlers)
            namespace_labels = client.get_namespace_labels
        self.namespace_labels = namespace_labels or (lambda ns: {})
        self.audit_sink = audit_sink
        self.ur_sink = ur_sink
        self.event_sink = event_sink
        self.registry_client = registry_client
        # the compiled device evaluator handles enforce validation for
        # CREATE/UPDATE requests; rebuilt when the cached policy set
        # changes
        self.device = device
        self._scanner_lock = threading.Lock()
        # LRU of compiled scanners keyed per (kind, policy set): a
        # policy set can compile both a validate BatchScanner and a
        # mutate MutateScanner, and admission traffic alternating
        # kinds/namespaces yields different policy lists which must not
        # rebuild (compile!) per request
        self._scanners: 'collections.OrderedDict[tuple, Any]' = \
            collections.OrderedDict()
        self._scanners_max = 8
        # (namespace, name) identity sets per cached scanner key: policy
        # churn replaces the Policy OBJECTS (so the id()-tuple key never
        # matches), but the logical set persists — the hot-swap
        # predecessor search matches on identity overlap
        self._scanner_ident: Dict[tuple, frozenset] = {}
        self._building: set = set()
        # per-policy-set circuit breakers (serving/breaker.py): a set
        # that keeps failing (build or scan) opens and serves the host
        # loop for an exponential backoff window, then a single
        # half-open probe decides between recovery — the set is
        # re-admitted to the device path — and a re-trip with doubled
        # backoff.  Per key, so one broken set cannot disable (nor
        # reset the counter of) a healthy one; entries pin their
        # policy objects (keys are id() tuples, so CPython id reuse
        # must not circuit-break a healthy set) and the registry is
        # size-bounded with counted evictions.  When several distinct
        # sets are open at once the failure is systemic (broken
        # backend): _breaker_opened turns the global device switch off
        # so policy churn cannot spawn an endless stream of doomed
        # compiles.
        from ..serving.breaker import BreakerRegistry
        self._breakers = BreakerRegistry(
            failure_limit=self.DEVICE_FAILURE_LIMIT,
            on_open=self._breaker_opened)
        # admission serving mode: 'batch' routes CREATE/UPDATE-path
        # validate AND mutate scans through the micro-batching scheduler
        # (serving/), 'sync' keeps the per-request dispatch
        import os as _os
        self.serving_mode = serving_mode or \
            _os.environ.get('KTPU_SERVING', 'sync')
        # device-side mutate (kyverno_tpu/mutate/): lowered strategic-
        # merge / json6902 policy sets serve the admission mutate chain
        # as batched device dispatches; 0 keeps every mutate request on
        # the host engine loop (the bit-identity oracle)
        self.mutate_device = _os.environ.get(
            'KTPU_MUTATE_DEVICE', '1') not in ('0', 'false', 'off')
        self._batcher = None
        self._batcher_lock = threading.Lock()

    @staticmethod
    def _policy_key(policies):
        return tuple(id(p) for p in policies)

    def _device_scanner(self, policies, kind: str = 'validate'):
        """Scanner for ``policies``, or None while one is still compiling.

        ``kind`` selects the program: ``validate`` builds a
        ``BatchScanner``, ``mutate`` a ``MutateScanner`` (a mutate set
        that does not lower is cached too — callers check ``.ok`` — so
        the lowering never re-runs per request).  Building pays jax
        trace + XLA compile (seconds to minutes on a policy-set change);
        doing that on the request path would blow the webhook timeout
        (reference: 10s cap, spec_types.go:95).  The build runs on a
        background thread and requests serve the host engine loop —
        identical verdicts — until the compiled path is ready.  The
        circuit breaker is keyed per policy set (kindless): a backend
        broken for one program kind is broken for the other."""
        from ..observability import coverage
        from ..serving import breaker as breaker_mod
        base = self._policy_key(policies)
        key = (kind,) + base
        decision = self._breakers.allow(base)
        if decision == breaker_mod.OPEN:
            # circuit open: host loop serves until the backoff elapses
            # (or this window's single probe is already in flight)
            coverage.record_fallback('serving',
                                     coverage.REASON_BREAKER_OPEN)
            return None
        with self._scanner_lock:
            scanner = self._scanners.get(key)
            if scanner is not None:
                self._scanners.move_to_end(key)
                # a PROBE grant rides this scanner: the caller's scan
                # outcome reaches record_success/_record_key_failure
                # downstream and resolves the half-open window
                return scanner
            if key in self._building:
                if decision == breaker_mod.PROBE:
                    # the probe cannot scan until the rebuild lands;
                    # free the slot so the next window re-probes
                    self._breakers.probe_abort(base)
                return None  # still compiling; host loop serves meanwhile
            if len(self._building) >= self.MAX_CONCURRENT_BUILDS:
                # a compile burst across many policy sets must not fork
                # unbounded trace+compile threads; later requests retry
                if decision == breaker_mod.PROBE:
                    self._breakers.probe_abort(base)
                return None
            self._building.add(key)

        def build():
            try:
                if kind == 'mutate':
                    from ..mutate import MutateScanner
                    scanner = MutateScanner(policies, engine=self.engine,
                                            device=self.torch_device)
                    if scanner.ok:
                        scanner.warmup()
                else:
                    from ..compiler.scan import BatchScanner
                    scanner = BatchScanner(policies, engine=self.engine,
                                           device=self.torch_device)
                    # pre-warm the small-batch shape an admission request
                    # hits (AOT-loads from the persistent executable store
                    # when a prior process already compiled this set)
                    scanner.warmup()
                self._install_scanner(key, base, kind, policies,
                                      scanner)
            except Exception as e:  # noqa: BLE001
                # a policy set that cannot compile must trip the circuit
                # breaker, or every request re-spawns a doomed
                # multi-second compile
                self._record_key_failure(base, policies,
                                         f'build failed ({kind}): {e}')
            finally:
                with self._scanner_lock:
                    self._building.discard(key)
        threading.Thread(target=build, name='ktpu-scanner-build',
                         daemon=True).start()
        if decision == breaker_mod.PROBE:
            # the probe's real verdict is the rebuild just spawned: a
            # build failure re-trips via _record_key_failure; success
            # caches the scanner for the next probe to ride.  Either
            # way this caller serves the host loop now, so the slot
            # frees for the next window
            self._breakers.probe_abort(base)
        return None

    def _install_scanner(self, key: tuple, base: tuple, kind: str,
                         policies, scanner) -> None:
        """Insert a freshly built scanner, hot-swapping any live
        predecessor serving the same logical policy set.

        Policy churn replaces the Policy objects, so the successor's
        id()-tuple key never matches the predecessor's — the logical
        set is matched by (namespace, name) identity overlap instead.
        The swap is atomic under the scanner lock AFTER the successor
        is fully built and warmed: requests keep riding the predecessor
        (or the host loop, with identical verdicts) until the flip, so
        a churn event never sheds and never 500s.  In-flight batches
        hold direct references to the predecessor and drain naturally.
        Breaker state migrates to the successor's key instead of
        resetting to closed — a backend fault that tripped the old
        serial must not be forgiven by recompiling the policy set."""
        from ..observability.metrics import global_registry
        ident = frozenset((p.namespace, p.name) for p in policies)
        swapped = None
        with self._scanner_lock:
            best, best_ratio = None, 0.0
            for k in self._scanners:
                if k[0] != key[0] or k == key:
                    continue
                prev = self._scanner_ident.get(k)
                if not prev:
                    continue
                ratio = len(ident & prev) / max(len(ident), len(prev), 1)
                if ratio > best_ratio:
                    best, best_ratio = k, ratio
            if best is not None and best_ratio >= 0.5:
                old = self._scanners.pop(best)
                self._scanner_ident.pop(best, None)
                state = self._breakers.migrate(best[1:], base,
                                               policies=policies)
                swapped = (old, state)
            while len(self._scanners) >= self._scanners_max:
                evicted, _ = self._scanners.popitem(last=False)
                self._scanner_ident.pop(evicted, None)
            self._scanners[key] = scanner
            self._scanner_ident[key] = ident
        if swapped is None:
            return
        old, state = swapped
        reg = global_registry()
        if reg is not None:
            reg.inc(SCANNER_HOT_SWAPS, kind=kind)
            reg.inc(BREAKER_MIGRATIONS)
        touched = None
        old_pset = getattr(old, '_pset', None)
        new_pset = getattr(scanner, '_pset', None)
        if old_pset is not None and new_pset is not None:
            from ..partition.plan import diff_plans
            touched = diff_plans(old_pset.plan, new_pset.plan).touched
        from ..partition import census as partition_census
        partition_census.record_swap(
            kind, getattr(old, 'serial', None),
            getattr(scanner, 'serial', None),
            breaker_state=state, touched=touched)
        import logging
        from ..observability.logging import with_values
        with_values(logging.getLogger('kyverno.webhooks'),
                    'scanner hot-swap', kind=kind,
                    old_serial=getattr(old, 'serial', None),
                    new_serial=getattr(scanner, 'serial', None),
                    breaker_state=state)

    def _record_key_failure(self, key: tuple, policies, reason: str) -> None:
        import logging
        from ..observability.logging import with_values
        from ..serving import breaker as breaker_mod
        log = logging.getLogger('kyverno.webhooks')
        state = self._breakers.record_failure(key, policies, reason)
        with_values(log, 'device path failure', level=logging.ERROR,
                    error=reason, breaker_state=state)
        if state == breaker_mod.OPEN:
            with_values(log, 'circuit open: policy set quarantined to '
                        'the host loop until the backoff elapses',
                        level=logging.ERROR)

    def _breaker_opened(self, open_count: int) -> None:
        """BreakerRegistry trip callback: several distinct policy sets
        open at once means the backend itself is broken — flip the
        global device switch off so churn cannot spawn an endless
        stream of doomed compiles (individual breakers still recover
        per set if the operator re-enables the device path)."""
        if open_count >= self.GLOBAL_DEAD_LIMIT and self.device:
            import logging
            from ..observability.logging import with_values
            self.device = False
            with_values(logging.getLogger('kyverno.webhooks'),
                        'device path disabled globally: multiple '
                        'policy sets failing (systemic backend failure)',
                        level=logging.ERROR)

    def wait_device_ready(self, policies, timeout: float = 600.0) -> bool:
        """Block until the compiled scanner for ``policies`` is serving
        (benchmarks / tests measuring steady-state latency).  Returns
        False immediately while the set's circuit breaker is open."""
        from ..serving import breaker as breaker_mod
        key = self._policy_key(policies)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self.device:
                return False
            if self._breakers.state(key) == breaker_mod.OPEN:
                return False
            if self._device_scanner(policies) is not None:
                # readiness polling never scans: release any half-open
                # probe slot the allow() check granted on our behalf
                self._breakers.probe_abort(key)
                return True
            time.sleep(0.05)
        return False

    # -- admission micro-batching (serving/) -------------------------------

    def _get_batcher(self):
        batcher = self._batcher
        if batcher is None:
            with self._batcher_lock:
                batcher = self._batcher
                if batcher is None:
                    from ..serving.batcher import AdmissionBatcher
                    batcher = AdmissionBatcher(
                        on_success=self._batch_scan_ok,
                        on_failure=self._batch_scan_failed)
                    self._batcher = batcher
        return batcher

    def _batch_scan_ok(self, policies) -> None:
        # mirror of the sync path's success bookkeeping: a successful
        # dispatch closes the set's breaker (half-open probe recovery)
        # or forgets its consecutive-failure count
        self._breakers.record_success(self._policy_key(policies))

    def _batch_scan_failed(self, policies, error) -> None:
        # mirror of the sync path's failure recovery: drop the broken
        # scanner so the next request rebuilds it, and count one breaker
        # failure for the set (the whole batch sheds on one dispatch, so
        # a broken backend trips the breaker per dispatch, not per
        # rider).  Both program kinds are dropped — the callback only
        # knows the policy set, and a rebuild of the innocent kind is
        # cheap next to a broken backend
        base = self._policy_key(policies)
        with self._scanner_lock:
            for kind in ('validate', 'mutate'):
                self._scanners.pop((kind,) + base, None)
        self._record_key_failure(
            base, policies,
            f'batched scan failed, shedding to host engine: {error}')

    def _batched_scan(self, scanner, policies, request, pctx,
                      old_resource: Optional[dict] = None,
                      resource: Optional[dict] = None):
        """Route one validate or mutate scan through the micro-batcher.

        The ticket key is the scanner's monotonic serial alone:
        validate and mutate compile distinct scanners so those
        dispatches never mix, while distinct users, roles, namespaces
        AND verbs coalesce — each rider's admission tuple rides to the
        scanner as a per-row column (compiler/admission.py), so a
        shared dispatch stays bit-identical to every request's own
        sync scan.  Returns ``(responses, prov)``: this request's result
        rows (None when the request shed to the host engine loop —
        queue full, deadline blown, dispatch failed, or batcher stopped
        — the caller then serves the identical-verdict host path, never
        a 500) and the decision-provenance fields of whatever happened:
        ``path`` is ``batch`` with the batcher-filled batch id /
        occupancy / amortized device share on success, or
        ``shed:<reason>`` with the time spent waiting otherwise."""
        import time as _time
        from ..serving import shed as shed_policy
        from ..serving.queue import QueueFull, Stopped
        batcher = self._get_batcher()
        if resource is None:
            resource = admission.request_resource(request)
        adm = (pctx.admission_info, pctx.exclude_group_roles,
               pctx.namespace_labels, request.get('operation') or 'CREATE')
        try:
            ticket = batcher.submit(
                resource=resource, context=pctx.json_context._data,
                pctx=pctx, admission=adm, scanner=scanner,
                policies=policies, old_resource=old_resource)
        except QueueFull:
            batcher.record_shed(shed_policy.REASON_QUEUE_FULL)
            return None, {'path':
                          f'shed:{shed_policy.REASON_QUEUE_FULL}'}
        except Stopped:
            batcher.record_shed(shed_policy.REASON_SHUTDOWN)
            return None, {'path': f'shed:{shed_policy.REASON_SHUTDOWN}'}
        deadline_s = batcher.shed_deadline_s
        ts = request.get('timeoutSeconds')
        if ts:
            # the API server aborts the whole call at the webhook's own
            # timeoutSeconds (reference: spec_types.go:95): shed at half
            # that budget so the host-loop fallback still fits in the
            # remainder, never loosening the KTPU_SHED_DEADLINE_MS cap
            try:
                deadline_s = min(deadline_s, max(0.01, float(ts) / 2.0))
            except (TypeError, ValueError):
                pass
        responses = ticket.wait(deadline_s)
        if responses is None:
            reason = ticket.shed_reason or shed_policy.REASON_DEADLINE
            return None, {
                'path': f'shed:{reason}',
                'queue_wait_s': _time.monotonic() - ticket.enqueued_at}
        prov = dict(ticket.prov) if ticket.prov is not None else {}
        prov['path'] = 'batch'
        return responses, prov

    def shutdown(self) -> None:
        """Drain and stop the admission batcher: pending futures get
        their batched responses before the process exits (wired through
        WebhookServer.stop and cmd/internal.Setup shutdown hooks)."""
        batcher = self._batcher
        if batcher is not None:
            batcher.stop(drain=True)

    # -- validate ---------------------------------------------------------

    def validate(self, request: dict,
                 failure_policy: str = 'Fail') -> dict:
        """reference: pkg/webhooks/resource/handlers.go:110 Validate"""
        uid = request.get('uid', '')
        kind = (request.get('kind') or {}).get('kind', '')
        ns = request.get('namespace', '')
        policies = self.cache.get_policies(pcache.VALIDATE_ENFORCE, kind, ns)
        generate_policies = self.cache.get_policies(pcache.GENERATE, kind, ns)
        from ..observability import provenance
        from ..observability import slo
        prov_on = provenance.enabled()
        slo_on = slo.enabled()
        t_start = time.monotonic() if (prov_on or slo_on) else 0.0
        # decision provenance: which serving path answered this request
        # (batch | sync | shed:<reason> | host_fallback) plus the
        # batch/cache attribution that path produced
        prov_path = 'host_fallback'
        prov_extra: Dict[str, Any] = {}
        try:
            pctx = self.pc_builder.build(request)
        except Exception as e:  # noqa: BLE001
            if prov_on or slo_on:
                duration_s = time.monotonic() - t_start
                slo.record('host_fallback', duration_s)
                if prov_on:
                    provenance.record_decision(
                        path='host_fallback', uid=uid, kind=kind,
                        namespace=ns,
                        name=request.get('name', '') or '',
                        operation=request.get('operation', '') or '',
                        duration_s=duration_s,
                        error=f'policy context build failed: {e}')
            return admission.response(uid, False,
                                      f'failed to build policy context: {e}')
        pctx.namespace_labels = self.namespace_labels(ns)

        responses: List[EngineResponse] = []
        # device fast path: CREATE and UPDATE requests with no policy
        # exceptions run through the compiled batch evaluator (exact via
        # host fallback); UPDATE rows carry oldObject for the scanner's
        # old-match retry; DELETE keeps the engine loop (no new object)
        operation = request.get('operation') or ''
        use_device = (self.device and policies and
                      operation in ('CREATE', 'UPDATE') and
                      not pctx.exceptions)
        old_doc = (admission.request_old_resource(request) or None) \
            if operation == 'UPDATE' else None
        if use_device:
            try:
                from .. import faults
                faults.check(faults.SITE_WEBHOOK_HANDLER)
                scanner = self._device_scanner(policies)
                if scanner is None:
                    # compiled path still building — or the set's
                    # circuit breaker is open: host loop this request
                    from ..serving import breaker as breaker_mod
                    if self._breakers.state(self._policy_key(
                            policies)) != breaker_mod.CLOSED:
                        from ..serving import shed as shed_policy
                        prov_path = \
                            f'shed:{shed_policy.REASON_BREAKER_OPEN}'
                        if self.serving_mode == 'batch':
                            self._get_batcher().record_shed(
                                shed_policy.REASON_BREAKER_OPEN)
                    use_device = False
                elif self.serving_mode == 'batch':
                    # micro-batching scheduler: this request coalesces
                    # with concurrent same-policy-set same-verb requests
                    # into one shared device dispatch
                    # (serving/batcher.py); a shed comes back as None
                    # and the host loop serves
                    batched, bprov = self._batched_scan(
                        scanner, policies, request, pctx,
                        old_resource=old_doc)
                    prov_path = bprov.pop('path')
                    prov_extra = bprov
                    prov_extra['fingerprint'] = getattr(
                        scanner, 'fingerprint', '')
                    if batched is None:
                        use_device = False
                    else:
                        responses = batched
                else:
                    from ..observability import device as devtel
                    resource = admission.request_resource(request)
                    cap = devtel.ScanCapture() if prov_on else None
                    with devtel.install_capture(cap):
                        [responses] = scanner.scan(
                            [resource],
                            contexts=[pctx.json_context._data],
                            admission=(pctx.admission_info,
                                       pctx.exclude_group_roles,
                                       pctx.namespace_labels, operation),
                            pctx_factory=lambda doc: pctx,
                            old_resources=[old_doc] if old_doc else None)
                    prov_path = 'sync'
                    if cap is not None:
                        device_eval_s = cap.stage_s('device_eval')
                        prov_extra = {
                            'occupancy': 1,
                            'device_share_s': device_eval_s,
                            'device_eval_s': device_eval_s,
                            'aot_cache': cap.aot,
                            'coverage_ratio': cap.coverage_ratio,
                            'fingerprint': getattr(scanner,
                                                   'fingerprint', ''),
                        }
                    # success closes the set's breaker (recovery) or
                    # forgets its consecutive-failure count
                    self._breakers.record_success(
                        self._policy_key(policies))
            except Exception as e:  # noqa: BLE001
                # device failure must not turn into a 500: drop to the
                # host engine loop and discard the broken scanner so the
                # next request rebuilds it (failure recovery, SURVEY §5.3).
                # Repeated failures trip the per-set circuit breaker —
                # otherwise every request would pay a full policy-set
                # recompile before falling back.
                base = self._policy_key(policies)
                with self._scanner_lock:
                    self._scanners.pop(('validate',) + base, None)
                self._record_key_failure(
                    base, policies,
                    f'scan failed, falling back to host engine: {e}')
                provenance.notify_scan_error(e)
                use_device = False
                responses = []
                prov_path = 'host_fallback'
                prov_extra = {'error': f'scan failed: {e}'}
        if not use_device:
            for policy in policies:
                ctx = pctx.copy()
                ctx.policy = policy
                responses.append(self.engine.validate(ctx))
        # annotate the handler span with the serving path so a trace
        # distinguishes compiled-device requests from host-loop ones
        from ..observability import tracing
        span = tracing.current_span()
        if span is not None:
            span.set_attribute('device_path', bool(use_device))
        if prov_on or slo_on:
            duration_s = time.monotonic() - t_start
            # feed the admission-latency SLO digest (shed:<reason>
            # folds to the shed path inside record); no-op when the
            # engine is off (KTPU_SLO_WINDOW_S=0)
            slo.record(prov_path, duration_s)
            if prov_on:
                provenance.record_decision(
                    path=prov_path, uid=uid, kind=kind, namespace=ns,
                    name=request.get('name', '') or '',
                    operation=request.get('operation', '') or '',
                    duration_s=duration_s, **prov_extra)
        blocked = block_request(responses, failure_policy)
        if self.event_sink is not None and responses:
            # reference: handlers.go Validate -> webhooks/utils/event.go
            # GenerateEvents fed to the event controller
            self.event_sink(responses, blocked)
        if blocked:
            return admission.response(uid, False,
                                      get_blocked_messages(responses))
        # async hand-offs: audit-mode policies and generate URs
        if self.audit_sink is not None:
            self.audit_sink(request, responses)
        if self.ur_sink is not None and generate_policies:
            self._create_update_requests(request, pctx, generate_policies)
        if self.ur_sink is not None:
            # mutate-existing policies ride UpdateRequests too
            # (reference: pkg/webhooks/resource/updaterequest.go:20
            # handleMutateExisting; DELETE triggers use the old object)
            trigger_doc = admission.request_resource(request) or \
                admission.request_old_resource(request)
            trigger_res = Resource(trigger_doc)
            mutate_existing = [
                p for p in self.cache.get_policies(pcache.MUTATE, kind, ns)
                if any((r.raw.get('mutate') or {}).get('targets') and
                       matches_resource_description(
                           trigger_res, r, pctx.admission_info,
                           pctx.exclude_group_roles, pctx.namespace_labels,
                           p.namespace) is None
                       for r in p.rules)]
            if mutate_existing:
                self._create_update_requests(request, pctx,
                                             mutate_existing,
                                             ur_type='mutate')
        warnings = get_warning_messages(responses)
        return admission.response(uid, True, '', warnings)

    def audit_responses(self, request: dict) -> List[EngineResponse]:
        """Audit-mode engine responses for report construction
        (reference: validation.go:156 buildAuditResponses)."""
        kind = (request.get('kind') or {}).get('kind', '')
        ns = request.get('namespace', '')
        policies = self.cache.get_policies(pcache.VALIDATE_AUDIT, kind, ns)
        pctx = self.pc_builder.build(request)
        pctx.namespace_labels = self.namespace_labels(ns)
        out = []
        for policy in policies:
            ctx = pctx.copy()
            ctx.policy = policy
            out.append(self.engine.validate(ctx))
        return out

    def _create_update_requests(self, request: dict, pctx, policies,
                                ur_type: str = 'generate') -> None:
        """Spawn UpdateRequests for generate / mutate-existing policies
        on admission (reference: pkg/webhooks/resource/updaterequest.go:20)."""
        resource = admission.request_resource(request)
        if not resource and request.get('operation') == 'DELETE':
            resource = admission.request_old_resource(request)
        r = Resource(resource)
        for policy in policies:
            policy_key = f'{policy.namespace}/{policy.name}' \
                if policy.namespace else policy.name
            self.ur_sink({
                'type': ur_type,
                'policy': policy_key,
                'resource': {
                    'kind': r.kind, 'apiVersion': r.api_version,
                    'namespace': r.namespace, 'name': r.name,
                },
                'context': {
                    'userInfo': request.get('userInfo') or {},
                    'admissionRequestInfo': {
                        'operation': request.get('operation', ''),
                        # the background processors rebuild the admission
                        # context — DELETE triggers resolve from oldObject
                        # (reference: pkg/background/common/context.go:32)
                        'admissionRequest': {
                            'operation': request.get('operation', ''),
                            'object': request.get('object'),
                            'oldObject': request.get('oldObject'),
                            'userInfo': request.get('userInfo') or {},
                        },
                    },
                },
            })

    # -- mutate -----------------------------------------------------------

    @staticmethod
    def _canonicalize_context_images(pctx) -> None:
        from ..engine.mutate.jsonpatch import apply_patch
        from ..utils.image_extract import extract_images_from_resource
        try:
            infos = extract_images_from_resource(pctx.new_resource, None)
        except Exception:  # noqa: BLE001 - no images is the common case
            return
        ops = [{'op': 'replace', 'path': info.pointer, 'value': str(info)}
               for group in infos.values() for info in group.values()
               if info.pointer]
        if not ops:
            return
        import copy as _copy
        try:
            patched = apply_patch(_copy.deepcopy(pctx.new_resource), ops)
            pctx.json_context.add_resource(patched)
        except Exception:  # noqa: BLE001 - context stays unpatched
            pass

    def _post_mutate_policy(self, uid: str, policy, er: EngineResponse,
                            patches: List[dict],
                            responses: List[EngineResponse],
                            failure_policy: str) -> Optional[dict]:
        """Per-policy admission bookkeeping shared by the host mutate
        loop and the device fast path: deny on failure, collect patches,
        schema-validate the patched resource.  Returns the deny response
        or None to continue the chain."""
        if not er.is_successful():
            # a failed/errored mutate rule fails the admission —
            # failurePolicy only covers webhook transport failures
            # (reference: mutation.go:163 applyMutation →
            # mutation.go:112 'mutation policy %s error')
            failed = er.get_failed_rules()
            return admission.response(
                uid, False,
                f'mutation policy {policy.name} error: failed to '
                f'apply policy {policy.name} rules {failed}')
        policy_patches = [p for rr in er.policy_response.rules
                          for p in (rr.patches or [])]
        if policy_patches:
            patches.extend(policy_patches)
            # the mutated resource must stay schema-valid
            # (reference: mutation.go → openapi.ValidateResource,
            # pkg/openapi/manager.go:88)
            if self.openapi_manager is not None and er.patched_resource:
                from ..openapi.manager import ValidationError
                try:
                    self.openapi_manager.validate_resource(
                        er.patched_resource)
                except ValidationError as e:
                    return admission.response(
                        uid, False,
                        f'mutated resource failed schema validation: '
                        f'{e}')
        responses.append(er)
        if er.is_error() and failure_policy == 'Fail':
            return admission.response(
                uid, False, get_blocked_messages(responses))
        return None

    def _device_mutate_steps(self, request: dict, pctx,
                             mutate_policies) -> Optional[list]:
        """The device mutate chain for one request, or None when the
        host engine loop must serve it (knob off, verb outside
        CREATE/UPDATE, exceptions/subresource in play, set not lowered,
        scanner still building, shed, or scan failure — never a 500).
        Returns the ordered ``[(policy, EngineResponse), ...]`` steps,
        bit-identical to the host loop by construction
        (kyverno_tpu/mutate/scanner.py)."""
        operation = request.get('operation') or ''
        if not (self.device and self.mutate_device and mutate_policies and
                operation in ('CREATE', 'UPDATE') and
                not pctx.exceptions and not request.get('subResource')):
            return None
        try:
            scanner = self._device_scanner(mutate_policies, kind='mutate')
            if scanner is None or not scanner.ok:
                # still lowering, or the set does not lower (the
                # placement records on the coverage ledger name why)
                return None
            if self.serving_mode == 'batch':
                row, _prov = self._batched_scan(
                    scanner, mutate_policies, request, pctx,
                    resource=pctx.new_resource)
                return row  # None on shed -> host loop
            [row] = scanner.scan(
                [pctx.new_resource],
                admission=(pctx.admission_info,
                           pctx.exclude_group_roles,
                           pctx.namespace_labels, operation),
                pctx_factory=lambda doc: pctx)
            self._breakers.record_success(
                self._policy_key(mutate_policies))
            return row
        except Exception as e:  # noqa: BLE001
            # identical never-500 recovery to the validate path: drop
            # the broken scanner, count one breaker failure, host loop
            base = self._policy_key(mutate_policies)
            with self._scanner_lock:
                self._scanners.pop(('mutate',) + base, None)
            self._record_key_failure(
                base, mutate_policies,
                f'mutate scan failed, falling back to host engine: {e}')
            return None

    def mutate(self, request: dict, failure_policy: str = 'Fail') -> dict:
        """reference: pkg/webhooks/resource/handlers.go:157 Mutate +
        mutation.go:80 applyMutations (sequential, cumulative)."""
        uid = request.get('uid', '')
        kind = (request.get('kind') or {}).get('kind', '')
        ns = request.get('namespace', '')
        mutate_policies = self.cache.get_policies(pcache.MUTATE, kind, ns)
        verify_policies = self.cache.get_policies(
            pcache.VERIFY_IMAGES_MUTATE, kind, ns)
        try:
            pctx = self.pc_builder.build(request)
        except Exception as e:  # noqa: BLE001
            return admission.response(uid, False,
                                      f'failed to build policy context: {e}')
        pctx.namespace_labels = self.namespace_labels(ns)
        # canonicalize images in the JSON context's request.object so
        # {{request.object...image}} variables resolve to the full
        # registry form; the stored resource and emitted patches keep the
        # original spelling (reference: handlers.go:174 →
        # pkg/engine/context/imageutils.go:12 MutateResourceWithImageInfo)
        self._canonicalize_context_images(pctx)

        patches: List[dict] = []
        responses: List[EngineResponse] = []
        # device fast path: a lowered mutate policy set evaluates its
        # whole cumulative chain as one batched device dispatch
        # (kyverno_tpu/mutate/) whose rows coalesce with concurrent
        # mutate requests in batch serving mode
        device_row = self._device_mutate_steps(request, pctx,
                                               mutate_policies)
        if device_row is not None:
            steps, patched = device_row
            for policy, er in steps:
                deny = self._post_mutate_policy(uid, policy, er, patches,
                                                responses, failure_policy)
                if deny is not None:
                    return deny
            if steps:
                # verify-images policies see the chain's cumulative
                # output, exactly as the host loop threads it
                pctx = pctx.copy()
                pctx.new_resource = patched or pctx.new_resource
                pctx.json_context.add_resource(pctx.new_resource)
        else:
            for policy in mutate_policies:
                if not any(r.has_mutate() for r in policy.rules):
                    continue
                ctx = pctx.copy()
                ctx.policy = policy
                er = self.engine.mutate(ctx)
                deny = self._post_mutate_policy(uid, policy, er, patches,
                                                responses, failure_policy)
                if deny is not None:
                    return deny
                # mutations apply cumulatively: the patched resource
                # re-enters the context for the next policy
                # (mutation.go:123)
                pctx = pctx.copy()
                pctx.new_resource = er.patched_resource or \
                    pctx.new_resource
                pctx.json_context.add_resource(pctx.new_resource)
        for policy in verify_policies:
            ctx = pctx.copy()
            ctx.policy = policy
            er, _meta = self.engine.verify_and_patch_images(
                ctx, self.registry_client)
            iv_patches = [p for rr in er.policy_response.rules
                          for p in (rr.patches or [])]
            patches.extend(iv_patches)
            responses.append(er)
            if er.is_failed():
                return admission.response(
                    uid, False, get_blocked_messages(responses))
        warnings = get_warning_messages(responses)
        return admission.mutation_response(uid, patches, warnings)
