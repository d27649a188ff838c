"""Admission-controller daemon (reference: cmd/kyverno/main.go:210).

Wires cert renewal, the policy cache, the webhook server, and the
leader-only reconcilers (webhook configurations, lease watchdog).  Its
scanners run on the CUDA card unless the caller names another device.
Admission scans are one chunk or less, so they encode in-process and
never fork an encoder pool after the CUDA context exists."""

from __future__ import annotations

import copy
import tempfile
import threading
from typing import List, Optional

from ..aotcache.keys import policy_semantics
from ..api.policy import Policy
from ..controllers.leaderelection import LeaderElector, mesh_is_leader
from ..controllers.webhook import WebhookConfigReconciler
from ..policycache.cache import Cache
from ..tls.certs import CertRenewer
from ..webhooks.handlers import ResourceHandlers
from ..webhooks.server import WebhookServer
from .internal import Setup, base_parser


class AdmissionController:
    """The admission daemon over ``setup.client``; its scanners run on
    ``device`` (default: the CUDA card; raises without one — pass
    ``device='cpu'`` for the host)."""

    def __init__(self, setup: Setup, port: int = 9443, tls: bool = True,
                 device=None):
        self.setup = setup
        self.cache = Cache()
        self.cert_renewer = CertRenewer(setup.client,
                                        setup.options.namespace)
        # the CA/pair secrets are always provisioned — webhook configs
        # need the CA bundle even when serving plain HTTP in tests
        _ca, cert, key = self.cert_renewer.renew()
        certfile = keyfile = None
        if tls:
            self._cert_tmp = tempfile.NamedTemporaryFile(suffix='.crt')
            self._key_tmp = tempfile.NamedTemporaryFile(suffix='.key')
            self._cert_tmp.write(cert)
            self._cert_tmp.flush()
            self._key_tmp.write(key)
            self._key_tmp.flush()
            certfile, keyfile = self._cert_tmp.name, self._key_tmp.name
        self._audit_threads: List[threading.Thread] = []
        # the documents of the last policy sync and their Policy objects
        self._sync_lock = threading.Lock()
        self._synced_semantics: Optional[List[tuple]] = None
        self._synced: List[Policy] = []
        # admission events ride the bounded event controller (reference:
        # pkg/event/controller.go wired in cmd/kyverno/main.go)
        from ..observability.events import EventGenerator
        self.event_generator = EventGenerator(setup.client)
        self.event_generator.run()
        self.handlers = ResourceHandlers(
            self.cache, configuration=setup.configuration,
            ur_sink=self._create_ur, audit_sink=self._audit,
            event_sink=self._events,
            client=setup.client, torch_device=device)
        # CRD schema ingestion feeding the mutation schema checks
        # (reference: pkg/controllers/openapi/controller.go:148)
        from ..controllers.openapi import OpenAPIController
        self.openapi_controller = OpenAPIController(
            setup.client, self.handlers.openapi_manager)
        self.openapi_controller.reconcile()
        # policy change/rule-info metrics driven by policy events
        # (reference: pkg/controllers/metrics/policy/controller.go:155)
        from ..controllers.policymetrics import PolicyMetricsController
        self.policy_metrics = PolicyMetricsController(
            setup.client, setup.metrics)
        # background AOT warm-up: pre-compile (or pre-load from the
        # persistent executable store) the admission graph for the
        # installed enforce policy set before first traffic; readiness
        # is reported through /health/warmup and the warm-duration
        # histogram.  Requests serve the host engine loop meanwhile.
        self.warmer = setup.start_aot_warmer(self._warm_admission)
        from ..webhooks.server import PolicyHandlers
        self.server = WebhookServer(
            self.handlers, configuration=setup.configuration,
            policy_handlers=PolicyHandlers(setup.client),
            port=port, certfile=certfile, keyfile=keyfile,
            warmer=self.warmer)
        self.reconciler = WebhookConfigReconciler(
            setup.client, self.cert_renewer.ca_bundle(),
            setup.options.namespace)
        # graceful shutdown (LIFO): stop the server first — which
        # drains the admission micro-batcher so queued futures resolve
        # — then close the event/audit workers
        setup.register_shutdown(self.close)
        setup.register_shutdown(self.server.stop)
        self.elector = None
        if setup.options.leader_election:
            self.elector = LeaderElector(setup.client, 'kyverno',
                                         setup.options.namespace)

    def _warm_admission(self):
        """Warm-fn for the AOT warmer: on the card, build (or find in
        ``KTPU_COMPILE_CACHE``) every CUDA kernel at once; then build the
        scanner for the installed enforce policy set, its K1v programs
        loaded from the AOT store or lowered — then bring EVERY
        canonical batch capacity to readiness (the audit path scans at
        the bulk capacity, admission at the small one).  The span
        reports how many shapes came up and how many kernels were
        compiled in how long."""
        from ..policycache import cache as pcache
        self.sync_policies()
        enforce = self.cache.get_policies(pcache.VALIDATE_ENFORCE,
                                          'Pod', '')
        if not enforce:
            return 'no enforce policies installed'
        if not self.handlers.device:
            return 'device path disabled'
        built = {}
        if self.handlers.torch_device.type == 'cuda':
            from ..ops import _build
            # one nvcc per source, all at once: lazily, each kernel
            # would compile in turn at its first launch
            built = _build.build_all()
        ok = self.handlers.wait_device_ready(enforce, timeout=600.0)
        if not ok:
            return 'device path unavailable; host loop serves'
        scanner = self.handlers._device_scanner(enforce)
        shapes = {}
        if scanner is not None and hasattr(scanner, 'warmup_shapes'):
            shapes = scanner.warmup_shapes()
        detail = 'compiled scanner serving' + (
            ' (capacities ' +
            ', '.join(f'{c}:{s:.1f}s' for c, s in sorted(shapes.items()))
            + ')' if shapes else '')
        return detail, {'shapes_warmed': len(shapes),
                        'shape_caps': ','.join(str(c)
                                               for c in sorted(shapes)),
                        'kernels_built': sum(1 for t in built.values()
                                             if t > 0),
                        'kernel_build_s': max(built.values(), default=0.0)}

    def _create_ur(self, ur_spec: dict) -> None:
        from ..background.updaterequest import UpdateRequestGenerator
        UpdateRequestGenerator(self.setup.client).apply(
            dict(ur_spec, requestType=ur_spec.get('type', 'generate')))

    def _events(self, responses, blocked: bool) -> None:
        from ..observability.events import events_for_responses
        self.event_generator.add(
            *events_for_responses(responses, blocked))

    def _audit(self, request: dict, _enforce_responses) -> None:
        """Audit-report hand-off: runs on a worker thread like the
        reference's goroutine (validation.go:182 handleAudit) so the
        admission response never waits on the audit engine pass or the
        report CR write."""
        if request.get('operation') == 'DELETE':
            return
        t = threading.Thread(target=self._audit_sync,
                             args=(request, list(_enforce_responses or [])),
                             daemon=True, name='audit-report')
        t.start()
        self._audit_threads.append(t)
        del self._audit_threads[:-32]  # drop handles of finished work

    def flush_audits(self) -> None:
        """Join outstanding audit threads (tests / graceful shutdown)."""
        for t in list(self._audit_threads):
            t.join(timeout=30)

    def _audit_sync(self, request: dict,
                    enforce_responses=()) -> None:
        """reference: validation.go:156 buildAuditResponses — the AUDIT
        policy set plus the already-computed enforce responses produce
        per-request AdmissionReport CRs for the reports controller to
        aggregate (the reference reports over ALL engine responses)."""
        resource = request.get('object') or {}
        responses = list(enforce_responses) +             self.handlers.audit_responses(request)
        relevant = [r for r in responses if r.policy_response.rules]
        if not relevant:
            return
        from ..dclient.client import AlreadyExistsError
        from ..reports.types import build_admission_report
        report = build_admission_report(resource, request, *relevant)
        ns = (resource.get('metadata') or {}).get('namespace', '')
        try:
            self.setup.client.create_resource(
                'kyverno.io/v1alpha2', report['kind'], ns, report)
        except AlreadyExistsError:
            pass  # duplicate request uid: the first report stands

    def sync_policies(self) -> List[Policy]:
        """Refresh the cache from stored Policy CRs (informer-driven in
        the reference: pkg/controllers/policycache/controller.go:133)."""
        docs = []
        # policy CRDs are served at multiple versions (v1 is the
        # storage version; v2beta1 manifests are conversion-identical
        # for the fields the engine reads)
        for api_version in ('kyverno.io/v1', 'kyverno.io/v2beta1'):
            for kind in ('ClusterPolicy', 'Policy'):
                try:
                    docs += self.setup.client.list_resource(
                        api_version, kind, '', None)
                except Exception:  # noqa: BLE001
                    continue
        seen = [policy_semantics(d) for d in docs]
        with self._sync_lock:
            # unchanged policies keep their Policy objects: the handlers
            # key each compiled scanner by its policies' identities, so
            # re-warming an unchanged set (or one whose status the
            # reconciler just wrote back) would rebuild every scanner
            # and serve the host loop while they build.  Each kept
            # object takes the server's current document, so the
            # reports stamp its current resourceVersion
            if seen != self._synced_semantics:
                self._synced = [Policy(d) for d in docs]
                self._synced_semantics = seen
                self.cache.warm_up(self._synced)
            else:
                for policy, doc in zip(self._synced, docs):
                    policy.raw = doc
            return list(self._synced)

    def tick(self) -> None:
        policies = self.sync_policies()
        self.openapi_controller.reconcile()
        is_leader = mesh_is_leader() and (
            self.elector is None or self.elector.is_leader())
        if is_leader:
            # the reconciler records each policy's status on the objects
            # it is given: copies, so that the serving set's documents
            # change only at a sync
            self.reconciler.reconcile(
                [Policy(copy.deepcopy(p.raw)) for p in policies])
            self.reconciler.heartbeat()

    def close(self) -> None:
        """Stop owned worker threads (event generator, audits)."""
        self.flush_audits()
        self.event_generator.stop()

    def run(self) -> None:
        if self.elector is not None:
            self.elector.run()
        self.server.start()
        self.setup.install_signal_handlers()
        self.setup.run_until_stopped(self.tick, interval=5.0)
        self.setup.shutdown()
        if self.elector is not None:
            self.elector.release()


def main(args: Optional[List[str]] = None) -> int:
    parser = base_parser('kyverno-admission-controller')
    parser.add_argument('--port', type=int, default=9443)
    parser.add_argument('--insecure', action='store_true',
                        help='serve plain HTTP (tests/dev)')
    setup = Setup('kyverno-admission-controller', args, parser)
    controller = AdmissionController(setup, port=setup.options.port,
                                     tls=not setup.options.insecure)
    controller.run()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
