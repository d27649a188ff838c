"""HTTPS admission webhook server.

Route table and lifecycle mirror the reference's server
(reference: pkg/webhooks/server.go:69 NewServer, routes :102-115):

  POST /validate[/fail|/ignore]     resource validation
  POST /mutate[/fail|/ignore]       resource mutation
  POST /policyvalidate              policy CR validation
  POST /policymutate                policy CR defaulting
  POST /exceptionvalidate           PolicyException validation
  POST /verifymutate                lease heartbeat mutation
  GET  /health/liveness             liveness probe
  GET  /health/readiness            readiness probe
  GET  /health                      aggregate health JSON (readiness +
                                    warm-up + SLO verdict)

TLS is loaded from cert/key PEM files when provided (the reference reads
its pair per-handshake from the certmanager secret, server.go:155-177).
"""

from __future__ import annotations

import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from . import admission
from .handlers import (DumpBuffer, Handler, ResourceHandlers, with_dump,
                       with_filter, with_protection)


def _allow_all(request: dict) -> dict:
    return admission.response(request.get('uid', ''), True)


class PolicyHandlers:
    """Policy CR admission (validate/mutate) — overridden by the policy
    lifecycle module (reference: pkg/webhooks/policy/handlers.go).

    ``client`` enables SSAR-backed generate permission pre-flight
    (reference: pkg/policy/actions.go validateActions, mock=false)."""

    def __init__(self, client=None):
        self.client = client

    def validate(self, request: dict) -> dict:
        from ..policy.validate import validate_policy_admission
        return validate_policy_admission(request, self.client)

    def mutate(self, request: dict) -> dict:
        return _allow_all(request)


class ExceptionHandlers:
    def validate(self, request: dict) -> dict:
        from ..policy.validate import validate_exception_admission
        return validate_exception_admission(request)


class WebhookServer:
    """Threaded admission server over the handler chain.

    ``routes()`` exposes the request→response callables directly so tests
    and the in-process latency benchmark can drive the full middleware
    stack without sockets.
    """

    def __init__(self, resource_handlers: ResourceHandlers,
                 policy_handlers: Optional[PolicyHandlers] = None,
                 exception_handlers: Optional[ExceptionHandlers] = None,
                 configuration=None,
                 protection_enabled: Optional[bool] = None,
                 dump: bool = False,
                 host: str = '127.0.0.1', port: int = 9443,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 warmer=None):
        self.resource_handlers = resource_handlers
        self.policy_handlers = policy_handlers or PolicyHandlers()
        self.exception_handlers = exception_handlers or ExceptionHandlers()
        self.configuration = configuration
        self.dump_buffer = DumpBuffer() if dump else None
        self.host = host
        self.port = port
        self.certfile = certfile
        self.keyfile = keyfile
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = False
        # aotcache.warmer.Warmer (or None): /health/warmup reports its
        # state.  Warm-up never gates /health/readiness — the host
        # engine loop serves identical verdicts while compiling.
        self.warmer = warmer
        if protection_enabled is None:
            # env-tier feature toggle (reference: pkg/toggle/toggle.go:21
            # ProtectManagedResources, consumed by handlers/protect.go)
            from ..config.toggle import PROTECT_MANAGED_RESOURCES
            protection_enabled = PROTECT_MANAGED_RESOURCES.enabled()
        self._routes = self._build_routes(protection_enabled)

    # -- handler chain ----------------------------------------------------

    def _chain(self, terminal: Handler, protect: bool) -> Handler:
        h = terminal
        h = with_protection(protect, h)
        h = with_filter(self.configuration, h)
        h = with_dump(self.dump_buffer, h)
        return h

    def _build_routes(self, protect: bool) -> Dict[str, Handler]:
        rh = self.resource_handlers
        routes: Dict[str, Handler] = {}
        for suffix, fp in (('', 'Fail'), ('/fail', 'Fail'),
                           ('/ignore', 'Ignore')):
            routes[f'/validate{suffix}'] = self._chain(
                lambda req, fp=fp: rh.validate(req, fp), protect)
            routes[f'/mutate{suffix}'] = self._chain(
                lambda req, fp=fp: rh.mutate(req, fp), protect)
        routes['/policyvalidate'] = self.policy_handlers.validate
        routes['/policymutate'] = self.policy_handlers.mutate
        routes['/exceptionvalidate'] = self.exception_handlers.validate
        routes['/verifymutate'] = _allow_all
        return routes

    def routes(self) -> Dict[str, Handler]:
        return dict(self._routes)

    def handle(self, path: str, body: bytes) -> bytes:
        """Dispatch one POST body through the route's handler chain
        (the in-process form ``routes()`` consumers and tests use; the
        HTTP layer goes through :meth:`handle_request` for the status
        code)."""
        out, _status = self.handle_request(path, body)
        return out

    @staticmethod
    def _observe_review(operation: str, allowed: str,
                        seconds: float) -> None:
        from ..observability.metrics import (ADMISSION_REQUESTS,
                                             ADMISSION_REVIEW_DURATION,
                                             global_registry)
        registry = global_registry()
        if registry is None:
            return
        registry.observe(ADMISSION_REVIEW_DURATION, seconds,
                         operation=operation, allowed=allowed)
        registry.inc(ADMISSION_REQUESTS, operation=operation,
                     allowed=allowed)

    def handle_request(self, path: str, body: bytes):
        """Dispatch one POST body; returns ``(response bytes, status)``.

        Each request runs under an HTTP-handler span (reference:
        pkg/webhooks/handlers/trace.go:16 WithTrace); engine rule spans
        nest under it via context propagation.

        A body that is not JSON or not an AdmissionReview with a
        ``request`` object gets a structured, uid-echoing denied
        response at HTTP 400 — the API server always receives an
        AdmissionReview it can correlate, never a raw traceback.
        Handler-chain exceptions still propagate (the HTTP layer 500s)
        but are recorded with ``allowed=error`` so shed/error traffic
        is visible on the admission instruments."""
        handler = self._routes.get(path)
        if handler is None:
            raise KeyError(path)
        import time as _time
        from ..observability import tracing
        t0 = _time.monotonic()
        review = None
        try:
            review = json.loads(body)
            request = admission.parse_review(review)
        except Exception as e:  # noqa: BLE001 - malformed input → 400
            uid = ''
            if isinstance(review, dict):
                req = review.get('request')
                if isinstance(req, dict):
                    uid = str(req.get('uid', '') or '')
            self._observe_review('', 'error', _time.monotonic() - t0)
            resp = admission.response(
                uid, False, f'malformed admission review: {e}')
            return (json.dumps(
                admission.review_response({}, resp)).encode('utf-8'), 400)
        operation = request.get('operation', '') or ''
        with tracing.start_span(
                f'webhooks{path}',
                {'uid': request.get('uid', ''),
                 'kind': (request.get('kind') or {}).get('kind', ''),
                 'operation': request.get('operation', '')}) as span:
            try:
                resp = handler(request)
            except Exception:
                self._observe_review(operation, 'error',
                                     _time.monotonic() - t0)
                raise
            span.set_attribute('allowed', resp.get('allowed'))
        self._observe_review(operation,
                             str(bool(resp.get('allowed'))).lower(),
                             _time.monotonic() - t0)
        return (json.dumps(
            admission.review_response(request, resp)).encode('utf-8'), 200)

    def health_status(self):
        """(json body, http status) for the aggregate ``GET /health``:
        readiness + warm-up state + the SLO verdict when the engine is
        on.  The status code tracks readiness ONLY — a degraded SLO is
        a payload-level signal for operators/alerting, never a reason
        for the orchestrator to restart a pod that is still answering
        admission requests (on the host loop if nothing else)."""
        body = {'ready': self._ready}
        w = self.warmer
        if w is not None:
            body['warmup'] = w.state
        from ..observability import slo
        verdict = slo.verdict()
        if verdict is not None:
            body['slo'] = verdict
        return body, 200 if self._ready else 503

    def warmup_status(self):
        """(json body, http status) for /health/warmup."""
        w = self.warmer
        if w is None:
            return {'state': 'disabled'}, 200
        body = {'state': w.state}
        if w.duration_s is not None:
            body['duration_s'] = round(w.duration_s, 3)
        if w.detail:
            body['detail'] = w.detail
        if w.error:
            body['error'] = w.error
        return body, 200 if w.state in ('ready', 'disabled', 'failed') \
            else 503

    # -- http lifecycle ---------------------------------------------------

    def start(self) -> None:
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 - quiet
                pass

            def do_GET(self):  # noqa: N802
                if self.path in ('/health/liveness', '/health/readiness'):
                    ok = self.path == '/health/liveness' or server._ready
                    self.send_response(200 if ok else 503)
                    self.end_headers()
                    self.wfile.write(b'ok' if ok else b'not ready')
                    return
                if self.path == '/health':
                    # aggregate health JSON (readiness + warm-up + SLO
                    # verdict); the byte contracts of /health/liveness
                    # and /health/readiness above stay untouched
                    body, code = server.health_status()
                    payload = json.dumps(body).encode('utf-8')
                    self.send_response(code)
                    self.send_header('Content-Type', 'application/json')
                    self.send_header('Content-Length', str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path == '/health/warmup':
                    # 200 once the warm pass finished (ready), was
                    # disabled, or failed (serving is unaffected: the
                    # host loop covers it); 503 only while in flight —
                    # deployments that want compiled-path latency from
                    # the first request gate rollout on this endpoint
                    body, code = server.warmup_status()
                    payload = json.dumps(body).encode('utf-8')
                    self.send_response(code)
                    self.send_header('Content-Type', 'application/json')
                    self.send_header('Content-Length', str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(404)
                self.end_headers()

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(length)
                try:
                    out, status = server.handle_request(self.path, body)
                except KeyError:
                    self.send_response(404)
                    self.end_headers()
                    return
                except Exception as e:  # noqa: BLE001
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode('utf-8'))
                    return
                self.send_response(status)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        if self.certfile:
            # per-handshake pair pickup (reference: server.go:155-177 reads
            # the certmanager secret per TLS handshake): before each
            # accept, a rotated cert/key pair is reloaded into the live
            # SSLContext, so new handshakes serve the fresh pair without
            # restart.  This covers every client — an SNI callback alone
            # would miss clients that connect by IP and send no SNI.
            outer = self
            state = {'mtime': None}
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)

            def reload_if_rotated():
                import os
                try:
                    mtime = (os.stat(outer.certfile).st_mtime_ns,
                             os.stat(outer.keyfile).st_mtime_ns)
                except OSError:
                    return
                if mtime != state['mtime']:
                    try:
                        ctx.load_cert_chain(outer.certfile, outer.keyfile)
                        state['mtime'] = mtime
                    except Exception:  # noqa: BLE001 - keep old pair
                        if state['mtime'] is None:
                            raise  # first load must succeed

            reload_if_rotated()
            # the listener stays plaintext; each accepted connection is
            # wrapped AFTER the rotation check, so a pair rotated while
            # the server sat idle in accept() is picked up by the very
            # next connection.  The handshake is deferred to the handler
            # thread (do_handshake_on_connect=False) so a slow client
            # cannot stall the accept loop.
            inner_get_request = self._httpd.get_request

            def get_request():
                sock, addr = inner_get_request()
                reload_if_rotated()
                return (ctx.wrap_socket(sock, server_side=True,
                                        do_handshake_on_connect=False),
                        addr)
            self._httpd.get_request = get_request
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        self._ready = True

    def stop(self) -> None:
        self._ready = False
        # drain the admission micro-batcher before tearing the listener
        # down: handler threads blocked on batched futures resolve with
        # real responses instead of timing out mid-shutdown
        shutdown = getattr(self.resource_handlers, 'shutdown', None)
        if shutdown is not None:
            shutdown()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
