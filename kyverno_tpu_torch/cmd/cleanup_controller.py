"""Cleanup-controller daemon (reference: cmd/cleanup-controller/main.go):
reconciles a CronJob CR per CleanupPolicy and serves the ``/cleanup``
HTTP endpoint the CronJobs call back (reference:
cmd/cleanup-controller/handlers/cleanup/handlers.go); the in-process
cron tick additionally runs due policies directly so deletions happen
even without an external job runner."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from ..controllers.cleanup import (CleanupController,
                                   validate_cleanup_admission)
from ..controllers.leaderelection import mesh_is_leader
from .internal import Setup, base_parser


class CleanupHTTPServer:
    """Serves GET /cleanup?policy=<ns/name>
    (reference: cmd/cleanup-controller/handlers/cleanup) and POST
    /validate — CleanupPolicy admission with the delete/list permission
    pre-flight (reference: cmd/cleanup-controller/handlers/admission/
    policy.go + pkg/validation/cleanuppolicy/validate.go)."""

    def __init__(self, controller: CleanupController, port: int = 0,
                 host: str = '', certfile: Optional[str] = None,
                 keyfile: Optional[str] = None):
        # default bind is all interfaces: the CronJobs this controller
        # reconciles call back via the cluster Service address, which a
        # localhost-only listener could never serve
        self.controller = controller
        self.host = host
        self.port = port
        self.certfile = certfile
        self.keyfile = keyfile
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def scheme(self) -> str:
        return 'https' if self.certfile else 'http'

    def start(self) -> int:
        controller = self.controller

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 - quiet
                pass

            def do_POST(self):  # noqa: N802
                import json
                if urlparse(self.path).path != '/validate':
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get('Content-Length') or 0)
                review = json.loads(self.rfile.read(n) or b'{}')
                request = review.get('request') or {}
                resp = validate_cleanup_admission(request,
                                                  controller.client)
                body = json.dumps({
                    'apiVersion': 'admission.k8s.io/v1',
                    'kind': 'AdmissionReview',
                    'response': resp}).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                if parsed.path != CleanupController.CLEANUP_SERVICE_PATH:
                    self.send_response(404)
                    self.end_headers()
                    return
                policy = parse_qs(parsed.query).get('policy', [''])[0]
                try:
                    deleted = controller.handle_cleanup_request(policy)
                except KeyError:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = f'cleaned {len(deleted)} resources\n'.encode()
                self.send_response(200)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        if self.certfile:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.certfile, self.keyfile)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name='ktpu-cleanup', daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class CleanupDaemon:
    def __init__(self, setup: Setup, http_port: int = 0,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None):
        self.setup = setup
        self.controller = CleanupController(setup.client)
        self.server = CleanupHTTPServer(self.controller, http_port,
                                        certfile=certfile, keyfile=keyfile)

    def sync_policies(self) -> None:
        seen = set()
        all_listed = True
        for kind in ('ClusterCleanupPolicy', 'CleanupPolicy'):
            try:
                for doc in self.setup.client.list_resource(
                        'kyverno.io/v2alpha1', kind, '', None):
                    self.controller.set_policy(doc)
                    seen.add(CleanupController._key(doc))
            except Exception:  # noqa: BLE001
                # a transient list failure must NOT cascade into pruning
                # (and hence CronJob deletion) of this kind's policies
                all_listed = False
        if all_listed:
            self.controller.retain_policies(seen)

    def tick(self) -> None:
        if not mesh_is_leader():
            return
        self.sync_policies()
        # the callback URL's scheme must match how the server actually
        # serves, or every reconciled CronJob would fail its curl forever
        ns = self.setup.options.namespace
        self.controller.reconcile_cronjobs(
            ns, service=f'{self.server.scheme}://cleanup-controller.'
                        f'{ns}.svc')
        self.controller.tick()

    def run(self) -> None:
        self.server.start()
        self.setup.install_signal_handlers()
        self.setup.run_until_stopped(self.tick, interval=10.0)
        self.server.stop()


def main(args: Optional[List[str]] = None) -> int:
    setup = Setup('kyverno-cleanup-controller', args,
                  base_parser('kyverno-cleanup-controller'))
    CleanupDaemon(setup).run()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
