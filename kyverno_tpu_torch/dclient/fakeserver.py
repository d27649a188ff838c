"""A minimal in-process Kubernetes API server for transport testing.

Wraps a :class:`FakeClient` store behind the REST surface
:class:`HTTPClient` speaks — discovery, CRUD, JSON patch, labelSelector
LIST, streaming WATCH — translating ApiErrors back into apimachinery
``Status`` bodies.  This is the "recorded-response fake server" of the
dclient contract suite: both clients run the same tests, one directly
against the store, one through real HTTP.
"""

from __future__ import annotations

import json
import queue
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .client import (AlreadyExistsError, ApiError, ConflictError,
                     FakeClient, NotFoundError)

_STATUS_CODES = {
    'NotFound': 404,
    'AlreadyExists': 409,
    'Conflict': 409,
    'Forbidden': 403,
    'BadRequest': 400,
}


def _status_body(err: ApiError) -> bytes:
    reason = getattr(err, 'reason', '') or type(err).__name__.replace(
        'Error', '')
    if isinstance(err, ConflictError):
        reason = 'Conflict'
    return json.dumps({
        'kind': 'Status', 'apiVersion': 'v1', 'status': 'Failure',
        'message': str(err), 'reason': reason,
        'code': _STATUS_CODES.get(reason, 500),
    }).encode()


class _Registry:
    """kind↔plural registry; pre-seeded with the kinds the framework
    touches, extensible for tests."""

    def __init__(self):
        self.by_plural: Dict[Tuple[str, str], Tuple[str, bool]] = {}
        for api_version, kind, plural, namespaced in [
            ('v1', 'Pod', 'pods', True),
            ('v1', 'Namespace', 'namespaces', False),
            ('v1', 'ConfigMap', 'configmaps', True),
            ('v1', 'Secret', 'secrets', True),
            ('v1', 'Service', 'services', True),
            ('apps/v1', 'Deployment', 'deployments', True),
            ('networking.k8s.io/v1', 'NetworkPolicy', 'networkpolicies',
             True),
            ('kyverno.io/v1', 'ClusterPolicy', 'clusterpolicies', False),
            ('kyverno.io/v1beta1', 'UpdateRequest', 'updaterequests', True),
            ('wgpolicyk8s.io/v1alpha2', 'PolicyReport', 'policyreports',
             True),
        ]:
            self.register(api_version, kind, plural, namespaced)

    def register(self, api_version: str, kind: str, plural: str,
                 namespaced: bool) -> None:
        self.by_plural[(api_version, plural)] = (kind, namespaced)

    def discovery_doc(self, api_version: str) -> dict:
        resources = []
        for (av, plural), (kind, namespaced) in sorted(
                self.by_plural.items()):
            if av == api_version:
                resources.append({'name': plural, 'kind': kind,
                                  'namespaced': namespaced})
        return {'kind': 'APIResourceList', 'groupVersion': api_version,
                'resources': resources}


class FakeApiServer:
    """`with FakeApiServer() as srv:` — srv.url points at a live server
    backed by ``srv.store`` (a FakeClient)."""

    def __init__(self, store: Optional[FakeClient] = None):
        self.store = store or FakeClient()
        self.registry = _Registry()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'

            def log_message(self, *a):  # noqa: D102 - quiet
                pass

            def _send(self, code: int, body: bytes,
                      content_type='application/json'):
                self.send_response(code)
                self.send_header('Content-Type', content_type)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fail(self, err: ApiError):
                reason = 'Conflict' if isinstance(err, ConflictError) else \
                    getattr(err, 'reason', 'InternalError')
                self._send(_STATUS_CODES.get(reason, 500),
                           _status_body(err))

            def _route(self):
                split = urlsplit(self.path)
                q = {k: v[0] for k, v in parse_qs(split.query).items()}
                return split.path, q

            def do_GET(self):  # noqa: N802
                path, q = self._route()
                try:
                    m = re.fullmatch(r'/api/(v1)|/apis/([^/]+/[^/]+)', path)
                    if m:
                        av = m.group(1) or m.group(2)
                        self._send(200, json.dumps(
                            outer.registry.discovery_doc(av)).encode())
                        return
                    parsed = outer._parse(path)
                    if parsed is None:
                        raise NotFoundError(f'path {path!r} not found')
                    av, kind, ns, name = parsed
                    if q.get('watch') == 'true':
                        self._watch(av, kind, ns)
                        return
                    if name:
                        obj = outer.store.get_resource(av, kind, ns, name)
                        self._send(200, json.dumps(obj).encode())
                        return
                    selector = _selector_from_query(
                        q.get('labelSelector', ''))
                    items = outer.store.list_resource(av, kind, ns,
                                                      selector)
                    self._send(200, json.dumps({
                        'kind': f'{kind}List', 'apiVersion': av,
                        'items': items}).encode())
                except ApiError as e:
                    self._fail(e)

            def _watch(self, av, kind, ns):
                events: 'queue.Queue' = queue.Queue()

                def hook(ev_type, obj):
                    if kind and obj.get('kind') != kind:
                        return
                    if ns and (obj.get('metadata') or {}).get(
                            'namespace', '') != ns:
                        return
                    events.put((ev_type, obj))
                outer.store.watch(hook)
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Transfer-Encoding', 'chunked')
                self.end_headers()
                try:
                    while True:
                        ev_type, obj = events.get(timeout=10)
                        line = json.dumps(
                            {'type': ev_type, 'object': obj}).encode() + \
                            b'\n'
                        self.wfile.write(
                            f'{len(line):x}\r\n'.encode() + line + b'\r\n')
                        self.wfile.flush()
                except (queue.Empty, OSError):
                    try:
                        self.wfile.write(b'0\r\n\r\n')
                    except OSError:
                        pass

            def _read_body(self) -> bytes:
                n = int(self.headers.get('Content-Length') or 0)
                return self.rfile.read(n)

            def do_POST(self):  # noqa: N802
                path, q = self._route()
                if path == ('/apis/authorization.k8s.io/v1/'
                            'selfsubjectaccessreviews'):
                    # SSARs are ephemeral: evaluated, never stored
                    # (reference: authorization/v1 SelfSubjectAccessReview)
                    ssar = json.loads(self._read_body())
                    attrs = ((ssar.get('spec') or {})
                             .get('resourceAttributes') or {})
                    status = outer.store.create_access_review(attrs)
                    ssar['status'] = status
                    self._send(201, json.dumps(ssar).encode())
                    return
                try:
                    parsed = outer._parse(path)
                    if parsed is None:
                        raise NotFoundError(f'path {path!r} not found')
                    av, kind, ns, _ = parsed
                    obj = json.loads(self._read_body())
                    out = outer.store.create_resource(
                        av, kind, ns, obj, dry_run=q.get('dryRun') == 'All')
                    self._send(201, json.dumps(out).encode())
                except ApiError as e:
                    self._fail(e)

            def do_PUT(self):  # noqa: N802
                path, q = self._route()
                try:
                    parsed = outer._parse(path)
                    if parsed is None:
                        raise NotFoundError(f'path {path!r} not found')
                    av, kind, ns, name = parsed
                    obj = json.loads(self._read_body())
                    out = outer.store.update_resource(
                        av, kind, ns, obj, dry_run=q.get('dryRun') == 'All')
                    self._send(200, json.dumps(out).encode())
                except ApiError as e:
                    self._fail(e)

            def do_PATCH(self):  # noqa: N802
                path, _q = self._route()
                try:
                    parsed = outer._parse(path)
                    if parsed is None:
                        raise NotFoundError(f'path {path!r} not found')
                    av, kind, ns, name = parsed
                    from ..engine.mutate.jsonpatch import apply_patch
                    current = outer.store.get_resource(av, kind, ns, name)
                    patched = apply_patch(
                        current, json.loads(self._read_body()))
                    out = outer.store.update_resource(av, kind, ns, patched)
                    self._send(200, json.dumps(out).encode())
                except ApiError as e:
                    self._fail(e)

            def do_DELETE(self):  # noqa: N802
                path, q = self._route()
                try:
                    parsed = outer._parse(path)
                    if parsed is None:
                        raise NotFoundError(f'path {path!r} not found')
                    av, kind, ns, name = parsed
                    outer.store.delete_resource(
                        av, kind, ns, name,
                        dry_run=q.get('dryRun') == 'All')
                    self._send(200, json.dumps({
                        'kind': 'Status', 'status': 'Success'}).encode())
                except ApiError as e:
                    self._fail(e)

        self._server = ThreadingHTTPServer(('127.0.0.1', 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name='fake-apiserver')

    def _parse(self, path: str
               ) -> Optional[Tuple[str, str, str, str]]:
        """(api_version, kind, namespace, name) from a REST path."""
        m = re.fullmatch(
            r'/(?:api/(?P<core>v1)|apis/(?P<group>[^/]+/[^/]+))'
            r'(?:/namespaces/(?P<ns>[^/]+))?'
            r'/(?P<plural>[^/?]+)'
            r'(?:/(?P<name>[^/?]+))?'
            r'(?:/status)?', path)
        if not m:
            return None
        av = m.group('core') or m.group('group')
        plural = m.group('plural')
        info = self.registry.by_plural.get((av, plural))
        if info is None:
            return None
        kind, _namespaced = info
        return av, kind, m.group('ns') or '', m.group('name') or ''

    @property
    def url(self) -> str:
        host, port = self._server.server_address
        return f'http://{host}:{port}'

    def __enter__(self) -> 'FakeApiServer':
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()


def _selector_from_query(sel: str) -> Optional[dict]:
    """labelSelector query string → selector dict (the k=v and
    expression forms HTTPClient emits)."""
    if not sel:
        return None
    match_labels: Dict[str, str] = {}
    exprs = []
    for raw in re.split(r',(?![^(]*\))', sel):
        part = raw.strip()
        if not part:
            continue
        m = re.fullmatch(r'(\S+)\s+(in|notin)\s+\(([^)]*)\)', part)
        if m:
            exprs.append({'key': m.group(1),
                          'operator': 'In' if m.group(2) == 'in'
                          else 'NotIn',
                          'values': [v.strip()
                                     for v in m.group(3).split(',')]})
            continue
        if part.startswith('!'):
            exprs.append({'key': part[1:], 'operator': 'DoesNotExist'})
            continue
        if '=' in part:
            k, v = part.split('=', 1)
            match_labels[k.strip()] = v.strip().lstrip('=')
            continue
        exprs.append({'key': part, 'operator': 'Exists'})
    out: dict = {}
    if match_labels:
        out['matchLabels'] = match_labels
    if exprs:
        out['matchExpressions'] = exprs
    return out or None
