"""In-memory dynamic client (reference: pkg/clients/dclient/client.go:22,
fake.go).

Resources are stored unstructured, keyed by (apiVersion, kind, namespace,
name). Namespaces are themselves resources (v1/Namespace) so namespace
label lookups go through the same store. The client maintains
``resourceVersion`` counters the way the API server does, which the
generate controller's synchronize semantics depend on.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..engine.match import check_selector


class ApiError(Exception):
    """Base API error (reference: k8s.io/apimachinery apierrors)."""

    reason = 'InternalError'


class NotFoundError(ApiError):
    reason = 'NotFound'


class ConflictError(ApiError):
    """Optimistic-concurrency failure: stale resourceVersion
    (HTTP 409 from a real API server)."""


class AlreadyExistsError(ApiError):
    reason = 'AlreadyExists'


Key = Tuple[str, str, str, str]


def _key(api_version: str, kind: str, namespace: str, name: str) -> Key:
    return (api_version or '', kind or '', namespace or '', name or '')


class FakeClient:
    """In-memory dclient.Interface (reference: pkg/clients/dclient/fake.go).

    Thread-safe: controllers run in worker threads the way the reference's
    workqueue workers do.
    """

    def __init__(self):
        self._store: Dict[Key, dict] = {}
        self._rv = 0
        self._lock = threading.RLock()
        # subscribers get (event_type, resource) for informer-style wiring
        self._watchers: List[Callable[[str, dict], None]] = []
        # SelfSubjectAccessReview policy: attrs -> (allowed, reason).
        # Defaults to allow-all, matching a kyverno install with the
        # shipped aggregated ClusterRoles in place.
        self.access_review_hook: Optional[
            Callable[[dict], Tuple[bool, str]]] = None

    # -- access review -------------------------------------------------------

    def create_access_review(self, attrs: dict) -> dict:
        """Create a SelfSubjectAccessReview; returns its status dict
        (reference: authorizationv1 SelfSubjectAccessReviews().Create,
        used by pkg/auth/auth.go:90)."""
        hook = self.access_review_hook
        if hook is None:
            return {'allowed': True}
        allowed, reason = hook(attrs)
        return {'allowed': bool(allowed), 'reason': reason}

    # -- watch ---------------------------------------------------------------

    def watch(self, fn: Callable[[str, dict], None]) -> None:
        """Register an informer-style event callback ('ADDED'/'MODIFIED'/
        'DELETED', resource)."""
        with self._lock:
            self._watchers.append(fn)

    def _notify(self, event: str, resource: dict) -> None:
        for fn in list(self._watchers):
            fn(event, copy.deepcopy(resource))

    # -- core verbs ----------------------------------------------------------

    def get_resource(self, api_version: str, kind: str, namespace: str,
                     name: str, subresource: str = '') -> dict:
        """reference: dclient.GetResource"""
        with self._lock:
            obj = self._store.get(_key(api_version, kind, namespace, name))
            if obj is None:
                obj = self._lookup_any_version(api_version, kind, namespace, name)
            if obj is None:
                raise NotFoundError(
                    f'{kind} "{namespace + "/" if namespace else ""}{name}" not found')
            if subresource:
                sub = obj.get(subresource)
                return copy.deepcopy(sub) if sub is not None else {}
            return copy.deepcopy(obj)

    def _lookup_any_version(self, api_version: str, kind: str,
                            namespace: str, name: str) -> Optional[dict]:
        # discovery fallback: empty apiVersion matches any stored version
        if api_version:
            return None
        for (av, k, ns, n), obj in self._store.items():
            if k == kind and ns == (namespace or '') and n == name:
                return obj
        return None

    def create_resource(self, api_version: str, kind: str, namespace: str,
                        resource: dict, dry_run: bool = False) -> dict:
        """reference: dclient.CreateResource"""
        obj = copy.deepcopy(resource)
        meta = obj.setdefault('metadata', {})
        name = meta.get('name', '')
        ns = meta.get('namespace', namespace or '')
        if namespace and not meta.get('namespace') and kind != 'Namespace':
            meta['namespace'] = namespace
            ns = namespace
        obj.setdefault('apiVersion', api_version)
        obj.setdefault('kind', kind)
        if obj['kind'] == 'Namespace':
            # the API server stamps this immutable label on every
            # namespace (k8s NamespaceDefaultLabelName); policies rely
            # on it for namespaceSelector matching
            meta.setdefault('labels', {}).setdefault(
                'kubernetes.io/metadata.name', name)
        if obj['kind'] == 'Secret' and obj.get('stringData'):
            # the API server folds stringData into base64 data on write
            import base64 as _b64
            data = obj.setdefault('data', {})
            for k, v in obj.pop('stringData').items():
                data[k] = _b64.b64encode(str(v).encode()).decode()
        key = _key(obj['apiVersion'], obj['kind'], ns if kind != 'Namespace' else '', name)
        with self._lock:
            if key in self._store:
                raise AlreadyExistsError(f'{kind} "{name}" already exists')
            if dry_run:
                return obj
            self._rv += 1
            meta['resourceVersion'] = str(self._rv)
            # the API server assigns the uid on create
            meta.setdefault('uid', f'uid-{self._rv}')
            self._store[key] = obj
            out = copy.deepcopy(obj)
        self._notify('ADDED', obj)
        return out

    def update_resource(self, api_version: str, kind: str, namespace: str,
                        resource: dict, dry_run: bool = False,
                        subresource: str = '') -> dict:
        """reference: dclient.UpdateResource / UpdateStatusResource"""
        obj = copy.deepcopy(resource)
        meta = obj.setdefault('metadata', {})
        name = meta.get('name', '')
        ns = namespace if kind != 'Namespace' else ''
        key = _key(api_version or obj.get('apiVersion', ''),
                   kind or obj.get('kind', ''), ns or meta.get('namespace', ''), name)
        with self._lock:
            if key not in self._store:
                raise NotFoundError(f'{kind} "{name}" not found')
            # optimistic concurrency: an update carrying a stale
            # resourceVersion is rejected like a real API server's 409
            sent_rv = meta.get('resourceVersion')
            stored_rv = (self._store[key].get('metadata') or {}).get(
                'resourceVersion')
            if sent_rv is not None and stored_rv is not None and \
                    sent_rv != stored_rv:
                raise ConflictError(
                    f'{kind} "{name}": resourceVersion conflict '
                    f'(sent {sent_rv}, current {stored_rv})')
            if dry_run:
                return obj
            self._rv += 1
            meta['resourceVersion'] = str(self._rv)
            obj.setdefault('apiVersion', api_version)
            obj.setdefault('kind', kind)
            self._store[key] = obj
            out = copy.deepcopy(obj)
        self._notify('MODIFIED', obj)
        return out

    def update_status_resource(self, api_version: str, kind: str,
                               namespace: str, resource: dict,
                               dry_run: bool = False) -> dict:
        return self.update_resource(api_version, kind, namespace, resource,
                                    dry_run, subresource='status')

    def delete_resource(self, api_version: str, kind: str, namespace: str,
                        name: str, dry_run: bool = False) -> None:
        """reference: dclient.DeleteResource"""
        with self._lock:
            key = _key(api_version, kind, namespace if kind != 'Namespace' else '', name)
            obj = self._store.get(key)
            if obj is None and not api_version:
                obj = self._lookup_any_version('', kind, namespace, name)
                if obj is not None:
                    key = _key(obj.get('apiVersion', ''), kind,
                               namespace if kind != 'Namespace' else '', name)
            if obj is None:
                raise NotFoundError(f'{kind} "{name}" not found')
            if dry_run:
                return
            del self._store[key]
        self._notify('DELETED', obj)

    def list_resource(self, api_version: str, kind: str, namespace: str = '',
                      selector: Optional[dict] = None) -> List[dict]:
        """reference: dclient.ListResource (label selector honored)."""
        out = []
        with self._lock:
            items = list(self._store.values())
        for obj in items:
            if kind and obj.get('kind') != kind:
                continue
            if api_version and obj.get('apiVersion') != api_version:
                continue
            meta = obj.get('metadata') or {}
            if namespace and meta.get('namespace', '') != namespace:
                continue
            if selector is not None:
                labels = {str(k): str(v)
                          for k, v in (meta.get('labels') or {}).items()}
                if not check_selector(selector, labels):
                    continue
            out.append(copy.deepcopy(obj))
        out.sort(key=lambda o: ((o.get('metadata') or {}).get('namespace', ''),
                                (o.get('metadata') or {}).get('name', '')))
        return out

    # -- raw REST access -----------------------------------------------------

    def raw_abs_path(self, path: str) -> bytes:
        """Serve a GET of a Kubernetes REST path from the store — the
        fake analogue of dclient.RawAbsPath (client.go:22), which the
        engine's APICall context entries use."""
        import json
        import re
        from urllib.parse import parse_qs, urlsplit
        split = urlsplit(path)
        p = split.path
        m = re.fullmatch(
            r'/(?:api/(?P<core>v1)|apis/(?P<group>[^/]+/[^/]+))'
            r'(?:/namespaces/(?P<ns>[^/]+))?'
            r'/(?P<plural>[^/?]+)'
            r'(?:/(?P<name>[^/?]+))?', p)
        if not m:
            raise NotFoundError(f'path {path!r} not found')
        av = m.group('core') or m.group('group')
        kind = self._kind_for_plural(m.group('plural'))
        if kind is None:
            raise NotFoundError(f'resource {m.group("plural")!r} unknown')
        ns = m.group('ns') or ''
        name = m.group('name') or ''
        if name:
            obj = self.get_resource(av, kind, ns, name)
            return json.dumps(obj).encode()
        selector = None
        sel = {k: v[0] for k, v in parse_qs(split.query).items()}.get(
            'labelSelector', '')
        if sel:
            from .fakeserver import _selector_from_query
            selector = _selector_from_query(sel)
        items = self.list_resource(av, kind, ns, selector)
        return json.dumps({'kind': f'{kind}List', 'apiVersion': av,
                           'items': items}).encode()

    _WELL_KNOWN_PLURALS = {
        'pods': 'Pod', 'namespaces': 'Namespace',
        'configmaps': 'ConfigMap', 'secrets': 'Secret',
        'services': 'Service', 'deployments': 'Deployment',
        'networkpolicies': 'NetworkPolicy',
        'clusterpolicies': 'ClusterPolicy', 'policies': 'Policy',
        'updaterequests': 'UpdateRequest',
        'policyreports': 'PolicyReport',
        'clusterpolicyreports': 'ClusterPolicyReport',
    }

    def _kind_for_plural(self, plural: str) -> Optional[str]:
        kind = self._WELL_KNOWN_PLURALS.get(plural)
        if kind:
            return kind
        # fall back to naive pluralization over stored kinds
        with self._lock:
            kinds = {k for (_av, k, _ns, _n) in self._store}
        for k in kinds:
            low = k.lower()
            if plural in (low + 's', low + 'es',
                          low[:-1] + 'ies' if low.endswith('y') else ''):
                return k
        return None

    # -- namespace helpers ---------------------------------------------------

    def get_namespace_labels(self, namespace: str) -> Dict[str, str]:
        """Namespace labels for match-time `namespaceSelector` evaluation
        (reference: pkg/utils/kube GetNamespaceSelectorsFromNamespaceLister)."""
        try:
            ns = self.get_resource('v1', 'Namespace', '', namespace)
        except NotFoundError:
            return {}
        labels = (ns.get('metadata') or {}).get('labels') or {}
        return {str(k): str(v) for k, v in labels.items()}
