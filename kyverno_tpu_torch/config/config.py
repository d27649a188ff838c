"""Hot-reloadable configuration (reference: pkg/config/config.go).

Loaded from the ``kyverno`` ConfigMap: resource filters, excluded
usernames/group-roles, default registry, webhook namespace selectors,
success-event generation. The config controller re-``load``s on every
ConfigMap change.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from ..utils.wildcard import match as wildcard_match

KYVERNO_NAMESPACE = 'kyverno'
KYVERNO_CONFIGMAP_NAME = 'kyverno'

# reference: pkg/config/config.go:34 defaultExcludeGroupRole
DEFAULT_EXCLUDE_GROUP_ROLE = ['system:serviceaccounts:kube-system',
                              'system:nodes', 'system:kube-scheduler']

_FILTER_RE = re.compile(r'\[([^\[\]]*)\]')
_DNS_RE = re.compile(
    r'^([a-zA-Z0-9]([a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?\.)*'
    r'[a-zA-Z0-9]([a-zA-Z0-9\-]{0,61}[a-zA-Z0-9])?(:[0-9]+)?$')


class _Filter:
    """One [kind,namespace,name] exclusion (reference: config.go filter)."""

    __slots__ = ('kind', 'namespace', 'name')

    def __init__(self, kind: str, namespace: str, name: str):
        self.kind = kind
        self.namespace = namespace
        self.name = name


def _parse_kinds(text: str) -> List[_Filter]:
    """reference: pkg/config/filter.go parseKinds"""
    out = []
    for m in _FILTER_RE.finditer(text or ''):
        elements = [e.strip() for e in m.group(1).split(',')]
        while len(elements) < 3:
            elements.append('')
        kind, namespace, name = elements[0], elements[1], elements[2]
        if not kind:
            continue
        out.append(_Filter(kind or '*', namespace or '*', name or '*'))
    return out


def _parse_rbac(text: str) -> List[str]:
    return [s.strip() for s in (text or '').split(',') if s.strip()]


class Configuration:
    """reference: pkg/config/config.go:133 Configuration"""

    def __init__(self):
        self._lock = threading.RLock()
        self._filters: List[_Filter] = []
        self._default_registry = 'docker.io'
        self._enable_default_registry_mutation = True
        self._exclude_group_role = list(DEFAULT_EXCLUDE_GROUP_ROLE)
        self._exclude_username: List[str] = []
        self._generate_success_events = False
        self._webhooks: List[dict] = []

    # -- reads ---------------------------------------------------------------

    def to_filter(self, kind: str, namespace: str, name: str) -> bool:
        """True when the resource is excluded by resourceFilters
        (reference: config.go:186 ToFilter)."""
        with self._lock:
            for f in self._filters:
                if wildcard_match(f.kind, kind) and \
                        wildcard_match(f.namespace, namespace) and \
                        wildcard_match(f.name, name):
                    return True
            # reference: config.go — kyverno's own namespace is always
            # filtered via the default resourceFilters entry
            return False

    def get_exclude_group_role(self) -> List[str]:
        with self._lock:
            return list(self._exclude_group_role)

    def get_exclude_username(self) -> List[str]:
        with self._lock:
            return list(self._exclude_username)

    def get_default_registry(self) -> str:
        with self._lock:
            return self._default_registry

    def get_enable_default_registry_mutation(self) -> bool:
        with self._lock:
            return self._enable_default_registry_mutation

    def get_generate_success_events(self) -> bool:
        with self._lock:
            return self._generate_success_events

    def get_webhooks(self) -> List[dict]:
        with self._lock:
            return list(self._webhooks)

    # -- load ----------------------------------------------------------------

    def load(self, configmap: Optional[dict]) -> None:
        """reference: config.go:259 load — resets then applies Data."""
        data: Dict[str, str] = ((configmap or {}).get('data') or {})
        with self._lock:
            self._filters = _parse_kinds(data.get('resourceFilters', ''))
            self._exclude_group_role = (
                _parse_rbac(data.get('excludeGroupRole', '')) +
                list(DEFAULT_EXCLUDE_GROUP_ROLE))
            self._exclude_username = _parse_rbac(
                data.get('excludeUsername', ''))
            self._generate_success_events = \
                data.get('generateSuccessEvents', '').lower() == 'true'
            # reset to defaults first so removed/invalid keys revert
            # (reference: pkg/config/config.go load)
            self._default_registry = 'docker.io'
            registry = data.get('defaultRegistry')
            if registry and _DNS_RE.match(registry):
                self._default_registry = registry
            self._enable_default_registry_mutation = True
            mutation = data.get('enableDefaultRegistryMutation')
            if mutation is not None:
                if mutation.lower() in ('true', 'false'):
                    self._enable_default_registry_mutation = \
                        mutation.lower() == 'true'
            webhooks = data.get('webhooks')
            self._webhooks = []
            if webhooks:
                import json
                try:
                    parsed = json.loads(webhooks)
                    if isinstance(parsed, list):
                        self._webhooks = parsed
                except ValueError:
                    pass


class ConfigController:
    """Watches the kyverno ConfigMap in a dclient store and hot-reloads
    the Configuration (reference: pkg/controllers/config/controller.go)."""

    def __init__(self, client, configuration: Configuration):
        self.client = client
        self.configuration = configuration
        client.watch(self._on_event)
        self.reconcile()

    def reconcile(self) -> None:
        from ..dclient.client import NotFoundError
        try:
            cm = self.client.get_resource(
                'v1', 'ConfigMap', KYVERNO_NAMESPACE, KYVERNO_CONFIGMAP_NAME)
        except NotFoundError:
            cm = None
        self.configuration.load(cm)

    def _on_event(self, event: str, resource: dict) -> None:
        meta = resource.get('metadata') or {}
        if resource.get('kind') == 'ConfigMap' and \
                meta.get('name') == KYVERNO_CONFIGMAP_NAME and \
                meta.get('namespace') == KYVERNO_NAMESPACE:
            if event == 'DELETED':
                self.configuration.load(None)
            else:
                self.configuration.load(resource)
