"""Self-subject access checks (reference: pkg/auth/auth.go CanIOptions,
pkg/policy/generate/auth.go Auth).

The generate machinery create/update/deletes the resources named in
generate rules using the controller's own service account; before a
generate policy is admitted — and before a background UR applies its
targets — the controller verifies it actually holds those permissions by
creating ``SelfSubjectAccessReview`` objects and reading
``.status.allowed`` (reference: auth.go:57 RunAccessCheck).
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

_VERSION_RE = re.compile(r'^v\d((alpha|beta)\d)?$')

# irregular kind → resource plural forms (the discovery RESTMapper's job
# in the reference; a static table plus naive pluralization suffices for
# the kinds policies generate)
_IRREGULAR_PLURALS = {
    'Endpoints': 'endpoints',
    'NetworkPolicy': 'networkpolicies',
    'PodSecurityPolicy': 'podsecuritypolicies',
    'Ingress': 'ingresses',
    'IngressClass': 'ingressclasses',
    'StorageClass': 'storageclasses',
    'PriorityClass': 'priorityclasses',
    'RuntimeClass': 'runtimeclasses',
    'Gateway': 'gateways',
    'HTTPRoute': 'httproutes',
    'GRPCRoute': 'grpcroutes',
    'ReferenceGrant': 'referencegrants',
    'PodMetrics': 'pods',
    'NodeMetrics': 'nodes',
}


def _pluralize(kind: str) -> str:
    irregular = _IRREGULAR_PLURALS.get(kind)
    if irregular:
        return irregular
    low = kind.lower()
    # English pluralization only turns -y into -ies after a consonant
    # (Policy → policies); vowel + y just appends s (Gateway →
    # gateways) — the old unconditional rule produced 'gatewaies' and
    # SSAR probes against a nonexistent GVR
    if low.endswith('y') and len(low) > 1 and low[-2] not in 'aeiou':
        return low[:-1] + 'ies'
    if low.endswith(('s', 'x', 'z', 'ch', 'sh')):
        return low + 'es'
    return low + 's'


def gvr_from_kind(kind: str) -> Tuple[str, str]:
    """(group, resource-plural) for a policy 'kind' entry, accepting the
    bare ``Kind``, ``version/Kind`` and ``group/version/Kind`` forms
    (reference: auth.go:60 GetGVRFromKind via the discovery REST
    mapper)."""
    parts = [p for p in kind.split('/') if p]
    group = ''
    bare = parts[-1] if parts else ''
    if len(parts) == 2 and not _VERSION_RE.match(parts[0]):
        group = parts[0]
    elif len(parts) == 3:
        group = parts[0]
    return group, _pluralize(bare)


class CanI:
    """reference: pkg/auth/auth.go:30 canIOptions.

    One (kind, namespace, verb, subresource) permission probe; each
    ``run_access_check`` creates a SelfSubjectAccessReview through the
    client and evaluates the response.
    """

    def __init__(self, client, kind: str, namespace: str, verb: str,
                 subresource: str = ''):
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.verb = verb
        self.subresource = subresource

    def run_access_check(self) -> bool:
        """reference: auth.go:57 RunAccessCheck — builds the SSAR spec
        from the resolved GVR and returns ``.status.allowed``."""
        if not self.kind:
            raise ValueError('failed to get GVR for empty kind')
        group, resource = gvr_from_kind(self.kind)
        attrs = {
            'namespace': self.namespace,
            'verb': self.verb,
            'group': group,
            'resource': resource,
            'subresource': self.subresource,
        }
        status = self.client.create_access_review(attrs)
        return bool(status.get('allowed'))


class Auth:
    """reference: pkg/policy/generate/auth.go:24 Auth — the four verbs
    the generate controller needs on target kinds."""

    def __init__(self, client):
        self.client = client

    def _check(self, verb: str, kind: str, namespace: str) -> bool:
        return CanI(self.client, kind, namespace, verb).run_access_check()

    def can_i_create(self, kind: str, namespace: str) -> bool:
        return self._check('create', kind, namespace)

    def can_i_update(self, kind: str, namespace: str) -> bool:
        return self._check('update', kind, namespace)

    def can_i_delete(self, kind: str, namespace: str) -> bool:
        return self._check('delete', kind, namespace)

    def can_i_get(self, kind: str, namespace: str) -> bool:
        return self._check('get', kind, namespace)

    def can_i_list(self, kind: str, namespace: str) -> bool:
        return self._check('list', kind, namespace)


class FakeAuth:
    """Allow-everything Operations for offline/CLI validation
    (reference: pkg/policy/generate/fake/auth.go)."""

    def can_i_create(self, kind: str, namespace: str) -> bool:
        return True

    def can_i_update(self, kind: str, namespace: str) -> bool:
        return True

    def can_i_delete(self, kind: str, namespace: str) -> bool:
        return True

    def can_i_get(self, kind: str, namespace: str) -> bool:
        return True

    def can_i_list(self, kind: str, namespace: str) -> bool:
        return True


def is_variable(s: Optional[str]) -> bool:
    """reference: pkg/engine/variables/variables.go IsVariable — auth
    checks are skipped when kind/namespace contain unresolved
    variables."""
    return bool(s) and '{{' in s


def can_i_generate_error(auth, kind: str, namespace: str) -> Optional[str]:
    """The generate controller's four-verb pre-flight on one target
    kind; returns the reference's error message on the first denied
    verb, else None (reference: pkg/policy/generate/validate.go:130
    canIGenerate).  ``kind`` may carry group/version prefixes — the
    probe resolves them (auth checks skip unresolved variables)."""
    if is_variable(kind) or is_variable(namespace):
        return None
    bare = kind.split('/')[-1]  # the message names the kind as the
    # reference does; the probe itself keeps the group qualifier
    for verb, check in (('create', auth.can_i_create),
                        ('update', auth.can_i_update),
                        ('get', auth.can_i_get),
                        ('delete', auth.can_i_delete)):
        if not check(kind, namespace):
            return (f"kyverno does not have permissions to '{verb}' "
                    f'resource {bare}/{namespace}. Update permissions '
                    f"in ClusterRole 'kyverno:generate'")
    return None
