"""Schema validation of mutated resources.

Mirrors the reference's openapi manager (reference:
pkg/openapi/manager.go:60 NewManager, :88 ValidateResource, :120
ValidatePolicyMutation): mutated resources are validated before the
patches are admitted, and policy mutations are dry-run against a
skeleton resource so broken overlays are rejected at policy admission.

Schemas: the reference syncs cluster OpenAPI documents and falls back to
a baked-in snapshot (pkg/openapi/data/apiResources.go); here a built-in
structural schema covers the core kinds' spines (typed metadata, typed
well-known fields), extended at runtime via ``add_schema`` — unknown
fields are tolerated exactly like Kubernetes does for unstructured
content.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ValidationError(Exception):
    pass


# structural spine: field path → expected type ('object', 'array',
# 'string', 'integer', 'boolean', 'string-map')
_COMMON = {
    'metadata': 'object',
    'metadata.name': 'string',
    'metadata.namespace': 'string',
    'metadata.labels': 'string-map',
    'metadata.annotations': 'string-map',
    'metadata.finalizers': 'array',
    'spec': 'object',
}

_BUILTIN_SCHEMAS: Dict[str, Dict[str, str]] = {
    'Pod': {
        **_COMMON,
        'spec.containers': 'array',
        'spec.initContainers': 'array',
        'spec.ephemeralContainers': 'array',
        'spec.volumes': 'array',
        'spec.hostNetwork': 'boolean',
        'spec.hostPID': 'boolean',
        'spec.hostIPC': 'boolean',
        'spec.serviceAccountName': 'string',
        'spec.nodeSelector': 'string-map',
    },
    'Deployment': {
        **_COMMON,
        'spec.replicas': 'integer',
        'spec.selector': 'object',
        'spec.template': 'object',
        'spec.template.spec.containers': 'array',
    },
    'StatefulSet': {**_COMMON, 'spec.replicas': 'integer',
                    'spec.template': 'object'},
    'DaemonSet': {**_COMMON, 'spec.template': 'object'},
    'Job': {**_COMMON, 'spec.template': 'object'},
    'CronJob': {**_COMMON, 'spec.schedule': 'string',
                'spec.jobTemplate': 'object'},
    'Service': {**_COMMON, 'spec.ports': 'array',
                'spec.selector': 'string-map', 'spec.type': 'string'},
    'ConfigMap': {'metadata': 'object', 'metadata.name': 'string',
                  'metadata.labels': 'string-map', 'data': 'string-map'},
    'Namespace': {'metadata': 'object', 'metadata.name': 'string',
                  'metadata.labels': 'string-map'},
    'NetworkPolicy': {**_COMMON, 'spec.podSelector': 'object'},
    'ResourceQuota': {**_COMMON, 'spec.hard': 'object'},
    'LimitRange': {**_COMMON, 'spec.limits': 'array'},
}


def _type_ok(value: Any, expected: str) -> bool:
    if expected == 'object':
        return isinstance(value, dict)
    if expected == 'array':
        return isinstance(value, list)
    if expected == 'string':
        return isinstance(value, str)
    if expected == 'integer':
        return isinstance(value, int) and not isinstance(value, bool)
    if expected == 'boolean':
        return isinstance(value, bool)
    if expected == 'string-map':
        return isinstance(value, dict) and all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in value.items())
    return True


class Manager:
    """reference: pkg/openapi/manager.go:60"""

    def __init__(self):
        self._schemas: Dict[str, Dict[str, str]] = dict(_BUILTIN_SCHEMAS)
        # CRD-synced tier keyed by (group, kind): same-kind CRDs in
        # different groups must not collide, and a re-synced CRD replaces
        # its prior schema (no stale field types)
        self._crd_schemas: Dict[tuple, Dict[str, str]] = {}

    def add_schema(self, kind: str, fields: Dict[str, str]) -> None:
        """Extend/override the schema for a kind."""
        self._schemas.setdefault(kind, {}).update(fields)

    def replace_crd_schemas(self,
                            schemas: Dict[tuple, Dict[str, str]]) -> None:
        """Swap in the freshly synced CRD schema set (the reference's
        periodic sync semantics — deleted/retyped CRDs leave no residue;
        pkg/controllers/openapi/controller.go:148)."""
        self._crd_schemas = dict(schemas)

    def validate_resource(self, resource: dict,
                          kind: Optional[str] = None) -> None:
        """Raises ValidationError on structural violations
        (reference: manager.go:88 ValidateResource)."""
        if not isinstance(resource, dict):
            raise ValidationError('resource must be an object')
        kind = kind or resource.get('kind', '')
        api_version = resource.get('apiVersion', '') \
            if isinstance(resource.get('apiVersion'), str) else ''
        group = api_version.split('/')[0] if '/' in api_version else ''
        schema = self._crd_schemas.get((group, kind))
        if schema is None and group == '':
            # resources often omit apiVersion in fixtures: a kind-unique
            # CRD schema still applies
            hits = [s for (g, k), s in self._crd_schemas.items()
                    if k == kind]
            if len(hits) == 1:
                schema = hits[0]
        if schema is None:
            schema = self._schemas.get(kind)
        if schema is None:
            return  # unknown kinds are not schema-validated
        for path, expected in schema.items():
            value = _walk(resource, path)
            if value is _MISSING or value is None:
                continue
            if not _type_ok(value, expected):
                raise ValidationError(
                    f'ValidationError(io.k8s.api {kind}.{path}): invalid '
                    f'type for {path}: expected {expected}, got '
                    f'{type(value).__name__}')

    def validate_policy_mutation(self, policy) -> None:
        """Dry-run each mutate rule's overlay against a skeleton of its
        matched kinds (reference: manager.go:120 ValidatePolicyMutation)."""
        from ..api.policy import Policy, Rule
        from ..engine.api import PolicyContext
        from ..engine.engine import Engine
        if not isinstance(policy, Policy):
            policy = Policy(policy)
        engine = Engine()
        for rule in policy.rules:
            if not rule.has_mutate():
                continue
            match = rule.raw.get('match') or {}
            kinds: List[str] = []
            for f in [match] + (match.get('any') or []) + \
                    (match.get('all') or []):
                kinds += [str(k).split('/')[-1] for k in
                          (f.get('resources') or {}).get('kinds') or []]
            for kind in kinds:
                if kind not in self._schemas:
                    continue
                skeleton = {'apiVersion': 'v1', 'kind': kind,
                            'metadata': {'name': 'dry-run',
                                         'namespace': 'default'},
                            'spec': {}}
                try:
                    resp = engine.mutate(PolicyContext(
                        policy, new_resource=skeleton))
                except Exception as e:  # noqa: BLE001
                    raise ValidationError(
                        f'mutation dry-run failed for rule '
                        f'{rule.name}/{kind}: {e}')
                patched = resp.patched_resource or skeleton
                self.validate_resource(patched, kind)


_MISSING = object()


def _walk(doc: dict, dotted: str):
    cur: Any = doc
    for part in dotted.split('.'):
        if not isinstance(cur, dict) or part not in cur:
            return _MISSING
        cur = cur[part]
    return cur
