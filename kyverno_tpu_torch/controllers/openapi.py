"""OpenAPI schema sync controller.

Mirrors the reference's periodic schema ingestion (reference:
pkg/controllers/openapi/controller.go:148 — the controller polls the
cluster's OpenAPI document and CRDs, feeding pkg/openapi.Manager).  Here
the cluster source is the dynamic client: every
``CustomResourceDefinition`` in the cluster has its structural
``openAPIV3Schema`` converted to the manager's dotted path→type form, so
mutations of CRD instances are schema-checked exactly like core kinds.
The built-in core snapshot (openapi/manager.py) is the fallback tier,
matching the reference's baked-in ``data/apiResources.go``.
"""

from __future__ import annotations

from typing import Any, Dict

from ..openapi.manager import Manager

_TYPE_MAP = {'object': 'object', 'array': 'array', 'string': 'string',
             'integer': 'integer', 'boolean': 'boolean',
             'number': 'number'}


def schema_to_fields(schema: dict, prefix: str = '',
                     out: Dict[str, str] = None,
                     depth: int = 0) -> Dict[str, str]:
    """Flatten an openAPIV3Schema's properties into dotted paths.

    ``additionalProperties: {type: string}`` objects become 'string-map';
    array item schemas are not descended (the manager validates spines,
    element checks stay with the engine), matching the structural level
    the reference's ValidateResource enforces."""
    if out is None:
        out = {}
    if depth > 8 or not isinstance(schema, dict):
        return out
    for name, sub in (schema.get('properties') or {}).items():
        if not isinstance(sub, dict):
            continue
        path = f'{prefix}{name}'
        stype = sub.get('type', '')
        addl = sub.get('additionalProperties')
        if stype == 'object' and isinstance(addl, dict) and \
                addl.get('type') == 'string':
            out[path] = 'string-map'
        elif stype in _TYPE_MAP:
            out[path] = _TYPE_MAP[stype]
        if stype == 'object':
            schema_to_fields(sub, f'{path}.', out, depth + 1)
    return out


class OpenAPIController:
    """reference: pkg/controllers/openapi/controller.go (2m resync)."""

    def __init__(self, client, manager: Manager):
        self.client = client
        self.manager = manager

    def reconcile(self) -> int:
        """Ingest every CRD's schema into the manager (full replace, so
        deleted or retyped CRDs leave no stale entries); returns the
        number of (group, kind) schemas synced."""
        try:
            crds = self.client.list_resource(
                'apiextensions.k8s.io/v1', 'CustomResourceDefinition', '')
        except Exception:  # noqa: BLE001 - no CRDs registered
            crds = []
        schemas: Dict[tuple, Dict[str, str]] = {}
        for crd in crds:
            spec = crd.get('spec') or {}
            group = spec.get('group') or ''
            kind = ((spec.get('names') or {}).get('kind')) or ''
            if not kind:
                continue
            versions = spec.get('versions') or []
            # the storage (or first) version's schema wins, like the
            # reference's single-document sync
            chosen = next((v for v in versions if v.get('storage')),
                          versions[0] if versions else None)
            if not chosen:
                continue
            schema = ((chosen.get('schema') or {})
                      .get('openAPIV3Schema')) or {}
            fields = schema_to_fields(schema)
            if fields:
                schemas[(group, kind)] = fields
        self.manager.replace_crd_schemas(schemas)
        return len(schemas)


def crd_fixture(group: str, kind: str, plural: str,
                open_api_v3_schema: dict,
                version: str = 'v1') -> dict:
    """A minimal CustomResourceDefinition document (test/scenario aid)."""
    return {
        'apiVersion': 'apiextensions.k8s.io/v1',
        'kind': 'CustomResourceDefinition',
        'metadata': {'name': f'{plural}.{group}'},
        'spec': {
            'group': group,
            'names': {'kind': kind, 'plural': plural},
            'scope': 'Namespaced',
            'versions': [{
                'name': version, 'served': True, 'storage': True,
                'schema': {'openAPIV3Schema': open_api_v3_schema},
            }],
        },
    }
