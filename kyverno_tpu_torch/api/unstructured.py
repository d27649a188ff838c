"""Unstructured Kubernetes resource helpers.

Mirrors the tiny slice of k8s.io/apimachinery's unstructured.Unstructured the
engine needs (kind/name/namespace/labels/annotations/GVK accessors) plus the
GVK-string parsing used in policy match blocks
(reference: pkg/utils/kube/kind.go).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_VERSION_RE = re.compile(r'v\d((alpha|beta)\d)?')


class Resource:
    """Thin wrapper over an unstructured resource dict."""

    __slots__ = ('obj',)

    def __init__(self, obj: dict):
        self.obj = obj or {}

    @property
    def api_version(self) -> str:
        return self.obj.get('apiVersion', '') or ''

    @property
    def kind(self) -> str:
        return self.obj.get('kind', '') or ''

    @property
    def metadata(self) -> dict:
        return self.obj.get('metadata') or {}

    @property
    def name(self) -> str:
        return self.metadata.get('name', '') or ''

    @property
    def generate_name(self) -> str:
        return self.metadata.get('generateName', '') or ''

    @property
    def namespace(self) -> str:
        return self.metadata.get('namespace', '') or ''

    @property
    def uid(self) -> str:
        return self.metadata.get('uid', '') or ''

    @property
    def labels(self) -> Dict[str, str]:
        return {str(k): str(v) for k, v in (self.metadata.get('labels') or {}).items()}

    @property
    def annotations(self) -> Dict[str, str]:
        return {str(k): str(v) for k, v in (self.metadata.get('annotations') or {}).items()}

    @property
    def owner_references(self) -> List[dict]:
        return self.metadata.get('ownerReferences') or []

    @property
    def group_version(self) -> str:
        return self.api_version

    @property
    def group(self) -> str:
        av = self.api_version
        return av.rsplit('/', 1)[0] if '/' in av else ''

    @property
    def version(self) -> str:
        av = self.api_version
        return av.rsplit('/', 1)[1] if '/' in av else av

    def __bool__(self):
        return bool(self.obj)


def get_kind_from_gvk(s: str) -> Tuple[str, str]:
    """Parse a policy 'kinds' entry into (groupVersion, kind[/subresource])
    (reference: pkg/utils/kube/kind.go:11 GetKindFromGVK)."""
    parts = s.split('/')
    count = len(parts)
    if count == 2:
        if _VERSION_RE.search(parts[0]) or parts[0] == '*':
            return parts[0], _format_subresource(parts[1])
        return '', parts[0] + '/' + parts[1]
    if count == 3:
        if _VERSION_RE.search(parts[0]) or parts[0] == '*':
            return parts[0], parts[1] + '/' + parts[2]
        return parts[0] + '/' + parts[1], _format_subresource(parts[2])
    if count == 4:
        return parts[0] + '/' + parts[1], parts[2] + '/' + parts[3]
    return '', _format_subresource(s)


def _format_subresource(s: str) -> str:
    return s.replace('.', '/', 1)


def split_subresource(s: str) -> Tuple[str, str]:
    parts = s.split('/')
    if len(parts) == 2:
        return parts[0], parts[1]
    return s, ''


def contains_kind(kinds: List[str], kind: str) -> bool:
    for e in kinds:
        _, k = get_kind_from_gvk(e)
        k, _ = split_subresource(k)
        if k == kind:
            return True
    return False


def group_version_matches(group_version: str, server_gv: str) -> bool:
    # reference: pkg/utils/kube/kind.go:63
    if '*' in group_version:
        return server_gv.startswith(group_version.rstrip('*'))
    g1, _, v1 = group_version.rpartition('/')
    g2, _, v2 = server_gv.rpartition('/')
    return g1 == g2 and v1 == v2
