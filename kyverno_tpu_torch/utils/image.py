"""Image reference parsing (reference: pkg/utils/image/infos.go).

Pure-Python equivalent of the distribution/reference parse the reference
relies on: splits a ref into registry / path / name / tag / digest with
the default-registry and default-tag rules.
"""

from __future__ import annotations

import re
from typing import Optional

DEFAULT_REGISTRY = 'docker.io'

_DIGEST_RE = re.compile(r'^[A-Za-z][A-Za-z0-9]*(?:[-_+.][A-Za-z][A-Za-z0-9]*)*:[0-9a-fA-F]{32,}$')
_TAG_RE = re.compile(r'^[\w][\w.-]{0,127}$')


class ImageInfo:
    """reference: pkg/utils/image/infos.go:15 ImageInfo (+ Pointer from
    pkg/utils/api/image.go:14)."""

    __slots__ = ('registry', 'name', 'path', 'tag', 'digest', 'pointer')

    def __init__(self, registry: str = '', name: str = '', path: str = '',
                 tag: str = '', digest: str = '', pointer: str = ''):
        self.registry = registry
        self.name = name
        self.path = path
        self.tag = tag
        self.digest = digest
        self.pointer = pointer

    def __str__(self) -> str:
        image = f'{self.registry}/{self.path}' if self.registry else self.path
        if self.digest:
            return f'{image}@{self.digest}'
        return f'{image}:{self.tag}'

    def reference_with_tag(self) -> str:
        image = f'{self.registry}/{self.path}' if self.registry else self.path
        return f'{image}:{self.tag}'

    def to_dict(self) -> dict:
        out = {'name': self.name, 'path': self.path}
        if self.registry:
            out['registry'] = self.registry
        if self.tag:
            out['tag'] = self.tag
        if self.digest:
            out['digest'] = self.digest
        return out


def _has_domain(name: str) -> bool:
    i = name.find('/')
    if i == -1:
        return False
    first = name[:i]
    return ('.' in first or ':' in first or first == 'localhost'
            or first.lower() != first)


def add_default_registry(name: str, default_registry: str = DEFAULT_REGISTRY,
                         ) -> str:
    """reference: infos.go:110 addDefaultRegistry"""
    if not _has_domain(name):
        name = f'{default_registry}/{name}'
    return name


def get_image_info(image: str,
                   default_registry: str = DEFAULT_REGISTRY,
                   enable_default_registry_mutation: bool = True,
                   pointer: str = '') -> ImageInfo:
    """reference: infos.go:54 GetImageInfo. Raises ValueError on a bad ref."""
    if not image or image != image.strip():
        raise ValueError(f'bad image: {image!r}')
    full = add_default_registry(image, default_registry)

    rest = full
    digest = ''
    at = rest.find('@')
    if at != -1:
        digest = rest[at + 1:]
        rest = rest[:at]
        if not _DIGEST_RE.match(digest):
            raise ValueError(f'bad image digest: {image!r}')

    tag = ''
    # the tag separator is a ':' after the last '/'
    last_slash = rest.rfind('/')
    colon = rest.rfind(':')
    if colon > last_slash:
        tag = rest[colon + 1:]
        rest = rest[:colon]
        if not _TAG_RE.match(tag):
            raise ValueError(f'bad image tag: {image!r}')

    slash = rest.find('/')
    registry, path = rest[:slash], rest[slash + 1:]
    if not path or any(not seg for seg in path.split('/')):
        raise ValueError(f'bad image: {image!r}')
    name = path.rsplit('/', 1)[-1]

    if not digest and not tag:
        tag = 'latest'
    if full != image and not enable_default_registry_mutation:
        registry = ''
    return ImageInfo(registry=registry, name=name, path=path, tag=tag,
                     digest=digest, pointer=pointer)


def image_matches(image: str, patterns: list) -> bool:
    """reference: pkg/engine/imageVerify.go:314 imageMatches"""
    from . import wildcard
    return any(wildcard.match(p, image) for p in patterns or [])
