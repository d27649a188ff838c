"""Image extraction from workload resources (reference:
pkg/utils/api/image.go).

Standard extractors cover initContainers/containers/ephemeralContainers of
the 8 pod-controller kinds; policies may override per-kind extraction with
``imageExtractors`` configs (path/value/key/name).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .image import ImageInfo, get_image_info


class ImageExtractor:
    __slots__ = ('fields', 'key', 'value', 'name')

    def __init__(self, fields: List[str], key: str, value: str, name: str):
        self.fields = fields
        self.key = key
        self.value = value
        self.name = name


def build_standard_extractors(*tags: str) -> List[ImageExtractor]:
    """reference: image.go:105 BuildStandardExtractors"""
    out = []
    for tag in ('initContainers', 'containers', 'ephemeralContainers'):
        out.append(ImageExtractor(list(tags) + [tag, '*'], 'name', 'image', tag))
    return out


_POD = build_standard_extractors('spec')
_POD_CONTROLLER = build_standard_extractors('spec', 'template', 'spec')
_CRONJOB = build_standard_extractors('spec', 'jobTemplate', 'spec',
                                     'template', 'spec')

REGISTERED_EXTRACTORS: Dict[str, List[ImageExtractor]] = {
    'Pod': _POD,
    'DaemonSet': _POD_CONTROLLER,
    'Deployment': _POD_CONTROLLER,
    'ReplicaSet': _POD_CONTROLLER,
    'ReplicationController': _POD_CONTROLLER,
    'StatefulSet': _POD_CONTROLLER,
    'CronJob': _CRONJOB,
    'Job': _POD_CONTROLLER,
}


def _lookup_extractors(kind: str, configs: Optional[dict]
                       ) -> Optional[List[ImageExtractor]]:
    """reference: image.go:117 lookupImageExtractor"""
    if configs and kind in configs:
        out = []
        for c in configs[kind]:
            fields = [seg.strip() for seg in (c.get('path') or '').split('/')
                      if seg.strip()]
            value = c.get('value') or ''
            if not value and fields:
                value = fields[-1]
                fields = fields[:-1]
            out.append(ImageExtractor(fields, c.get('key') or '',
                                      value, c.get('name') or 'custom'))
        return out
    return REGISTERED_EXTRACTORS.get(kind)


def _extract(obj, path: List[str], key_path: str, value_path: str,
             fields: List[str], infos: Dict[str, ImageInfo],
             default_registry: str, registry_mutation: bool) -> None:
    """reference: image.go:51 extract"""
    if obj is None:
        return
    if fields and fields[0] == '*':
        if isinstance(obj, list):
            for i, v in enumerate(obj):
                _extract(v, path + [str(i)], key_path, value_path, fields[1:],
                         infos, default_registry, registry_mutation)
        elif isinstance(obj, dict):
            for k, v in obj.items():
                _extract(v, path + [k], key_path, value_path, fields[1:],
                         infos, default_registry, registry_mutation)
        else:
            raise ValueError('invalid type')
        return
    if not isinstance(obj, dict):
        raise ValueError('invalid image config')
    if not fields:
        pointer = '/' + '/'.join(path) + '/' + value_path
        key = pointer
        if key_path:
            key = obj.get(key_path)
            if not isinstance(key, str):
                raise ValueError('invalid key')
        value = obj.get(value_path)
        if not isinstance(value, str):
            raise ValueError('invalid value')
        infos[key] = get_image_info(value, default_registry,
                                    registry_mutation, pointer)
        return
    _extract(obj.get(fields[0]), path + [fields[0]], key_path, value_path,
             fields[1:], infos, default_registry, registry_mutation)


def extract_images_from_resource(resource: dict,
                                 configs: Optional[dict] = None,
                                 default_registry: str = 'docker.io',
                                 registry_mutation: bool = True
                                 ) -> Dict[str, Dict[str, ImageInfo]]:
    """reference: image.go:154 ExtractImagesFromResource — returns
    {extractor_name: {container_name_or_pointer: ImageInfo}}."""
    kind = resource.get('kind', '')
    extractors = _lookup_extractors(kind, configs)
    if extractors is not None and len(extractors) == 0:
        raise ValueError(f'no extractors found for {kind}')
    infos: Dict[str, Dict[str, ImageInfo]] = {}
    for extractor in extractors or []:
        sub: Dict[str, ImageInfo] = {}
        _extract(resource, [], extractor.key, extractor.value,
                 list(extractor.fields), sub, default_registry,
                 registry_mutation)
        if sub:
            infos.setdefault(extractor.name, {}).update(sub)
    return infos
