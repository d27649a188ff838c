"""``kyverno oci`` — push/pull policies as OCI artifacts.

Reference: cmd/cli/kubectl-kyverno/oci/{oci.go,push,pull} — policies are
bundled as an OCI image whose layers carry the policy documents with the
kyverno media types.  The hermetic environment has no live registry, so
refs address an OCI image-layout directory store (the standard on-disk
registry format: ``oci-layout`` + ``index.json`` + ``blobs/sha256/...``)
— the same bytes a registry would serve, addressable by tag.

Media types match the reference's artifact shape:
  config: application/vnd.cncf.kyverno.config.v1+json
  layer:  application/vnd.cncf.kyverno.policy.layer.v1+yaml
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import yaml

CONFIG_MEDIA_TYPE = 'application/vnd.cncf.kyverno.config.v1+json'
POLICY_LAYER_MEDIA_TYPE = 'application/vnd.cncf.kyverno.policy.layer.v1+yaml'
MANIFEST_MEDIA_TYPE = 'application/vnd.oci.image.manifest.v1+json'


class OCILayout:
    """Minimal OCI image-layout store (spec v1.0.2 directory layout)."""

    def __init__(self, root: str):
        self.root = root

    # -- blob store ----------------------------------------------------------

    def _blob_path(self, digest: str) -> str:
        algo, hexd = digest.split(':', 1)
        return os.path.join(self.root, 'blobs', algo, hexd)

    def put_blob(self, data: bytes) -> Tuple[str, int]:
        digest = 'sha256:' + hashlib.sha256(data).hexdigest()
        path = self._blob_path(digest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):
            with open(path, 'wb') as f:
                f.write(data)
        return digest, len(data)

    def get_blob(self, digest: str) -> bytes:
        with open(self._blob_path(digest), 'rb') as f:
            data = f.read()
        check = 'sha256:' + hashlib.sha256(data).hexdigest()
        if check != digest:
            raise ValueError(f'blob {digest} corrupted (got {check})')
        return data

    # -- index ---------------------------------------------------------------

    def _index_path(self) -> str:
        return os.path.join(self.root, 'index.json')

    def read_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {'schemaVersion': 2, 'manifests': []}

    def write_index(self, index: dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        with open(os.path.join(self.root, 'oci-layout'), 'w') as f:
            json.dump({'imageLayoutVersion': '1.0.0'}, f)
        with open(self._index_path(), 'w') as f:
            json.dump(index, f, indent=1)

    def tag(self, tag: str, manifest_digest: str, size: int) -> None:
        index = self.read_index()
        index['manifests'] = [
            m for m in index['manifests']
            if (m.get('annotations') or {}).get(
                'org.opencontainers.image.ref.name') != tag]
        index['manifests'].append({
            'mediaType': MANIFEST_MEDIA_TYPE,
            'digest': manifest_digest, 'size': size,
            'annotations': {'org.opencontainers.image.ref.name': tag},
        })
        self.write_index(index)

    def resolve(self, tag: str) -> str:
        for m in self.read_index()['manifests']:
            if (m.get('annotations') or {}).get(
                    'org.opencontainers.image.ref.name') == tag:
                return m['digest']
        raise KeyError(f'tag {tag!r} not found in {self.root}')


def parse_ref(ref: str) -> Tuple[str, str]:
    """'dir:TAG' or a bare layout dir (tag 'latest')."""
    head, sep, tag = ref.rpartition(':')
    if sep and '/' not in tag and head:
        return head, tag
    return ref, 'latest'


def push(policy_paths: List[str], ref: str) -> str:
    """Bundle policy documents into the layout store; returns the
    manifest digest (reference: oci/push command)."""
    docs = []
    for path in policy_paths:
        files = []
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.endswith(('.yaml', '.yml')):
                    files.append(os.path.join(path, name))
        else:
            files.append(path)
        for fp in files:
            with open(fp) as f:
                for doc in yaml.safe_load_all(f):
                    if doc and doc.get('kind') in (
                            'ClusterPolicy', 'Policy'):
                        docs.append(doc)
    if not docs:
        raise ValueError('no policies found to push')
    root, tag = parse_ref(ref)
    layout = OCILayout(root)
    layers = []
    for doc in docs:
        data = yaml.safe_dump(doc, sort_keys=False).encode()
        digest, size = layout.put_blob(data)
        layers.append({
            'mediaType': POLICY_LAYER_MEDIA_TYPE,
            'digest': digest, 'size': size,
            'annotations': {
                'io.kyverno.image.name':
                    (doc.get('metadata') or {}).get('name', ''),
                'io.kyverno.image.kind': doc.get('kind', ''),
            },
        })
    config = json.dumps({'policies': len(docs)}).encode()
    cfg_digest, cfg_size = layout.put_blob(config)
    manifest = json.dumps({
        'schemaVersion': 2,
        'mediaType': MANIFEST_MEDIA_TYPE,
        'config': {'mediaType': CONFIG_MEDIA_TYPE,
                   'digest': cfg_digest, 'size': cfg_size},
        'layers': layers,
    }, indent=1).encode()
    man_digest, man_size = layout.put_blob(manifest)
    layout.tag(tag, man_digest, man_size)
    return man_digest


def pull(ref: str, output_dir: str) -> List[str]:
    """Extract the bundle's policies into ``output_dir`` as YAML files;
    returns the written paths (reference: oci/pull command)."""
    root, tag = parse_ref(ref)
    layout = OCILayout(root)
    manifest = json.loads(layout.get_blob(layout.resolve(tag)))
    os.makedirs(output_dir, exist_ok=True)
    written = []
    used = set()
    for i, layer in enumerate(manifest.get('layers', [])):
        if layer.get('mediaType') != POLICY_LAYER_MEDIA_TYPE:
            continue
        data = layout.get_blob(layer['digest'])
        name = (layer.get('annotations') or {}).get(
            'io.kyverno.image.name') or f'policy-{i}'
        # the annotation is attacker-controlled content from the pulled
        # artifact: strip any path components so writes cannot escape
        # output_dir
        name = os.path.basename(name.replace('\\', '/')) or f'policy-{i}'
        # same-named policies (e.g. cluster + namespaced 'restrict') must
        # not overwrite each other
        if name in used:
            name = f'{name}-{i}'
        used.add(name)
        path = os.path.join(output_dir, f'{name}.yaml')
        with open(path, 'wb') as f:
            f.write(data)
        written.append(path)
    return written


def command_push(args) -> int:
    digest = push(args.paths, args.ref)
    print(f'pushed {args.ref} ({digest})')
    return 0


def command_pull(args) -> int:
    written = pull(args.ref, args.output or '.')
    for path in written:
        print(path)
    print(f'pulled {len(written)} policies from {args.ref}')
    return 0
