"""``validate.manifests`` — sigstore k8s-manifest signature verification.

Reference: pkg/engine/k8smanifest.go (processYAMLValidationRule:38,
verifyManifest:59, verifyManifestAttestorSet:155). The signing scheme
(sigstore/k8s-manifest-sigstore): the resource carries annotations

    cosign.sigstore.dev/message    = base64(gzip(tar.gz(manifest yaml)))
    cosign.sigstore.dev/signature  = base64(ASN.1 ECDSA-P256-SHA256 sig)
    cosign.sigstore.dev/signature_1, _2 ...  (multi-sig)

where the signed blob is the once-gunzipped message (the inner tar.gz
bytes). Verification is fully offline: check the signature(s) against the
attestor public keys, then diff the manifest inside the message against
the admitted resource modulo the ignore-field config
(reference: pkg/engine/resources/default-config.yaml).
"""

from __future__ import annotations

import base64
import fnmatch
import gzip
import io
import tarfile
from typing import Any, Dict, List, Optional, Tuple

import yaml

DEFAULT_ANNOTATION_DOMAIN = 'cosign.sigstore.dev'

# reference: pkg/engine/resources/default-config.yaml (kyverno's extra
# ignore fields) + k8s-manifest-sigstore default-config.yaml semantics —
# fields added by the API server / kubectl that must not count as mutation
_DEFAULT_IGNORE_FIELDS: List[Tuple[List[str], List[str]]] = [
    (['*'], [
        'metadata.namespace',
        'spec.containers.*.imagePullPolicy',
        'spec.containers.*.terminationMessagePath',
        'spec.containers.*.terminationMessagePolicy',
        'spec.dnsPolicy',
        'spec.restartPolicy',
        'spec.schedulerName',
        'spec.terminationGracePeriodSeconds',
        'metadata.labels.app.kubernetes.io/instance',
        'metadata.managedFields.*',
        'metadata.resourceVersion',
        'metadata.selfLink',
        'metadata.annotations.control-plane.alpha.kubernetes.io/leader',
        'metadata.annotations.kubectl.kubernetes.io/'
        'last-applied-configuration',
        'metadata.finalizers*',
        'metadata.annotations.namespace',
        'metadata.annotations.deprecated.daemonset.template.generation',
        'metadata.creationTimestamp',
        'metadata.uid',
        'metadata.generation',
        'status',
        'metadata.annotations.deployment.kubernetes.io/revision',
    ]),
    (['Pod'], [
        'spec.volumes.*.name',
        'spec.volumes.*.projected.*',
        'spec.volumes.*.configMap.defaultMode',
        'spec.containers.*.volumeMounts.*',
        'spec.tolerations.*',
        'spec.enableServiceLinks',
        'spec.preemptionPolicy',
        'spec.priority',
        'spec.serviceAccount',
        'spec.nodeName',
    ]),
    (['Deployment'], [
        'spec.progressDeadlineSeconds',
        'spec.revisionHistoryLimit',
        'spec.strategy.*',
        'spec.template.metadata.creationTimestamp',
        'spec.containers.*.ports.*.protocol',
        'spec.containers.*.resources',
        'spec.securityContext',
    ]),
    (['Service'], [
        'spec.ports.*.nodePort',
        'spec.ports.*.protocol',
        'spec.clusterIP',
        'spec.clusterIPs.0',
        'spec.sessionAffinity',
        'spec.type',
        'spec.ipFamilies.*',
        'spec.ipFamilyPolicy',
        'spec.internalTrafficPolicy',
    ]),
    (['ClusterPolicy', 'Policy'], [
        'metadata.annotations.pod-policies.kyverno.io/autogen-controllers',
        'spec.failurePolicy',
        'spec.background',
        'spec.validationFailureAction',
    ]),
    (['ServiceAccount'], [
        'secrets.*.name',
        'imagePullSecrets.*.name',
    ]),
]


class ManifestError(Exception):
    pass


def process_yaml_validation_rule(pctx, rule) -> Optional['RuleResponse']:
    """reference: k8smanifest.go:38 processYAMLValidationRule"""
    from .api import RuleResponse, RuleStatus, RuleType
    if pctx.new_resource == {} and pctx.old_resource:
        return None  # delete request
    manifests = (rule.validation or {}).get('manifests') or {}
    try:
        verified, reason = verify_manifest(
            pctx.new_resource, manifests)
    except ManifestError as exc:
        return RuleResponse(rule.name, RuleType.VALIDATION,
                            'error occurred during manifest verification: '
                            f'{exc}', RuleStatus.ERROR)
    status = RuleStatus.PASS if verified else RuleStatus.FAIL
    return RuleResponse(rule.name, RuleType.VALIDATION, reason, status)


def verify_manifest(resource: dict, manifests: dict) -> Tuple[bool, str]:
    """reference: k8smanifest.go:59 verifyManifest"""
    domain = manifests.get('annotationDomain') or DEFAULT_ANNOTATION_DOMAIN
    ignore_fields = list(manifests.get('ignoreFields') or [])
    verified_msgs = []
    for i, attestor_set in enumerate(manifests.get('attestors') or []):
        verified, reason = _verify_attestor_set(
            resource, attestor_set, domain, ignore_fields,
            path=f'.attestors[{i}]')
        if not verified:
            return False, reason
        verified_msgs.append(reason)
    return True, 'verified manifest signatures; ' + ','.join(verified_msgs)


def _expand_static_keys(attestor_set: dict) -> List[dict]:
    """Split multi-PEM key entries into one entry per key
    (reference: k8smanifest.go expandStaticKeys)."""
    out = []
    for entry in attestor_set.get('entries') or []:
        keys = entry.get('keys') or {}
        pem_blob = keys.get('publicKeys') or ''
        if pem_blob.count('-----BEGIN') > 1:
            for block in _split_pem(pem_blob):
                e = dict(entry)
                e['keys'] = dict(keys, publicKeys=block)
                out.append(e)
        else:
            out.append(entry)
    return out


def _split_pem(blob: str) -> List[str]:
    blocks, current = [], []
    for line in blob.splitlines():
        current.append(line)
        if line.startswith('-----END'):
            blocks.append('\n'.join(current))
            current = []
    return blocks


def _required_count(attestor_set: dict, entries: List[dict]) -> int:
    count = attestor_set.get('count')
    if count is None or count == 0:
        return len(entries)
    return int(count)


def _verify_attestor_set(resource: dict, attestor_set: dict, domain: str,
                         ignore_fields: List[dict], path: str
                         ) -> Tuple[bool, str]:
    """reference: k8smanifest.go:155 verifyManifestAttestorSet"""
    entries = _expand_static_keys(attestor_set)
    required = _required_count(attestor_set, entries)
    verified_count = 0
    verified_msgs, failed_msgs = [], []
    for i, entry in enumerate(entries):
        entry_path = f'{path}.entries[{i}]'
        if entry.get('attestor') is not None:
            verified, reason = _verify_attestor_set(
                resource, entry['attestor'], domain, ignore_fields,
                entry_path + '.attestor')
        elif entry.get('keys') is not None:
            verified, reason = _verify_with_key(
                resource, entry['keys'], domain, ignore_fields, entry_path)
        else:
            raise ManifestError(
                f'attestor entry at {entry_path} has no keys; only static '
                'key verification is supported offline')
        if verified:
            verified_count += 1
            verified_msgs.append(reason)
        else:
            failed_msgs.append(reason)
        if verified_count >= required:
            return True, (f'manifest verification succeeded; verifiedCount '
                          f'{verified_count}; requiredCount {required}; '
                          f'message {",".join(verified_msgs)}')
    return False, (f'manifest verification failed; verifiedCount '
                   f'{verified_count}; requiredCount {required}; '
                   f'message {",".join(failed_msgs)}')


def _signatures(annotations: Dict[str, str], domain: str) -> List[bytes]:
    sigs = []
    base = f'{domain}/signature'
    if annotations.get(base):
        sigs.append(base64.b64decode(annotations[base]))
    i = 1
    while annotations.get(f'{base}_{i}'):
        sigs.append(base64.b64decode(annotations[f'{base}_{i}']))
        i += 1
    return sigs


def _verify_with_key(resource: dict, keys: dict, domain: str,
                     ignore_fields: List[dict], entry_path: str
                     ) -> Tuple[bool, str]:
    annotations = (resource.get('metadata') or {}).get('annotations') or {}
    msg_b64 = annotations.get(f'{domain}/message')
    if not msg_b64:
        return False, (f'failed to verify signature: annotation '
                       f'{domain}/message not found in the resource')
    sigs = _signatures(annotations, domain)
    if not sigs:
        return False, (f'failed to verify signature: annotation '
                       f'{domain}/signature not found in the resource')
    try:
        blob = gzip.decompress(base64.b64decode(msg_b64))
    except Exception as exc:  # noqa: BLE001
        raise ManifestError(f'failed to decode message: {exc}') from exc

    try:
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec, padding
    except ImportError as exc:  # pragma: no cover
        raise ManifestError('cryptography package unavailable') from exc

    pem = (keys.get('publicKeys') or '').encode()
    try:
        key = serialization.load_pem_public_key(pem)
    except Exception as exc:  # noqa: BLE001
        raise ManifestError(f'failed to load public key: {exc}') from exc

    signature_ok = False
    for sig in sigs:
        try:
            if isinstance(key, ec.EllipticCurvePublicKey):
                key.verify(sig, blob, ec.ECDSA(hashes.SHA256()))
            else:
                key.verify(sig, blob, padding.PKCS1v15(), hashes.SHA256())
            signature_ok = True
            break
        except InvalidSignature:
            continue
    if not signature_ok:
        return False, 'failed to verify signature: signature mismatch'

    manifest = _manifest_from_blob(blob)
    diffs = manifest_diff(manifest, resource, resource.get('kind', ''),
                          ignore_fields, domain)
    if diffs:
        return False, ('failed to verify signature; diff found: ' +
                       ', '.join(diffs[:5]))
    return True, f'singed by a valid signer: {entry_path}'


def _manifest_from_blob(blob: bytes) -> dict:
    for mode in ('r:gz', 'r:'):
        try:
            with tarfile.open(fileobj=io.BytesIO(blob), mode=mode) as tf:
                for member in tf.getmembers():
                    if member.isfile():
                        f = tf.extractfile(member)
                        if f is not None:
                            return yaml.safe_load(f.read()) or {}
        except (tarfile.TarError, OSError):
            continue
    # not a tarball: the blob may be the YAML itself (optionally gzipped)
    try:
        return yaml.safe_load(gzip.decompress(blob)) or {}
    except (OSError, yaml.YAMLError):
        pass
    try:
        return yaml.safe_load(blob) or {}
    except yaml.YAMLError as exc:
        raise ManifestError(
            f'no manifest found inside signed message: {exc}') from exc


# -- mutation diff ----------------------------------------------------------

def manifest_diff(manifest: Any, resource: Any, kind: str,
                  extra_ignore_fields: List[dict], domain: str) -> List[str]:
    """Dotted paths where the signed manifest and the live resource differ,
    minus the ignore-field config (reference: k8smanifest VerifyResource
    mutation check with DisableDryRun)."""
    patterns = [f'metadata.annotations.{domain}/*']
    for kinds, fields in _DEFAULT_IGNORE_FIELDS:
        if '*' in kinds or kind in kinds:
            patterns.extend(fields)
    for binding in extra_ignore_fields or []:
        objects = binding.get('objects') or []
        applies = not objects or any(
            (o.get('kind') in ('*', kind)) for o in objects)
        if applies:
            patterns.extend(binding.get('fields') or [])
    diffs: List[str] = []
    _walk_diff(manifest, resource, '', diffs)
    return [d for d in diffs if not _ignored(d, patterns)]


def _walk_diff(want: Any, have: Any, path: str, out: List[str]) -> None:
    if isinstance(want, dict) and isinstance(have, dict):
        for k in set(want) | set(have):
            sub = f'{path}.{k}' if path else str(k)
            if k not in want:
                _walk_added(have[k], sub, out)
            elif k not in have:
                out.append(sub)
            else:
                _walk_diff(want[k], have[k], sub, out)
    elif isinstance(want, list) and isinstance(have, list):
        for i in range(max(len(want), len(have))):
            sub = f'{path}.{i}'
            if i >= len(want):
                _walk_added(have[i], sub, out)
            elif i >= len(have):
                out.append(sub)
            else:
                _walk_diff(want[i], have[i], sub, out)
    elif want != have:
        out.append(path or '.')


def _walk_added(have: Any, path: str, out: List[str]) -> None:
    """Record leaf paths for content present only in the resource, so
    server-added defaults can be matched by leaf-level ignore patterns."""
    if isinstance(have, dict) and have:
        for k, v in have.items():
            _walk_added(v, f'{path}.{k}' if path else str(k), out)
    elif isinstance(have, list) and have:
        for i, v in enumerate(have):
            _walk_added(v, f'{path}.{i}', out)
    else:
        out.append(path)


def _ignored(path: str, patterns: List[str]) -> bool:
    for pattern in patterns:
        if _field_match(pattern, path):
            return True
    return False


def _field_match(pattern: str, path: str) -> bool:
    """Segment-wise glob match; a pattern also matches any deeper path
    (``status`` ignores ``status.foo.bar``)."""
    p_segs = pattern.split('.')
    f_segs = path.split('.')
    if len(f_segs) < len(p_segs):
        return False
    for ps, fs in zip(p_segs, f_segs):
        if not fnmatch.fnmatchcase(fs, ps):
            return False
    return True
