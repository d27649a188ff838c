"""Cosign verification against a registry client (reference:
pkg/cosign/cosign.go:63 VerifySignature, :256 FetchAttestations).

Real signature cryptography over the cosign "simple signing" model:

* a signature entry carries ``payload`` (base64 JSON) + ``signature``
  (base64 over the payload bytes) and optionally a signing ``cert`` (+
  ``chain``) for keyless flows;
* static-key attestors verify the signature with the provided PEM public
  key (ECDSA P-256/P-384 SHA-256, RSA PKCS1v15 SHA-256, or Ed25519);
* keyless attestors verify the leaf certificate chains to the provided
  roots, verify the payload signature with the leaf's public key, and
  match the certificate identity — SAN email/URI vs ``subject``, the
  Fulcio OIDC-issuer extension (1.3.6.1.4.1.57264.1.1) vs ``issuer`` —
  with the same wildcard semantics the reference applies;
* the payload's ``critical.image.docker-manifest-digest`` must equal the
  image's digest, and attestor ``annotations`` must be present in the
  payload's ``optional`` block (cosign.go payload checks).

Rekor transparency-log verification is OFFLINE, from the signature
entry's attached bundle (what ``cosign sign`` stores under the
``dev.sigstore.cosign/bundle`` annotation), matching the reference's
cosign-library behavior when a Rekor client is configured
(pkg/cosign/cosign.go:204 buildCosignOptions → RekorClient; the
library prefers the offline bundle when present):

* the SignedEntryTimestamp must verify over the RFC 8785-canonical
  JSON of {body, integratedTime, logID, logIndex} with the configured
  Rekor public key (``rekor.pubkey`` in the policy's rekor block, or
  the SIGSTORE_REKOR_PUBLIC_KEY env var — cosign's own override);
* the bundle body (hashedrekord / rekord) must be consistent with the
  verified signature: same payload hash and same signature bytes;
* for keyless entries the integratedTime must fall inside the signing
  certificate's validity window (cosign CheckExpiry).

Per the reference CRD semantics (image_verification_types.go:149 "If
the value is nil, Rekor is not checked"), tlog verification runs
whenever the attestor carries a ``rekor:`` block (unless its
``ignoreTlog`` is set) — and an entry without a valid bundle then
FAILS verification.

Legacy metadata-only entries (a bare ``key`` id, no payload) remain
accepted ONLY when the attestor key is not a PEM block — the CLI mock
registry uses those; any PEM-keyed attestor requires real signatures.
"""

from __future__ import annotations

import base64
import json
from typing import List, Optional, Tuple

from ..utils import wildcard
from ..registry.client import RegistryError

_FULCIO_ISSUER_OID = '1.3.6.1.4.1.57264.1.1'


class Options:
    """reference: pkg/cosign/cosign.go Options (subset used by the engine)"""

    __slots__ = ('image_ref', 'key', 'cert', 'cert_chain', 'roots',
                 'subject', 'issuer', 'annotations', 'repository',
                 'ignore_tlog', 'rekor_url', 'rekor_pubkey',
                 'predicate_type', 'fetch_attestations')

    def __init__(self, image_ref: str, key: str = '', cert: str = '',
                 cert_chain: str = '', roots: str = '', subject: str = '',
                 issuer: str = '', annotations: Optional[dict] = None,
                 repository: str = '', ignore_tlog: bool = False,
                 rekor_url: str = '', rekor_pubkey: str = '',
                 predicate_type: str = '',
                 fetch_attestations: bool = False):
        self.image_ref = image_ref
        self.key = key
        self.cert = cert
        self.cert_chain = cert_chain
        self.roots = roots
        self.subject = subject
        self.issuer = issuer
        self.annotations = annotations or {}
        self.repository = repository
        self.ignore_tlog = ignore_tlog
        self.rekor_url = rekor_url
        self.rekor_pubkey = rekor_pubkey
        self.predicate_type = predicate_type
        self.fetch_attestations = fetch_attestations

    def tlog_required(self) -> bool:
        """Tlog verification applies when the attestor configures Rekor
        (CRD: 'If the value is nil, Rekor is not checked' —
        image_verification_types.go:149) and ignoreTlog is unset."""
        return bool(self.rekor_url or self.rekor_pubkey) and \
            not self.ignore_tlog


class Response:
    """reference: pkg/cosign/cosign.go Response"""

    __slots__ = ('digest', 'statements')

    def __init__(self, digest: str = '', statements: Optional[List[dict]] = None):
        self.digest = digest
        self.statements = statements or []


class VerificationError(Exception):
    """One signature entry failed cryptographic verification."""


def _is_pem(blob: str) -> bool:
    return isinstance(blob, str) and '-----BEGIN' in blob


# ---------------------------------------------------------------------------
# crypto primitives

def _load_public_key(pem: str):
    from cryptography.hazmat.primitives import serialization
    try:
        return serialization.load_pem_public_key(pem.strip().encode())
    except Exception as e:  # noqa: BLE001
        raise VerificationError(f'bad public key: {e}') from e


def _verify_blob(public_key, signature: bytes, payload: bytes) -> None:
    """Verify ``signature`` over ``payload`` for the supported key types
    (cosign defaults: ECDSA-SHA256; RSA PKCS1v15-SHA256; Ed25519)."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import (ec, ed25519,
                                                           padding, rsa)
    try:
        if isinstance(public_key, ec.EllipticCurvePublicKey):
            public_key.verify(signature, payload,
                              ec.ECDSA(hashes.SHA256()))
        elif isinstance(public_key, rsa.RSAPublicKey):
            public_key.verify(signature, payload, padding.PKCS1v15(),
                              hashes.SHA256())
        elif isinstance(public_key, ed25519.Ed25519PublicKey):
            public_key.verify(signature, payload)
        else:
            raise VerificationError(
                f'unsupported key type {type(public_key).__name__}')
    except InvalidSignature as e:
        raise VerificationError('signature verification failed') from e


def _load_certs(pem_blob: str) -> List:
    from cryptography import x509
    certs = []
    block: List[str] = []
    for line in (pem_blob or '').splitlines():
        block.append(line)
        if '-----END CERTIFICATE-----' in line:
            try:
                certs.append(x509.load_pem_x509_certificate(
                    '\n'.join(block).encode()))
            except Exception as e:  # noqa: BLE001 - registry data is
                # untrusted; a malformed cert must fail only this entry
                raise VerificationError(f'bad certificate: {e}') from e
            block = []
    return certs


def _verify_cert_chain(leaf, intermediates: List, roots: List) -> None:
    """Walk issuer links from the leaf to any of ``roots``, verifying
    each certificate's signature with its issuer's public key
    (cosign.go cert verification against the provided root pool)."""
    if not roots:
        raise VerificationError('no roots provided for certificate chain')
    pool = {c.subject.rfc4514_string(): c for c in intermediates}
    root_by_subject = {c.subject.rfc4514_string(): c for c in roots}
    current = leaf
    for _hop in range(len(intermediates) + 2):
        issuer_name = current.issuer.rfc4514_string()
        issuer = root_by_subject.get(issuer_name)
        terminal = issuer is not None
        if issuer is None:
            issuer = pool.get(issuer_name)
        if issuer is None:
            raise VerificationError(
                f'certificate chain broken at issuer {issuer_name!r}')
        try:
            current.verify_directly_issued_by(issuer)
        except Exception as e:  # noqa: BLE001
            raise VerificationError(
                f'certificate signature invalid: {e}') from e
        if terminal:
            return
        current = issuer
    raise VerificationError('certificate chain too long')


def _cert_identities(cert) -> Tuple[List[str], str]:
    """(SAN subjects, OIDC issuer) of a Fulcio-style signing cert."""
    from cryptography import x509
    subjects: List[str] = []
    try:
        san = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        subjects += san.get_values_for_type(x509.RFC822Name)
        subjects += [str(u) for u in san.get_values_for_type(
            x509.UniformResourceIdentifier)]
    except x509.ExtensionNotFound:
        pass
    issuer = ''
    for ext in cert.extensions:
        if ext.oid.dotted_string == _FULCIO_ISSUER_OID:
            raw = ext.value.value if hasattr(ext.value, 'value') else b''
            issuer = raw.decode('utf-8', 'replace') if raw else ''
    return subjects, issuer


# ---------------------------------------------------------------------------
# payload checks (cosign simple-signing)

def _check_payload(payload: bytes, digest: str, opts: Options) -> None:
    try:
        doc = json.loads(payload)
    except ValueError as e:
        raise VerificationError(f'malformed signature payload: {e}') from e
    got = ((doc.get('critical') or {}).get('image') or {}).get(
        'docker-manifest-digest', '')
    if got != digest:
        raise VerificationError(
            f'payload digest {got!r} does not match image digest {digest!r}')
    optional = doc.get('optional') or {}
    for k, v in opts.annotations.items():
        if optional.get(k) != v:
            raise VerificationError(f'annotation {k!r} mismatch')


def _verify_crypto_sig(sig: dict, payload: bytes, signature: bytes,
                       opts: Options) -> None:
    """Shared signature + signer verification for signature and
    attestation entries (keyed or keyless)."""
    if opts.key:
        _verify_blob(_load_public_key(opts.key), signature, payload)
        return
    if opts.cert:
        # pinned certificate: the signature MUST verify with the
        # attestor's cert — an entry-supplied cert is never trusted here
        certs = _load_certs(opts.cert)
        if not certs:
            raise VerificationError('no pinned certificate parsed')
        leaf = certs[0]
        roots = _load_certs(opts.roots)
        if roots:
            _verify_cert_chain(leaf,
                               certs[1:] + _load_certs(opts.cert_chain),
                               roots)
    else:
        # Fulcio-style keyless: the entry carries its signing cert, which
        # must chain to the configured roots — without roots there is no
        # trust anchor at all
        cert_pem = sig.get('cert', '')
        if not cert_pem:
            raise VerificationError('no certificate for keyless entry')
        certs = _load_certs(cert_pem)
        if not certs:
            raise VerificationError('no certificate parsed')
        leaf = certs[0]
        roots = _load_certs(opts.roots)
        if not roots:
            raise VerificationError(
                'keyless verification requires roots or a pinned cert')
        _verify_cert_chain(
            leaf,
            certs[1:] + _load_certs(sig.get('chain', '')) +
            _load_certs(opts.cert_chain),
            roots)
    _verify_blob(leaf.public_key(), signature, payload)
    subjects, issuer = _cert_identities(leaf)
    if opts.subject and not any(
            wildcard.match(opts.subject, s) for s in subjects):
        raise VerificationError(
            f'certificate subjects {subjects} do not match '
            f'{opts.subject!r}')
    if opts.issuer and not wildcard.match(opts.issuer, issuer):
        raise VerificationError(
            f'certificate issuer {issuer!r} does not match '
            f'{opts.issuer!r}')
    return leaf


# ---------------------------------------------------------------------------
# Rekor transparency log (offline bundle verification)

def _rekor_public_key(opts: Options) -> str:
    import os
    pem = opts.rekor_pubkey or os.environ.get(
        'SIGSTORE_REKOR_PUBLIC_KEY', '')
    if not pem:
        raise VerificationError(
            'tlog verification required but no Rekor public key is '
            'configured (rekor.pubkey or SIGSTORE_REKOR_PUBLIC_KEY)')
    return pem


def canonical_tlog_payload(bundle_payload: dict) -> bytes:
    """RFC 8785-style canonical JSON of the Rekor log entry the
    SignedEntryTimestamp covers (sigstore verifySET: sorted keys, no
    whitespace)."""
    return json.dumps({
        'body': bundle_payload.get('body'),
        'integratedTime': bundle_payload.get('integratedTime'),
        'logID': bundle_payload.get('logID'),
        'logIndex': bundle_payload.get('logIndex'),
    }, sort_keys=True, separators=(',', ':')).encode()


def _verify_tlog(sig: dict, payload: bytes, signature: bytes,
                 opts: Options) -> int:
    """Offline Rekor bundle verification; returns integratedTime.

    Mirrors the cosign library's VerifyBundle path the reference engages
    through cosign.go:204: SET signature over the canonical entry, then
    entry↔signature consistency (hashedrekord / rekord body)."""
    import hashlib
    bundle = sig.get('bundle')
    if not isinstance(bundle, dict):
        raise VerificationError(
            'tlog verification required but the signature carries no '
            'transparency log bundle')
    pl = bundle.get('Payload')
    if not isinstance(pl, dict):
        raise VerificationError('malformed tlog bundle: no Payload')
    set_b64 = bundle.get('SignedEntryTimestamp', '')
    try:
        set_sig = base64.b64decode(set_b64)
    except Exception as e:  # noqa: BLE001
        raise VerificationError(f'undecodable SignedEntryTimestamp: {e}') \
            from e
    _verify_blob(_load_public_key(_rekor_public_key(opts)), set_sig,
                 canonical_tlog_payload(pl))
    # entry body must describe THIS signature (cosign
    # verifyBundleMatchesSignature)
    try:
        body = json.loads(base64.b64decode(pl.get('body', '')))
    except Exception as e:  # noqa: BLE001
        raise VerificationError(f'undecodable tlog entry body: {e}') from e
    kind = body.get('kind', '')
    spec = body.get('spec') or {}
    data = spec.get('data') or {}
    if kind in ('intoto', 'dsse'):
        # cosign attest logs attestations as intoto/dsse entries whose
        # hash covers the logged envelope/payload; the raw-signature
        # comparison of rekord entries does not apply.  Check the
        # content hash against the signed payload when present.
        content = spec.get('content') or {}
        got = ((content.get('hash') or {}).get('value', '') or
               (content.get('payloadHash') or {}).get('value', '') or
               ((spec.get('envelopeHash') or {}).get('value', '')))
        if got:
            want = hashlib.sha256(payload).hexdigest()
            if got.lower() != want:
                raise VerificationError(
                    f'tlog entry payload hash {got!r} does not match '
                    f'the signed attestation')
    elif kind in ('hashedrekord', 'rekord'):
        sig_content = (spec.get('signature') or {}).get('content', '')
        try:
            body_sig = base64.b64decode(sig_content)
        except Exception as e:  # noqa: BLE001
            raise VerificationError(
                f'undecodable tlog signature: {e}') from e
        if body_sig != signature:
            raise VerificationError(
                'tlog entry signature does not match the verified '
                'signature')
        if kind == 'hashedrekord':
            want = hashlib.sha256(payload).hexdigest()
            got = (data.get('hash') or {}).get('value', '')
            if got.lower() != want:
                raise VerificationError(
                    f'tlog entry payload hash {got!r} does not match the '
                    f'signed payload')
        else:
            try:
                content = base64.b64decode(data.get('content', ''))
            except Exception as e:  # noqa: BLE001
                raise VerificationError(
                    f'undecodable tlog entry content: {e}') from e
            if content != payload:
                raise VerificationError(
                    'tlog entry content does not match the signed payload')
    else:
        raise VerificationError(f'unsupported tlog entry kind {kind!r}')
    it = pl.get('integratedTime')
    if not isinstance(it, int):
        raise VerificationError('tlog entry has no integratedTime')
    return it


def _check_cert_expiry_at(leaf, integrated_time: int) -> None:
    """cosign CheckExpiry: the Rekor inclusion time must fall inside the
    signing certificate's validity window."""
    from datetime import datetime, timezone
    at = datetime.fromtimestamp(integrated_time, tz=timezone.utc)
    not_before = getattr(leaf, 'not_valid_before_utc', None) or \
        leaf.not_valid_before.replace(tzinfo=timezone.utc)
    not_after = getattr(leaf, 'not_valid_after_utc', None) or \
        leaf.not_valid_after.replace(tzinfo=timezone.utc)
    if at < not_before or at > not_after:
        raise VerificationError(
            f'tlog integratedTime {at.isoformat()} outside certificate '
            f'validity [{not_before.isoformat()}, {not_after.isoformat()}]')


def _decode_entry(entry: dict) -> Tuple[bytes, bytes]:
    try:
        return (base64.b64decode(entry['payload']),
                base64.b64decode(entry['signature']))
    except Exception as e:  # noqa: BLE001
        raise VerificationError(f'undecodable signature entry: {e}') from e


def _verify_entry(sig: dict, digest: str, opts: Options) -> None:
    """Cryptographically verify one stored signature entry."""
    payload, signature = _decode_entry(sig)
    leaf = _verify_crypto_sig(sig, payload, signature, opts)
    if opts.tlog_required():
        integrated_time = _verify_tlog(sig, payload, signature, opts)
        if leaf is not None:
            _check_cert_expiry_at(leaf, integrated_time)
    _check_payload(payload, digest, opts)


# ---------------------------------------------------------------------------
# legacy metadata matching (CLI mock-registry fixtures only)

def _signature_matches(sig: dict, opts: Options) -> bool:
    if opts.key:
        return sig.get('key', '') == opts.key.strip()
    matched = True
    if opts.subject:
        matched = matched and wildcard.match(opts.subject,
                                             sig.get('subject', ''))
    if opts.issuer:
        matched = matched and wildcard.match(opts.issuer,
                                             sig.get('issuer', ''))
    if not opts.subject and not opts.issuer:
        # keyless with no identity constraints: any signature counts
        matched = bool(sig)
    return matched


def _is_crypto_entry(sig: dict) -> bool:
    return 'payload' in sig and 'signature' in sig


def verify_signature(rclient, opts: Options) -> Response:
    """reference: cosign.go:63 VerifySignature — raises on no match."""
    signatures = rclient.get_signatures(opts.image_ref)
    digest = rclient.fetch_image_descriptor(opts.image_ref).digest
    errors: List[str] = []
    pem_attestor = _is_pem(opts.key) or _is_pem(opts.roots) or \
        _is_pem(opts.cert)
    for sig in signatures:
        if _is_crypto_entry(sig):
            try:
                _verify_entry(sig, digest, opts)
                return Response(digest=digest)
            except VerificationError as e:
                errors.append(str(e))
                continue
        elif not pem_attestor and _signature_matches(sig, opts):
            # legacy metadata entry — only for non-PEM attestor fixtures
            return Response(digest=digest)
    detail = f': {"; ".join(errors)}' if errors else ''
    raise RegistryError(
        f'no matching signatures for {opts.image_ref}{detail}')


def fetch_attestations(rclient, opts: Options) -> Response:
    """reference: cosign.go:256 FetchAttestations — returns the in-toto
    statements whose signer verifies against the attestor options."""
    attestations = rclient.get_attestations(opts.image_ref)
    digest = rclient.fetch_image_descriptor(opts.image_ref).digest
    pem_attestor = _is_pem(opts.key) or _is_pem(opts.roots) or \
        _is_pem(opts.cert)
    statements = []
    for att in attestations:
        if _is_crypto_entry(att):
            try:
                payload, signature = _decode_entry(att)
                leaf = _verify_crypto_sig(att, payload, signature, opts)
                if opts.tlog_required():
                    it = _verify_tlog(att, payload, signature, opts)
                    if leaf is not None:
                        _check_cert_expiry_at(leaf, it)
                statements.append(json.loads(payload))
            except VerificationError:
                pass
            continue
        sig = {'key': att.get('key', ''), 'subject': att.get('subject', ''),
               'issuer': att.get('issuer', '')}
        if pem_attestor:
            continue
        if opts.key or opts.subject or opts.issuer:
            if not _signature_matches(sig, opts):
                continue
        statements.append(att['statement'])
    return Response(digest=digest, statements=statements)


# ---------------------------------------------------------------------------
# signing helpers (test fixtures / local signing — the produce side of the
# simple-signing model, mirroring what `cosign sign` writes to a registry)

def make_payload(image_ref: str, digest: str,
                 annotations: Optional[dict] = None) -> bytes:
    doc = {
        'critical': {
            'identity': {'docker-reference': image_ref.split('@')[0]},
            'image': {'docker-manifest-digest': digest},
            'type': 'cosign container image signature',
        },
        'optional': annotations or {},
    }
    return json.dumps(doc, sort_keys=True, separators=(',', ':')).encode()


def sign_payload(private_key, payload: bytes) -> bytes:
    """Sign payload bytes with a cryptography private key object."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import (ec, ed25519,
                                                           padding, rsa)
    if isinstance(private_key, ec.EllipticCurvePrivateKey):
        return private_key.sign(payload, ec.ECDSA(hashes.SHA256()))
    if isinstance(private_key, rsa.RSAPrivateKey):
        return private_key.sign(payload, padding.PKCS1v15(),
                                hashes.SHA256())
    if isinstance(private_key, ed25519.Ed25519PrivateKey):
        return private_key.sign(payload)
    raise TypeError(f'unsupported key type {type(private_key).__name__}')


def signature_entry(private_key, payload: bytes, cert_pem: str = '',
                    chain_pem: str = '') -> dict:
    """A registry signature entry as stored by ``cosign sign``."""
    entry = {
        'payload': base64.b64encode(payload).decode(),
        'signature': base64.b64encode(
            sign_payload(private_key, payload)).decode(),
    }
    if cert_pem:
        entry['cert'] = cert_pem
    if chain_pem:
        entry['chain'] = chain_pem
    return entry


def make_bundle(rekor_private_key, payload: bytes, signature: bytes,
                log_index: int = 1, integrated_time: Optional[int] = None,
                log_id: str = 'c0ffee', kind: str = 'hashedrekord') -> dict:
    """The offline Rekor bundle ``cosign sign`` attaches to a signature
    (test fixtures / local signing — the produce side of what
    ``_verify_tlog`` checks)."""
    import hashlib
    import time as _time
    if integrated_time is None:
        integrated_time = int(_time.time())
    if kind == 'hashedrekord':
        spec = {
            'data': {'hash': {
                'algorithm': 'sha256',
                'value': hashlib.sha256(payload).hexdigest()}},
            'signature': {'content': base64.b64encode(signature).decode()},
        }
    elif kind in ('intoto', 'dsse'):
        spec = {
            'content': {'hash': {
                'algorithm': 'sha256',
                'value': hashlib.sha256(payload).hexdigest()}},
        }
    else:  # rekord
        spec = {
            'data': {'content': base64.b64encode(payload).decode()},
            'signature': {'content': base64.b64encode(signature).decode()},
        }
    body = base64.b64encode(json.dumps({
        'apiVersion': '0.0.1', 'kind': kind, 'spec': spec,
    }, sort_keys=True, separators=(',', ':')).encode()).decode()
    bundle_payload = {
        'body': body,
        'integratedTime': integrated_time,
        'logID': log_id,
        'logIndex': log_index,
    }
    set_sig = sign_payload(rekor_private_key,
                           canonical_tlog_payload(bundle_payload))
    return {
        'SignedEntryTimestamp': base64.b64encode(set_sig).decode(),
        'Payload': bundle_payload,
    }
