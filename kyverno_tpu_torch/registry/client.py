"""Mock + protocol registry client (reference: pkg/registryclient/client.go).

The interface is the plugin boundary: ``fetch_image_descriptor`` resolves
a ref to its manifest digest; the cosign layer additionally reads the
signature/attestation payloads this store holds per image.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class RegistryError(Exception):
    """Registry access failure (maps to cosign rule-level errors)."""


class Descriptor:
    __slots__ = ('digest',)

    def __init__(self, digest: str):
        self.digest = digest


class MockRegistryClient:
    """In-memory registry: image ref (with or without tag/digest) →
    {digest, signatures: [keyid...], attestations: [in-toto statements]}.

    ``add_image`` registers an image; ``sign`` attaches signature key ids;
    ``attest`` attaches in-toto statements ({predicateType, predicate}).
    """

    def __init__(self):
        self._images: Dict[str, dict] = {}

    # -- setup ---------------------------------------------------------------

    def add_image(self, ref: str, digest: str) -> None:
        self._images[self._norm(ref)] = {
            'digest': digest, 'signatures': [], 'attestations': []}

    def sign(self, ref: str, key_id: str,
             subject: str = '', issuer: str = '') -> None:
        entry = self._entry(ref)
        entry['signatures'].append(
            {'key': key_id, 'subject': subject, 'issuer': issuer})

    def attest(self, ref: str, statement: dict,
               key_id: str = '') -> None:
        entry = self._entry(ref)
        entry['attestations'].append({'key': key_id, 'statement': statement})

    def add_signature(self, ref: str, entry: dict) -> None:
        """Attach a cryptographic signature entry (payload/signature[/cert])
        as produced by cosign.signature_entry."""
        self._entry(ref)['signatures'].append(entry)

    def add_attestation(self, ref: str, entry: dict) -> None:
        self._entry(ref)['attestations'].append(entry)

    # -- client interface ----------------------------------------------------

    def fetch_image_descriptor(self, ref: str) -> Descriptor:
        """reference: registryclient.Client.FetchImageDescriptor"""
        return Descriptor(self._entry(ref)['digest'])

    def get_signatures(self, ref: str) -> List[dict]:
        return list(self._entry(ref)['signatures'])

    def get_attestations(self, ref: str) -> List[dict]:
        return list(self._entry(ref)['attestations'])

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _norm(ref: str) -> str:
        # strip digest/tag so lookups by name, name:tag and name@digest all
        # resolve to the same entry
        if '@' in ref:
            ref = ref.split('@', 1)[0]
        last_slash = ref.rfind('/')
        colon = ref.rfind(':')
        if colon > last_slash:
            ref = ref[:colon]
        return ref

    def _entry(self, ref: str) -> dict:
        entry = self._images.get(self._norm(ref))
        if entry is None:
            raise RegistryError(f'image not found in registry: {ref}')
        return entry
