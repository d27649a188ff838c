"""Signature/attestation verification (reference: pkg/cosign).

Network sigstore verification is environment-gated; the verification
*logic* (attestor option building, key/keyless matching, statement
decoding) runs against whatever registry client is plugged in.
"""

from .cosign import (  # noqa: F401
    Options, Response, fetch_attestations, verify_signature,
)
