"""TLS certificate management (reference: pkg/tls)."""

from .certs import CertRenewer, generate_ca, generate_tls_pair  # noqa: F401
