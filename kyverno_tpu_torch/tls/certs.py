"""Self-signed CA + TLS pair generation and renewal.

Mirrors the reference's certmanager (reference: pkg/tls/cert.go,
pkg/tls/renewer.go:77,109): a 10-year self-signed CA and a 1-year
server pair stored as kubernetes.io/tls Secrets, renewed when inside
the renewal window; the webhook server reads the pair per handshake and
the webhook configurations embed the CA bundle.
"""

from __future__ import annotations

import datetime
import ipaddress
from typing import List, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID

CA_VALIDITY = datetime.timedelta(days=365 * 10)   # reference: cert.go CA 10y
TLS_VALIDITY = datetime.timedelta(days=365)       # server pair 1y
RENEWAL_WINDOW = datetime.timedelta(days=15)      # renewer.go CertRenewalInterval

CA_SECRET = 'kyverno-svc.kyverno.svc.kyverno-tls-ca'
TLS_SECRET = 'kyverno-svc.kyverno.svc.kyverno-tls-pair'


def _key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _pem_cert(cert: x509.Certificate) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def _pem_key(key: rsa.RSAPrivateKey) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())


def generate_ca(now: Optional[datetime.datetime] = None
                ) -> Tuple[bytes, bytes]:
    """Self-signed CA; returns (cert_pem, key_pem)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    key = _key()
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         '*.kyverno.svc')])
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + CA_VALIDITY)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True,
                crl_sign=True, content_commitment=False,
                key_encipherment=False, data_encipherment=False,
                key_agreement=False, encipher_only=False,
                decipher_only=False), critical=True)
            .sign(key, hashes.SHA256()))
    return _pem_cert(cert), _pem_key(key)


def generate_tls_pair(ca_cert_pem: bytes, ca_key_pem: bytes,
                      service: str = 'kyverno-svc',
                      namespace: str = 'kyverno',
                      now: Optional[datetime.datetime] = None
                      ) -> Tuple[bytes, bytes]:
    """Server certificate for the webhook service DNS names."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = _key()
    dns_names: List[x509.GeneralName] = [
        x509.DNSName(service),
        x509.DNSName(f'{service}.{namespace}'),
        x509.DNSName(f'{service}.{namespace}.svc'),
    ]
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name([x509.NameAttribute(
                NameOID.COMMON_NAME, f'{service}.{namespace}.svc')]))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + TLS_VALIDITY)
            .add_extension(x509.SubjectAlternativeName(dns_names),
                           critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [x509.ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
            .sign(ca_key, hashes.SHA256()))
    return _pem_cert(cert), _pem_key(key)


def cert_expiry(cert_pem: bytes) -> datetime.datetime:
    return x509.load_pem_x509_certificate(cert_pem).not_valid_after_utc


class CertRenewer:
    """Stores/renews the CA + pair Secrets
    (reference: pkg/tls/renewer.go:77 RenewCA, :109 RenewTLS)."""

    def __init__(self, client, namespace: str = 'kyverno',
                 service: str = 'kyverno-svc'):
        self.client = client
        self.namespace = namespace
        self.service = service

    def _get_secret(self, name: str) -> Optional[dict]:
        try:
            return self.client.get_resource('v1', 'Secret',
                                            self.namespace, name)
        except Exception:  # noqa: BLE001
            return None

    def _put_secret(self, name: str, cert: bytes, key: bytes) -> dict:
        import base64
        secret = self._get_secret(name)
        data = {'tls.crt': base64.b64encode(cert).decode(),
                'tls.key': base64.b64encode(key).decode()}
        if secret is None:
            return self.client.create_resource('v1', 'Secret',
                                               self.namespace, {
                'apiVersion': 'v1', 'kind': 'Secret',
                'type': 'kubernetes.io/tls',
                'metadata': {'name': name, 'namespace': self.namespace},
                'data': data})
        secret['data'] = data
        return self.client.update_resource('v1', 'Secret',
                                           self.namespace, secret)

    def _read_secret(self, name: str) -> Optional[Tuple[bytes, bytes]]:
        import base64
        secret = self._get_secret(name)
        if secret is None:
            return None
        data = secret.get('data') or {}
        try:
            return (base64.b64decode(data['tls.crt']),
                    base64.b64decode(data['tls.key']))
        except Exception:  # noqa: BLE001
            return None

    def renew(self, now: Optional[datetime.datetime] = None
              ) -> Tuple[bytes, bytes, bytes]:
        """Ensure valid CA + pair; returns (ca_cert, tls_cert, tls_key)."""
        now = now or datetime.datetime.now(datetime.timezone.utc)
        ca = self._read_secret(CA_SECRET)
        if ca is None or cert_expiry(ca[0]) - now < RENEWAL_WINDOW:
            ca = generate_ca(now)
            self._put_secret(CA_SECRET, *ca)
            pair = None  # a new CA invalidates the old pair
        else:
            pair = self._read_secret(TLS_SECRET)
        if pair is None or cert_expiry(pair[0]) - now < RENEWAL_WINDOW:
            pair = generate_tls_pair(ca[0], ca[1], self.service,
                                     self.namespace, now)
            self._put_secret(TLS_SECRET, *pair)
        return ca[0], pair[0], pair[1]

    def ca_bundle(self) -> bytes:
        ca = self._read_secret(CA_SECRET)
        return ca[0] if ca else b''
