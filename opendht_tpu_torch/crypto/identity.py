"""RSA keys and a self-signed identity, for signing values.

The port's own minimal copy of the JAX package's ``crypto/identity.py``
(RSA PKCS#1 v1.5 signatures over SHA-512, keys packed as DER
SubjectPublicKeyInfo, X.509 certificates signed with SHA-512): only
``PublicKey``, ``PrivateKey``, ``Certificate``, ``Identity`` and
``generate_identity``.  ``cryptography`` is imported where a key or a
certificate is made or used, never at module import.
"""

from __future__ import annotations

import datetime
from typing import Optional


class CryptoException(Exception):
    pass


def _serialization():
    from cryptography.hazmat.primitives import serialization
    return serialization


def _pkcs1_sha512():
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding
    return padding.PKCS1v15(), hashes.SHA512()


class PublicKey:
    __slots__ = ("_pk", "_der")

    def __init__(self, pk):
        ser = _serialization()
        self._pk = pk
        self._der = pk.public_bytes(ser.Encoding.DER,
                                    ser.PublicFormat.SubjectPublicKeyInfo)

    @classmethod
    def from_packed(cls, der: bytes) -> "PublicKey":
        return cls(_serialization().load_der_public_key(der))

    def packed(self) -> bytes:
        return self._der

    def check_signature(self, data: bytes, signature: bytes) -> bool:
        try:
            self._pk.verify(signature, data, *_pkcs1_sha512())
            return True
        except Exception:
            return False

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self._der == other._der

    def __hash__(self):
        return hash(self._der)


class PrivateKey:
    __slots__ = ("_sk", "_pub")

    def __init__(self, sk):
        self._sk = sk
        self._pub = PublicKey(sk.public_key())

    @classmethod
    def generate(cls, key_length: int = 4096) -> "PrivateKey":
        from cryptography.hazmat.primitives.asymmetric import rsa
        return cls(rsa.generate_private_key(public_exponent=65537,
                                            key_size=key_length))

    def get_public_key(self) -> PublicKey:
        return self._pub

    def sign(self, data: bytes) -> bytes:
        return self._sk.sign(data, *_pkcs1_sha512())


class Certificate:
    """An X.509 certificate and its issuer's (``None`` when
    self-signed)."""

    __slots__ = ("_cert", "issuer")

    def __init__(self, cert, issuer: Optional["Certificate"] = None):
        self._cert = cert
        self.issuer = issuer

    def packed(self) -> bytes:
        """The chain's DER, leaf first."""
        out = self._cert.public_bytes(_serialization().Encoding.DER)
        if self.issuer is not None:
            out += self.issuer.packed()
        return out

    def get_public_key(self) -> PublicKey:
        return PublicKey(self._cert.public_key())

    def get_name(self) -> str:
        from cryptography.x509.oid import NameOID
        attrs = self._cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        return attrs[0].value if attrs else ""


class Identity:
    """A (private key, certificate) pair."""

    __slots__ = ("key", "certificate")

    def __init__(self, key: Optional[PrivateKey] = None,
                 certificate: Optional[Certificate] = None):
        self.key = key
        self.certificate = certificate

    def __bool__(self):
        return self.key is not None and self.certificate is not None


def _build_cert(name: str, pubkey, signer_key, issuer_name: str,
                is_ca: bool):
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.x509.oid import NameOID
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)])
    issuer = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, issuer_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    builder = (x509.CertificateBuilder()
               .subject_name(subject)
               .issuer_name(issuer)
               .public_key(pubkey)
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(days=1))
               .not_valid_after(now + datetime.timedelta(days=365 * 10))
               .add_extension(
                   x509.BasicConstraints(ca=is_ca, path_length=None),
                   critical=True))
    return builder.sign(signer_key, hashes.SHA512())


def generate_identity(name: str = "dhtnode", ca: Optional[Identity] = None,
                      key_length: int = 4096) -> Identity:
    """A fresh key with a certificate signed by ``ca``'s key, or a
    self-signed CA certificate when no ``ca`` is given."""
    key = PrivateKey.generate(key_length)
    if ca and ca.key:
        cert = _build_cert(name, key._sk.public_key(), ca.key._sk,
                           ca.certificate.get_name(), is_ca=False)
        return Identity(key, Certificate(cert, issuer=ca.certificate))
    cert = _build_cert(name, key._sk.public_key(), key._sk, name, is_ca=True)
    return Identity(key, Certificate(cert))
