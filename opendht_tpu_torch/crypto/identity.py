"""Public-key identity layer: RSA keys, X.509 certificates and their
revocation lists, hybrid encryption and the password KDF.

The port's copy of the JAX package's ``crypto/identity.py``, on the same
schemes (the reference's ``include/opendht/crypto.h``):

* sign / verify: RSA PKCS#1 v1.5 with SHA-512;
* encrypt: plain RSA PKCS#1 v1.5 for a payload of at most
  ``key_len - 11`` bytes, else an RSA-encrypted random AES key followed
  by AES-GCM (iv | ciphertext | tag);
* key id: SHA-1 of the DER SubjectPublicKeyInfo (long id: SHA-256);
* password KDF: Argon2i (t = 16, m = 64 MiB, p = 1, 32 bytes) then the
  multi-size hash, byte for byte the reference's ``stretchKey``; the
  Argon2i is the port's own (:mod:`opendht_tpu_torch.native.argon2`);
* identities: X.509 chains, ``generate_identity`` building a CA or a
  leaf signed by one, X.509 CRLs (:class:`RevocationList`).

``cryptography`` is imported where a key, a certificate or a cipher is
made or used, never at module import: without it, everything here
imports and the names that need it raise ``ImportError`` at use.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import List, Optional, Tuple

from ..utils.infohash import InfoHash

GCM_IV_SIZE = 12
GCM_DIGEST_SIZE = 16
PASSWORD_SALT_LENGTH = 16


class CryptoException(Exception):
    pass


class DecryptError(CryptoException):
    pass


def _serialization():
    from cryptography.hazmat.primitives import serialization
    return serialization


def _pkcs1():
    from cryptography.hazmat.primitives.asymmetric import padding
    return padding.PKCS1v15()


def _sha512():
    from cryptography.hazmat.primitives import hashes
    return hashes.SHA512()


def aes_key_size(max_block: int) -> int:
    """Largest AES key size that fits the RSA block."""
    for sz in (32, 24, 16):
        if max_block >= sz:
            return sz
    return 0


def aes_encrypt(data: bytes, key: bytes) -> bytes:
    """AES-GCM; the output is iv | ciphertext | tag."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    iv = os.urandom(GCM_IV_SIZE)
    return iv + AESGCM(key).encrypt(iv, data, None)


def aes_decrypt(data: bytes, key: bytes) -> bytes:
    if len(data) <= GCM_IV_SIZE + GCM_DIGEST_SIZE:
        raise DecryptError("Wrong data size")
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    try:
        return AESGCM(key).decrypt(data[:GCM_IV_SIZE], data[GCM_IV_SIZE:],
                                   None)
    except Exception as e:
        raise DecryptError("Can't decrypt data") from e


def hash_data(data: bytes, hash_len: int) -> bytes:
    """Multi-size hash: SHA-512 above 32 bytes, SHA-256 above 16, else
    SHA-1, truncated to ``hash_len``."""
    if hash_len > 32:
        h = hashlib.sha512(data).digest()
    elif hash_len > 16:
        h = hashlib.sha256(data).digest()
    else:
        h = hashlib.sha1(data).digest()
    return h[:hash_len]


def stretch_key(password: str, salt: Optional[bytes], key_length: int = 32
                ) -> Tuple[bytes, bytes]:
    """Password KDF: Argon2i (t = 16, m = 64 MiB, p = 1, 32 raw bytes),
    then :func:`hash_data` down to ``key_length``; returns the key and
    the salt (fresh when none is given)."""
    from ..native.argon2 import argon2i
    if not salt:
        salt = os.urandom(PASSWORD_SALT_LENGTH)
    raw = argon2i(password.encode("utf-8"), salt, t_cost=16,
                  m_cost=64 * 1024, lanes=1, hash_len=32)
    return hash_data(raw, key_length), salt


def password_encrypt(data: bytes, password: str) -> bytes:
    key, salt = stretch_key(password, None)
    return salt + aes_encrypt(data, key)


def password_decrypt(data: bytes, password: str) -> bytes:
    if len(data) <= PASSWORD_SALT_LENGTH:
        raise DecryptError("Wrong data size")
    key, _ = stretch_key(password, data[:PASSWORD_SALT_LENGTH])
    return aes_decrypt(data[PASSWORD_SALT_LENGTH:], key)


class PublicKey:
    __slots__ = ("_pk", "_der", "_id")

    def __init__(self, pk):
        ser = _serialization()
        self._pk = pk
        self._der = pk.public_bytes(ser.Encoding.DER,
                                    ser.PublicFormat.SubjectPublicKeyInfo)
        self._id = None

    @classmethod
    def from_packed(cls, der: bytes) -> "PublicKey":
        return cls(_serialization().load_der_public_key(der))

    def packed(self) -> bytes:
        return self._der

    def get_id(self) -> InfoHash:
        if self._id is None:
            self._id = InfoHash(hashlib.sha1(self._der).digest())
        return self._id

    def get_long_id(self) -> bytes:
        return hashlib.sha256(self._der).digest()

    def check_signature(self, data: bytes, signature: bytes) -> bool:
        try:
            self._pk.verify(signature, data, _pkcs1(), _sha512())
            return True
        except Exception:
            return False

    def encrypt(self, data: bytes) -> bytes:
        """Plain RSA up to ``key_len - 11`` bytes, else an RSA-wrapped
        AES key followed by AES-GCM."""
        max_block = self._pk.key_size // 8 - 11
        if len(data) <= max_block:
            return self._pk.encrypt(data, _pkcs1())
        aks = aes_key_size(max_block)
        if aks == 0:
            raise CryptoException("Key is not long enough for AES128")
        key = os.urandom(aks)
        return self._pk.encrypt(key, _pkcs1()) + aes_encrypt(data, key)

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self._der == other._der

    def __hash__(self):
        return hash(self._der)

    def __repr__(self):
        return f"PublicKey[{self.get_id()}]"


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

    @classmethod
    def from_der(cls, der: bytes, password: Optional[str] = None
                 ) -> "PrivateKey":
        pw = password.encode() if password else None
        return cls(_serialization().load_der_private_key(der, pw))

    def serialize(self, password: Optional[str] = None) -> bytes:
        """PKCS#8 DER, encrypted under ``password`` when one is given."""
        ser = _serialization()
        enc = (ser.BestAvailableEncryption(password.encode())
               if password else ser.NoEncryption())
        return self._sk.private_bytes(ser.Encoding.DER,
                                      ser.PrivateFormat.PKCS8, enc)

    def get_public_key(self) -> PublicKey:
        return self._pub

    def sign(self, data: bytes) -> bytes:
        return self._sk.sign(data, _pkcs1(), _sha512())

    def decrypt(self, cipher: bytes) -> bytes:
        """The inverse of :meth:`PublicKey.encrypt`."""
        block = self._sk.key_size // 8
        if len(cipher) < block:
            raise DecryptError("Unexpected cipher length")
        try:
            head = self._sk.decrypt(cipher[:block], _pkcs1())
        except Exception as e:
            raise DecryptError("RSA decrypt failed") from e
        if len(cipher) == block:
            return head
        return aes_decrypt(cipher[block:], head)


def _der_object_len(data: bytes) -> int:
    """Total length (header + body) of the DER sequence at data[0]."""
    if len(data) < 2 or data[0] != 0x30:
        raise CryptoException("bad DER sequence")
    first = data[1]
    if first < 0x80:
        return 2 + first
    nlen = first & 0x7F
    if len(data) < 2 + nlen:
        raise CryptoException("truncated DER length")
    return 2 + nlen + int.from_bytes(data[2:2 + nlen], "big")


class RevocationList:
    """An X.509 certificate revocation list: revoked certificates
    accumulate, :meth:`sign` makes the DER CRL, and ``unpack`` /
    ``get_packed`` round-trip that DER."""

    def __init__(self, packed: Optional[bytes] = None):
        self._crl = None
        self._pending: List[Tuple[int, datetime.datetime]] = []
        if packed:
            self.unpack(packed)

    def unpack(self, data: bytes) -> None:
        from cryptography import x509
        self._crl = x509.load_der_x509_crl(data)

    def get_packed(self) -> bytes:
        if self._crl is None:
            raise CryptoException("Revocation list is not signed")
        return self._crl.public_bytes(_serialization().Encoding.DER)

    def revoke(self, crt: "Certificate",
               when: Optional[datetime.datetime] = None) -> None:
        """Mark ``crt`` revoked from ``when`` (default now); it enters
        the DER form at the next :meth:`sign`."""
        when = when or datetime.datetime.now(datetime.timezone.utc)
        self._pending.append((crt._cert.serial_number, when))

    def sign(self, key: "PrivateKey", crt: "Certificate",
             validity_period: Optional[datetime.timedelta] = None) -> None:
        """Sign with the issuer's key; ``validity_period`` sets the next
        update (default ten years)."""
        from cryptography import x509
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (x509.CertificateRevocationListBuilder()
                   .issuer_name(crt._cert.subject)
                   .last_update(now)
                   .next_update(now + (validity_period
                                       or datetime.timedelta(days=365 * 10)))
                   .add_extension(
                       x509.CRLNumber(int(now.timestamp())), critical=False))
        if self._crl is not None:
            for r in self._crl:
                builder = builder.add_revoked_certificate(r)
        for serial, when in self._pending:
            builder = builder.add_revoked_certificate(
                x509.RevokedCertificateBuilder()
                .serial_number(serial).revocation_date(when).build())
        self._pending.clear()
        self._crl = builder.sign(key._sk, _sha512())

    def is_revoked(self, crt: "Certificate") -> bool:
        serial = crt._cert.serial_number
        if any(s == serial for s, _ in self._pending):
            return True
        if self._crl is None:
            return False
        return self._crl.get_revoked_certificate_by_serial_number(
            serial) is not None

    def is_signed_by(self, issuer: "Certificate") -> bool:
        if self._crl is None:
            return False
        try:
            return bool(self._crl.is_signature_valid(
                issuer._cert.public_key()))
        except Exception:
            return False

    def get_number(self) -> int:
        """The CRL number extension (0 when absent)."""
        if self._crl is None:
            return 0
        from cryptography import x509
        from cryptography.x509.oid import ExtensionOID
        try:
            ext = self._crl.extensions.get_extension_for_oid(
                ExtensionOID.CRL_NUMBER)
            return int(ext.value.crl_number)
        except x509.ExtensionNotFound:
            return 0

    def get_issuer_name(self) -> str:
        if self._crl is None:
            return ""
        from cryptography.x509.oid import NameOID
        attrs = self._crl.issuer.get_attributes_for_oid(NameOID.COMMON_NAME)
        return attrs[0].value if attrs else ""

    def get_update_time(self) -> Optional[datetime.datetime]:
        return self._crl.last_update_utc if self._crl is not None else None

    def get_next_update_time(self) -> Optional[datetime.datetime]:
        return self._crl.next_update_utc if self._crl is not None else None


class Certificate:
    """An X.509 certificate and its issuer's (``None`` when
    self-signed), with the revocation lists attached to it."""

    __slots__ = ("_cert", "issuer", "revocation_lists")

    def __init__(self, cert, issuer: Optional["Certificate"] = None):
        self._cert = cert
        self.issuer = issuer
        self.revocation_lists: List[RevocationList] = []

    @classmethod
    def from_der(cls, der: bytes) -> "Certificate":
        """A certificate, or a leaf-first chain of them, with each
        issuer linked."""
        from cryptography import x509
        certs = []
        rest = der
        while rest:
            clen = _der_object_len(rest)
            certs.append(x509.load_der_x509_certificate(rest[:clen]))
            rest = rest[clen:]
        if not certs:
            raise CryptoException("empty certificate blob")
        chain = None
        for c in reversed(certs):  # from the root down
            chain = cls(c, issuer=chain)
        return chain

    def packed(self) -> bytes:
        """The chain's DER, leaf first."""
        out = self._cert.public_bytes(_serialization().Encoding.DER)
        if self.issuer is not None:
            out += self.issuer.packed()
        return out

    def get_public_key(self) -> PublicKey:
        return PublicKey(self._cert.public_key())

    def get_id(self) -> InfoHash:
        return self.get_public_key().get_id()

    def get_name(self) -> str:
        from cryptography.x509.oid import NameOID
        attrs = self._cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        return attrs[0].value if attrs else ""

    def is_ca(self) -> bool:
        from cryptography import x509
        try:
            bc = self._cert.extensions.get_extension_for_class(
                x509.BasicConstraints)
            return bool(bc.value.ca)
        except x509.ExtensionNotFound:
            return False

    def add_revocation_list(self, crl: RevocationList) -> None:
        """Attach a CRL this (CA) certificate signed; any other is
        refused."""
        if not crl.is_signed_by(self):
            raise CryptoException("CRL is not signed by this certificate")
        self.revocation_lists.append(crl)

    def get_revocation_lists(self) -> List[RevocationList]:
        return list(self.revocation_lists)

    def is_revoked(self, crt: "Certificate") -> bool:
        """True if a CRL attached here revokes ``crt``."""
        return any(crl.is_revoked(crt) for crl in self.revocation_lists)

    def __eq__(self, other):
        return isinstance(other, Certificate) and self.packed() == other.packed()


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
    return builder.sign(signer_key, _sha512())


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
