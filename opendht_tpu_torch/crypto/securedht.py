"""SecureDht: the public-key crypto overlay on the host Kademlia node.

The port's copy of the JAX package's ``crypto/securedht.py`` (the
reference's ``class SecureDht : public Dht``):

* the node id comes from the identity's certificate
  (``InfoHash.get("node:" + cert id)``);
* the node's certificate is announced as a permanent put at the
  certificate's own key id;
* ``secure_type`` wraps the registered value types: the store policy
  verifies signed values, the edit policy keeps the owner and takes a
  value only at a rising ``seq``;
* ``get`` / ``listen`` pass every value through a filter that verifies
  signed values, decrypts values encrypted for this node and passes
  plain values through;
* ``put_signed`` bumps ``seq`` above any value of the same id known
  here or on the network, then signs;
* ``put_encrypted`` finds the recipient's public key over the network,
  then signs and encrypts;
* certificate and public-key caches, with a pluggable local certificate
  store.

Signing and checking are :mod:`.signing`'s, which the integrity plane
shares.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core.dht import Dht, DhtConfig, DoneCallback, GetCallback
from ..core.default_types import CERTIFICATE_TYPE_ID
from ..core.value import Filter, Value, ValueType, Where, f_id
from ..utils.infohash import InfoHash
from ..utils.logger import NONE, Logger
from ..utils.mpack import unpackb
from .identity import (
    Certificate,
    CryptoException,
    DecryptError,
    Identity,
    PrivateKey,
    PublicKey,
)
from .signing import check_value_signature, sign_value

CertificateCallback = Callable[[Optional[Certificate]], None]
PublicKeyCallback = Callable[[Optional[PublicKey]], None]


def encrypt_value(v: Value, from_key: PrivateKey, to: PublicKey) -> Value:
    """Sign ``v`` with ``from_key`` and return the version encrypted for
    ``to`` (ref: Value::encrypt value.h:327-335)."""
    if v.is_encrypted():
        raise CryptoException("Data is already encrypted.")
    v.recipient = to.get_id()
    sign_value(from_key, v)
    nv = Value(value_id=v.id)
    nv.cypher = to.encrypt(v.get_to_encrypt())
    return nv


def make_certificate_type() -> ValueType:
    """Type 8: a certificate is only storable at its public key's id
    (ref: include/opendht/securedht.h:166-183)."""
    def store(key, value: Value, remote_id, from_addr) -> bool:
        try:
            crt = Certificate.from_der(value.data)
            return crt.get_id() == key
        except Exception:
            return False

    def edit(key, old: Value, new: Value, remote_id, from_addr) -> bool:
        try:
            return (Certificate.from_der(old.data).get_id()
                    == Certificate.from_der(new.data).get_id())
        except Exception:
            return False

    return ValueType(CERTIFICATE_TYPE_ID, "Certificate", 7 * 24 * 3600,
                     store_policy=store, edit_policy=edit)


class SecureDhtConfig:
    """ref: SecureDht::Config include/opendht/securedht.h:48-52."""

    def __init__(self, node_config: Optional[DhtConfig] = None,
                 identity: Optional[Identity] = None):
        self.node_config = node_config or DhtConfig()
        self.identity = identity or Identity()


def _node_config(conf: SecureDhtConfig) -> DhtConfig:
    c = conf.node_config
    if c.node_id is None or not c.node_id:
        ident = conf.identity
        if ident and ident.certificate is not None:
            cert_id = ident.certificate.get_id()
            c.node_id = InfoHash.get("node:" + str(cert_id))
        else:
            c.node_id = InfoHash.get_random()
    return c


class SecureDht(Dht):
    """Dht subclass adding transparent signing/encryption."""

    def __init__(self, transport4=None, transport6=None,
                 config: Optional[SecureDhtConfig] = None,
                 scheduler=None, logger: Logger = NONE, rng=None):
        config = config or SecureDhtConfig()
        super().__init__(transport4, transport6, _node_config(config),
                         scheduler, logger, rng)
        self.key: Optional[PrivateKey] = config.identity.key
        self.certificate: Optional[Certificate] = config.identity.certificate

        self.nodes_certificates: Dict[InfoHash, Certificate] = {}
        self.trusted_certificates: List[Certificate] = []
        self.nodes_pubkeys: Dict[InfoHash, PublicKey] = {}
        # Pluggable local certificate store
        # (ref: setLocalCertificateStore securedht.h:153-156)
        self.local_query_method: Optional[
            Callable[[InfoHash], List[Certificate]]] = None

        # Secure the default types already registered by Dht — all but
        # IpServiceAnnouncement (the single DEFAULT_INSECURE_TYPE,
        # src/default_types.cpp:103-106) — and add the certificate type
        # (insecure: its own store policy rules).
        for t in list(self.types.values()):
            if t.id != 2:
                super().register_type(self.secure_type(t))
        super().register_type(make_certificate_type())

        if self.certificate is not None:
            cert_id = self.certificate.get_id()
            if (self.key is not None
                    and cert_id != self.key.get_public_key().get_id()):
                raise CryptoException(
                    "SecureDht: certificate doesn't match private key.")
            v = Value(self.certificate.packed(), CERTIFICATE_TYPE_ID,
                      value_id=1)
            super().put(cert_id, v, None, None, True)

    def get_id(self) -> Optional[InfoHash]:
        """Id of our public key (not the node id)
        (ref: SecureDht::getId securedht.h:62-64)."""
        return self.key.get_public_key().get_id() if self.key else None

    # ------------------------------------------------------------------ #
    # type wrapping                                                      #
    # ------------------------------------------------------------------ #

    def register_type(self, t: ValueType) -> None:
        super().register_type(self.secure_type(t))

    def register_insecure_type(self, t: ValueType) -> None:
        super().register_type(t)

    def secure_type(self, t: ValueType) -> ValueType:
        """ref: SecureDht::secureType src/securedht.cpp:80-118."""
        base_store, base_edit = t.store_policy, t.edit_policy

        def store(key, value: Value, remote_id, from_addr) -> bool:
            if value.is_signed() and not check_value_signature(value):
                self.log.w("Signature verification failed")
                return False
            return base_store(key, value, remote_id, from_addr)

        def edit(key, old: Value, new: Value, remote_id, from_addr) -> bool:
            if not old.is_signed():
                return base_edit(key, old, new, remote_id, from_addr)
            if not (new.owner is not None and old.owner == new.owner):
                self.log.w("Edition forbidden: owner changed.")
                return False
            if not old.owner.check_signature(new.get_to_sign(),
                                             new.signature):
                self.log.w("Edition forbidden: signature failed.")
                return False
            if old.seq == new.seq:
                # Identical data may be reannounced, possibly by others.
                return old.get_to_sign() == new.get_to_sign()
            return new.seq > old.seq

        return ValueType(t.id, t.name, t.expiration, store_policy=store,
                         edit_policy=edit)

    # ------------------------------------------------------------------ #
    # certificate discovery                                              #
    # ------------------------------------------------------------------ #

    def add_trusted_certificate(self, cert: Certificate) -> None:
        """Register a trust-anchor (CA) certificate whose CRLs are
        consulted when importing certificates — the local trust-list
        role gnutls plays in the reference (crypto.h:386-389).
        Already-cached certificates the new anchor revokes are
        evicted, so revocation applies retroactively."""
        self.trusted_certificates.append(cert)
        self.nodes_certificates = {
            cid: crt for cid, crt in self.nodes_certificates.items()
            if not cert.is_revoked(crt)}

    def is_certificate_revoked(self, crt: Certificate) -> bool:
        """True if any CRL attached to the cert's issuer chain, to our
        own trust chain, or to a registered trust anchor revokes it
        (the gnutls chain verification with CRLs the reference performs
        on import, ref src/crypto.cpp:520-680, crypto.h:386-389)."""
        anchors = list(self.trusted_certificates)
        c = crt.issuer
        while c is not None:
            anchors.append(c)
            c = c.issuer
        own = self.certificate
        while own is not None:
            anchors.append(own)
            own = own.issuer
        return any(a.is_revoked(crt) for a in anchors)

    def register_certificate(self, cert: Certificate) -> InfoHash:
        if self.is_certificate_revoked(cert):
            raise CryptoException("certificate is revoked")
        cid = cert.get_id()
        self.nodes_certificates[cid] = cert
        return cid

    def get_certificate(self, h: InfoHash) -> Optional[Certificate]:
        if self.certificate is not None and self.certificate.get_id() == h:
            return self.certificate
        return self.nodes_certificates.get(h)

    def get_public_key(self, h: InfoHash) -> Optional[PublicKey]:
        if self.key is not None and self.get_id() == h:
            return self.key.get_public_key()
        pk = self.nodes_pubkeys.get(h)
        if pk is None:
            crt = self.get_certificate(h)
            if crt is not None:
                pk = crt.get_public_key()
        return pk

    def find_certificate(self, h: InfoHash,
                         cb: CertificateCallback) -> None:
        """ref: SecureDht::findCertificate src/securedht.cpp:134-180."""
        crt = self.get_certificate(h)
        if crt is not None:
            cb(crt)
            return
        if self.local_query_method is not None:
            res = self.local_query_method(h)
            if res:
                try:
                    # Same import gate as the network path — the local
                    # store may hold since-revoked certificates.
                    self.register_certificate(res[0])
                except CryptoException:
                    cb(None)
                    return
                cb(res[0])
                return

        state = {"found": None}

        def on_values(values: List[Value]) -> bool:
            for v in values:
                if v.type != CERTIFICATE_TYPE_ID:
                    continue
                try:
                    crt = Certificate.from_der(v.data)
                except Exception:
                    continue
                if crt.get_id() == h:
                    try:
                        self.register_certificate(crt)
                    except Exception:
                        continue  # revoked: keep looking
                    state["found"] = crt
                    return False  # stop the get
            return True

        def on_done(ok: bool, nodes) -> None:
            cb(state["found"])

        super().get(h, on_values, on_done,
                    f=lambda v: v.type == CERTIFICATE_TYPE_ID)

    def find_public_key(self, h: InfoHash, cb: PublicKeyCallback) -> None:
        """ref: SecureDht::findPublicKey src/securedht.cpp:182-200."""
        pk = self.get_public_key(h)
        if pk is not None:
            cb(pk)
            return

        def on_cert(crt: Optional[Certificate]) -> None:
            if crt is None:
                cb(None)
                return
            pk = crt.get_public_key()
            self.nodes_pubkeys[pk.get_id()] = pk
            cb(pk)

        self.find_certificate(h, on_cert)

    # ------------------------------------------------------------------ #
    # secure operations                                                  #
    # ------------------------------------------------------------------ #

    def _callback_filter(self, cb: Optional[GetCallback],
                         f: Optional[Filter]) -> GetCallback:
        """ref: getCallbackFilter src/securedht.cpp:237-279."""
        def wrapped(values: List[Value]) -> bool:
            out = []
            for v in values:
                if v.is_encrypted():
                    if self.key is None:
                        continue
                    try:
                        dv = self.decrypt(v)
                    except Exception as e:
                        self.log.w("Could not decrypt value: %s", e)
                        continue
                    if dv.recipient == self.get_id():
                        self.nodes_pubkeys[dv.owner.get_id()] = dv.owner
                        if f is None or f(dv):
                            out.append(dv)
                elif v.is_signed():
                    if check_value_signature(v):
                        self.nodes_pubkeys[v.owner.get_id()] = v.owner
                        if f is None or f(v):
                            out.append(v)
                    else:
                        self.log.w("Signature verification failed")
                else:
                    if f is None or f(v):
                        out.append(v)
            if cb is not None and out:
                return cb(out)
            return True
        return wrapped

    def get(self, info_hash: InfoHash, get_cb: Optional[GetCallback],
            done_cb: Optional[DoneCallback] = None,
            f: Optional[Filter] = None,
            where: Optional[Where] = None) -> None:
        super().get(info_hash, self._callback_filter(get_cb, f), done_cb,
                    None, where)

    def listen(self, info_hash: InfoHash, cb: GetCallback,
               f: Optional[Filter] = None,
               where: Optional[Where] = None) -> int:
        return super().listen(info_hash, self._callback_filter(cb, f),
                              None, where)

    def put_signed(self, info_hash: InfoHash, value: Value,
                   done_cb: Optional[DoneCallback] = None,
                   permanent: bool = False) -> None:
        """ref: SecureDht::putSigned src/securedht.cpp:293-328."""
        if self.key is None:
            raise CryptoException("putSigned needs a private key")
        if value.id == 0:
            value.id = Value.random_id(self.rng)

        # Already announcing this value?  Bump above its seq.
        p = self.get_put(info_hash, value.id)
        if p is not None and value.seq <= p.seq:
            value.seq = p.seq + 1

        my_id = self.get_id()

        def on_values(vals: List[Value]) -> bool:
            for v in vals:
                if not v.is_signed():
                    self.log.e("Existing non-signed value at this key.")
                elif v.owner is None or v.owner.get_id() != my_id:
                    self.log.e("Existing signed value owned by another.")
                elif value.seq <= v.seq:
                    value.seq = v.seq + 1
            return True

        def on_done(ok: bool, nodes) -> None:
            sign_value(self.key, value)
            super(SecureDht, self).put(info_hash, value, done_cb, None,
                                       permanent)

        self.get(info_hash, on_values, on_done, f=f_id(value.id))

    def put_encrypted(self, info_hash: InfoHash, to: InfoHash,
                      value: Value,
                      done_cb: Optional[DoneCallback] = None,
                      permanent: bool = False) -> None:
        """ref: SecureDht::putEncrypted src/securedht.cpp:330-348."""
        if self.key is None:
            raise CryptoException("putEncrypted needs a private key")
        if value.id == 0:
            value.id = Value.random_id(self.rng)

        def on_pk(pk: Optional[PublicKey]) -> None:
            if pk is None:
                if done_cb:
                    done_cb(False, [])
                return
            try:
                ev = encrypt_value(value, self.key, pk)
            except Exception as e:
                self.log.e("Error encrypting data: %s", e)
                if done_cb:
                    done_cb(False, [])
                return
            super(SecureDht, self).put(info_hash, ev, done_cb, None,
                                       permanent)

        self.find_public_key(to, on_pk)

    def decrypt(self, v: Value) -> Value:
        """ref: SecureDht::decrypt src/securedht.cpp:362-380."""
        if not v.is_encrypted():
            raise CryptoException("Data is not encrypted.")
        plain = self.key.decrypt(v.cypher)
        ret = Value(value_id=v.id)
        obj = unpackb(plain)
        ret._unpack_body(obj)
        if ret.recipient != self.get_id():
            raise DecryptError("Recipient mismatch")
        if not check_value_signature(ret):
            raise DecryptError("Signature mismatch")
        return ret
