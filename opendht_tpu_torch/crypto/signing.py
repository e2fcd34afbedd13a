"""Sign a value, check its signature, and check a batch of them: the
JAX package's ``crypto/securedht.py`` ``sign_value``,
``check_value_signature`` and ``verify_values_batch``, shared by the
integrity plane's signature stage and :mod:`.securedht`."""

from __future__ import annotations

from typing import List

from .identity import CryptoException, PrivateKey
from ..core.value import Value


def sign_value(key: PrivateKey, v: Value) -> None:
    """Sign ``v`` in place: its owner becomes ``key``'s public key."""
    if v.is_encrypted():
        raise CryptoException("Can't sign encrypted data.")
    v.owner = key.get_public_key()
    v.signature = key.sign(v.get_to_sign())


def check_value_signature(v: Value) -> bool:
    return (v.is_signed()
            and v.owner.check_signature(v.get_to_sign(), v.signature))


def verify_values_batch(values: List[Value]) -> List[bool]:
    """One verdict per value; a malformed value verifies False and never
    aborts the batch."""
    out = []
    for v in values:
        try:
            out.append(check_value_signature(v))
        except Exception:
            out.append(False)
    return out
