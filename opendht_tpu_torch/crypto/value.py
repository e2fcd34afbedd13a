"""The signed fields of a stored value and their canonical packing.

Only what signing reads, copied from the JAX package's
``core/value.py``: the fields, ``is_signed`` / ``is_encrypted``, the
to-sign map (``seq``, ``owner``, ``to``, ``type``, ``data``,
``utype``, in that order, so signatures stay byte-compatible with the
reference's ``Value::getToSign``) and the wire form.  ``msgpack`` is
imported when a value is packed, not before.
"""

from __future__ import annotations

from typing import Dict

USER_DATA_TYPE = 0
INVALID_ID = 0


def _packb(obj) -> bytes:
    import msgpack
    return msgpack.packb(obj)


class Value:
    __slots__ = ("id", "owner", "recipient", "type", "data", "user_type",
                 "seq", "signature", "cypher", "priority")

    def __init__(self, data: bytes = b"", type_id: int = USER_DATA_TYPE,
                 value_id: int = INVALID_ID, user_type: str = ""):
        self.id = value_id
        self.owner = None          # identity.PublicKey of the signer
        self.recipient = None      # 20-byte id or None
        self.type = type_id
        self.data = bytes(data)
        self.user_type = user_type
        self.seq = 0
        self.signature = b""
        self.cypher = b""
        self.priority = 0

    def is_encrypted(self) -> bool:
        return len(self.cypher) > 0

    def is_signed(self) -> bool:
        return self.owner is not None and len(self.signature) > 0

    def _pack_to_sign(self) -> dict:
        """The map that is signed; the field order is part of the
        signed bytes."""
        m: Dict[str, object] = {}
        if self.owner is not None:
            m["seq"] = self.seq
            m["owner"] = self.owner.packed()
            if self.recipient:
                m["to"] = bytes(self.recipient)
        m["type"] = self.type
        m["data"] = self.data
        if self.user_type:
            m["utype"] = self.user_type
        return m

    def get_to_sign(self) -> bytes:
        return _packb(self._pack_to_sign())

    def _pack_to_encrypt(self):
        if self.is_encrypted():
            return self.cypher
        m: Dict[str, object] = {"body": self._pack_to_sign()}
        if self.is_signed():
            m["sig"] = self.signature
        return m

    def pack(self) -> dict:
        """The wire form: ``{"id": ..., "dat": ...}``."""
        return {"id": self.id, "dat": self._pack_to_encrypt()}

    def packed(self) -> bytes:
        return _packb(self.pack())
