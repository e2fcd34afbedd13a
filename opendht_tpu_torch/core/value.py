"""The stored datum: ``Value``, ``ValueType`` + store/edit policies, and the
Select/Where/Query remote-filtering algebra.

Re-design of the reference's value layer (ref: include/opendht/value.h:55-955,
src/value.cpp).  Wire layout (msgpack field names ``id``/``dat``/``body``/
``sig``/``seq``/``owner``/``to``/``type``/``data``/``utype``) follows the
reference's canonical forms so signatures stay byte-compatible:

* to-sign form:    value.h:424-441 (map of seq/owner/[to]/type/data/[utype])
* to-encrypt form: value.h:443-457 (cypher bin, or map body/[sig])
* wire form:       value.h:459-465 (map id/dat)

The query algebra (Field, FieldValue, Select, Where, Query) mirrors
value.h:556-882: selection (projection of fields) and where-filtering are
executed *remotely* to cut transfer — the moral equivalent of pushing a
gather mask to the device.
"""

from __future__ import annotations

import enum
import random
from typing import Callable, Dict, List, Optional, Sequence

from ..utils.mpack import packb, unpackb

from .constants import MAX_VALUE_SIZE

ValueId = int
INVALID_ID = 0


# ---------------------------------------------------------------------------
# ValueType & policies (ref: value.h:55-106, src/value.cpp:65-69)
# ---------------------------------------------------------------------------

# StorePolicy(key, value, remote_id, from_addr) -> bool
# (key = the InfoHash being stored at — ref value.h:55)
StorePolicy = Callable[[object, "Value", bytes, object], bool]
# EditPolicy(key, old_value, new_value, remote_id, from_addr) -> bool
EditPolicy = Callable[[object, "Value", "Value", bytes, object], bool]


def default_store_policy(key, value: "Value", remote_id, from_addr) -> bool:
    """Accept any value within the size cap (ref: src/value.cpp:65-69).

    Signature mirrors the reference ``StorePolicy(InfoHash key, value,
    remote node id, from addr)`` (value.h:55) — some policies (e.g. the
    certificate type) depend on the storage key.
    """
    return value.size() <= MAX_VALUE_SIZE


def default_edit_policy(key, old_value: "Value", new_value: "Value",
                        remote_id, from_addr) -> bool:
    """Refuse edits by default (ref: value.h:71-73)."""
    return False


class ValueType:
    __slots__ = ("id", "name", "expiration", "store_policy", "edit_policy")

    def __init__(self, type_id: int, name: str, expiration: float,
                 store_policy: StorePolicy = default_store_policy,
                 edit_policy: EditPolicy = default_edit_policy):
        self.id = type_id
        self.name = name
        self.expiration = float(expiration)
        self.store_policy = store_policy
        self.edit_policy = edit_policy

    def __eq__(self, other):
        return isinstance(other, ValueType) and self.id == other.id

    def __hash__(self):
        return hash(self.id)


USER_DATA = ValueType(0, "User Data", 10 * 60)


# ---------------------------------------------------------------------------
# Value (ref: value.h:117-553)
# ---------------------------------------------------------------------------

class Value:
    __slots__ = ("id", "owner", "recipient", "type", "data", "user_type",
                 "seq", "signature", "cypher", "priority")

    def __init__(self, data: bytes = b"", type_id: int = USER_DATA.id,
                 value_id: ValueId = INVALID_ID, user_type: str = ""):
        self.id = value_id
        self.owner = None          # crypto.PublicKey of the signer
        self.recipient = None      # InfoHash or None
        self.type = type_id
        self.data = bytes(data)
        self.user_type = user_type
        self.seq = 0
        self.signature = b""
        self.cypher = b""
        self.priority = 0

    # -- state predicates --------------------------------------------------
    def is_encrypted(self) -> bool:
        return len(self.cypher) > 0

    def is_signed(self) -> bool:
        return self.owner is not None and len(self.signature) > 0

    def size(self) -> int:
        return (len(self.data) + len(self.cypher) + len(self.signature)
                + len(self.user_type) + 16)

    @staticmethod
    def random_id(rng: Optional[random.Random] = None) -> ValueId:
        r = rng.getrandbits(64) if rng else random.getrandbits(64)
        return r or 1

    # -- canonical msgpack forms ------------------------------------------
    def _pack_to_sign(self) -> dict:
        """Map packed for signing — field order matters for byte-compat
        (ref: value.h:424-441)."""
        m: Dict[str, object] = {}
        has_owner = self.owner is not None
        if has_owner:
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
        return packb(self._pack_to_sign())

    def _pack_to_encrypt(self):
        if self.is_encrypted():
            return self.cypher
        m: Dict[str, object] = {"body": self._pack_to_sign()}
        if self.is_signed():
            m["sig"] = self.signature
        return m

    def get_to_encrypt(self) -> bytes:
        return packb(self._pack_to_encrypt())

    def pack(self) -> dict:
        """Full wire form (ref: value.h:459-465)."""
        return {"id": self.id, "dat": self._pack_to_encrypt()}

    def packed(self) -> bytes:
        return packb(self.pack())

    # -- unpack ------------------------------------------------------------
    @classmethod
    def unpack(cls, obj) -> "Value":
        """Parse the wire form (ref: src/value.cpp:109-160)."""
        v = cls()
        if not isinstance(obj, dict):
            raise ValueError("bad value wire form")
        v.id = int(obj.get("id", INVALID_ID))
        dat = obj.get("dat", b"")
        v._unpack_body(dat)
        return v

    def _unpack_body(self, dat) -> None:
        if isinstance(dat, (bytes, bytearray)):
            self.cypher = bytes(dat)
            return
        if not isinstance(dat, dict):
            raise ValueError("bad value body")
        body = dat.get("body", {})
        if "sig" in dat:
            self.signature = bytes(dat["sig"])
        if "seq" in body:
            self.seq = int(body["seq"])
        if "owner" in body:
            from ..crypto.identity import PublicKey
            self.owner = PublicKey.from_packed(bytes(body["owner"]))
        if "to" in body:
            from ..utils.infohash import InfoHash
            self.recipient = InfoHash(bytes(body["to"]))
        self.type = int(body.get("type", USER_DATA.id))
        self.data = bytes(body.get("data", b""))
        self.user_type = str(body.get("utype", ""))

    @classmethod
    def from_packed(cls, blob: bytes) -> "Value":
        return cls.unpack(unpackb(blob))

    # -- partial (fields-only) form (ref: value.h:468-493) ----------------
    def pack_fields(self, fields: Sequence["Field"]) -> list:
        out = []
        for f in sorted(fields, key=lambda x: x.value):
            if f == Field.Id:
                out.append(self.id)
            elif f == Field.ValueType:
                out.append(self.type)
            elif f == Field.OwnerPk:
                out.append(self.owner.packed() if self.owner else b"")
            elif f == Field.SeqNum:
                out.append(self.seq)
            elif f == Field.UserType:
                out.append(self.user_type)
        return out

    def __eq__(self, other):
        if not isinstance(other, Value):
            return False
        if self.id != other.id:
            return False
        if self.is_encrypted() or other.is_encrypted():
            return self.cypher == other.cypher
        owner_eq = (self.owner is None) == (other.owner is None) and (
            self.owner is None or self.owner.get_id() == other.owner.get_id())
        return (owner_eq and self.type == other.type and self.data == other.data
                and self.user_type == other.user_type
                and self.signature == other.signature)

    def __hash__(self):
        return hash((self.id, self.type, self.data, self.user_type))

    def __repr__(self):
        kind = "enc" if self.is_encrypted() else ("sig" if self.is_signed() else "raw")
        return f"Value[id:{self.id:016x} {kind} t:{self.type} {len(self.data)}B]"


# ---------------------------------------------------------------------------
# Filters (ref: value.h:133-173)
# ---------------------------------------------------------------------------

Filter = Callable[[Value], bool]


def f_true(_v: Value) -> bool:
    return True


def f_chain_and(a: Optional[Filter], b: Optional[Filter]) -> Filter:
    if not a:
        return b or f_true
    if not b:
        return a
    return lambda v: a(v) and b(v)


def f_value_type(tid: int) -> Filter:
    return lambda v: v.type == tid


def f_owner(owner_id) -> Filter:
    return lambda v: v.owner is not None and v.owner.get_id() == owner_id


def f_recipient(rcpt) -> Filter:
    return lambda v: v.recipient == rcpt


def f_user_type(ut: str) -> Filter:
    return lambda v: v.user_type == ut


def f_id(vid: ValueId) -> Filter:
    return lambda v: v.id == vid


def f_seq(seq: int) -> Filter:
    return lambda v: v.seq == seq


# ---------------------------------------------------------------------------
# Query algebra (ref: value.h:556-882)
# ---------------------------------------------------------------------------

class Field(enum.IntEnum):
    Nothing = 0
    Id = 1
    ValueType = 2
    OwnerPk = 3
    SeqNum = 4
    UserType = 5


class FieldValue:
    """A (field, value) equality constraint (ref: value.h:556-639)."""

    __slots__ = ("field", "int_value", "hash_value", "blob_value")

    def __init__(self, field: Field = Field.Nothing, value=None):
        self.field = Field(field)
        self.int_value = 0
        self.hash_value = None
        self.blob_value = b""
        if field in (Field.Id, Field.ValueType, Field.SeqNum):
            self.int_value = int(value)
        elif field == Field.OwnerPk:
            self.hash_value = value
        elif field == Field.UserType:
            self.blob_value = value.encode() if isinstance(value, str) else bytes(value)

    def get_local_filter(self) -> Filter:
        """ref: src/value.cpp:184-200"""
        if self.field == Field.Id:
            return f_id(self.int_value)
        if self.field == Field.ValueType:
            return f_value_type(self.int_value)
        if self.field == Field.SeqNum:
            return f_seq(self.int_value)
        if self.field == Field.OwnerPk:
            return f_owner(self.hash_value)
        if self.field == Field.UserType:
            return f_user_type(self.blob_value.decode())
        return f_true

    def pack(self):
        """Wire form {"f": field, "v": value}
        (ref FieldValue::msgpack_pack value.h:572-590)."""
        if self.field in (Field.Id, Field.ValueType, Field.SeqNum):
            return {"f": int(self.field), "v": self.int_value}
        if self.field == Field.OwnerPk:
            return {"f": int(self.field), "v": bytes(self.hash_value)}
        if self.field == Field.UserType:
            return {"f": int(self.field), "v": self.blob_value}
        return {"f": int(self.field), "v": None}

    @classmethod
    def unpack(cls, obj) -> "FieldValue":
        if isinstance(obj, dict):
            field, raw = Field(obj["f"]), obj.get("v")
        else:  # legacy [field, value] pair
            field, raw = Field(obj[0]), obj[1]
        if field == Field.OwnerPk:
            from ..utils.infohash import InfoHash
            return cls(field, InfoHash(bytes(raw)))
        if field == Field.UserType:
            return cls(field, bytes(raw))
        if field == Field.Nothing:
            return cls()
        return cls(field, int(raw))

    def __eq__(self, other):
        return (isinstance(other, FieldValue) and self.field == other.field
                and self.int_value == other.int_value
                and self.hash_value == other.hash_value
                and self.blob_value == other.blob_value)


class Select:
    """Projection: which fields to return (ref: value.h:664-712)."""

    def __init__(self, fields: Sequence[Field] = ()):
        self.fields: List[Field] = sorted(set(Field(f) for f in fields))

    def field(self, f: Field) -> "Select":
        if f not in self.fields:
            self.fields.append(f)
            self.fields.sort()
        return self

    def is_satisfied_by(self, other: "Select") -> bool:
        """True if a reply to ``other`` contains every field we select
        (ref: Select::isSatisfiedBy src/value.cpp:411-417): our selection
        must be a subset of theirs; empty = select-all can only be
        satisfied by another select-all."""
        if not self.fields and other.fields:
            return False
        return set(self.fields) <= set(other.fields) or not self.fields

    def pack(self):
        return [int(f) for f in self.fields]

    @classmethod
    def unpack(cls, obj) -> "Select":
        return cls([Field(x) for x in (obj or [])])

    def __bool__(self):
        return bool(self.fields)

    def __eq__(self, other):
        return isinstance(other, Select) and self.fields == other.fields


class Where:
    """Conjunction of equality constraints (ref: value.h:715-816)."""

    def __init__(self, filters: Sequence[FieldValue] = ()):
        self.filters: List[FieldValue] = list(filters)

    def id(self, vid: ValueId) -> "Where":
        self.filters.append(FieldValue(Field.Id, vid))
        return self

    def value_type(self, tid: int) -> "Where":
        self.filters.append(FieldValue(Field.ValueType, tid))
        return self

    def owner(self, owner_id) -> "Where":
        self.filters.append(FieldValue(Field.OwnerPk, owner_id))
        return self

    def seq(self, s: int) -> "Where":
        self.filters.append(FieldValue(Field.SeqNum, s))
        return self

    def user_type(self, ut: str) -> "Where":
        self.filters.append(FieldValue(Field.UserType, ut))
        return self

    def get_filter(self) -> Filter:
        f: Optional[Filter] = None
        for fv in self.filters:
            f = f_chain_and(f, fv.get_local_filter())
        return f or f_true

    def is_satisfied_by(self, other: "Where") -> bool:
        """True if ``other``'s constraints are a subset of ours — i.e. a
        reply filtered by ``other`` includes everything matching us
        (ref: Where::isSatisfiedBy src/value.cpp:419-421)."""
        ours = [fv.pack() for fv in self.filters]
        theirs = [fv.pack() for fv in other.filters]
        return all(c in ours for c in theirs)

    def pack(self):
        return [fv.pack() for fv in self.filters]

    @classmethod
    def unpack(cls, obj) -> "Where":
        return cls([FieldValue.unpack(x) for x in (obj or [])])

    def __bool__(self):
        return bool(self.filters)

    def __eq__(self, other):
        return isinstance(other, Where) and self.filters == other.filters


class FieldValueIndex:
    """A partial value: projection of selected fields
    (ref: value.h:883-900, src/value.cpp FieldValueIndex)."""

    __slots__ = ("index",)

    def __init__(self, value: Optional[Value] = None,
                 select: Optional["Select"] = None):
        self.index: Dict[Field, object] = {}
        if value is None:
            return
        fields = (select.fields if select and select.fields
                  else [Field.Id, Field.ValueType, Field.OwnerPk,
                        Field.SeqNum, Field.UserType])
        for f in fields:
            if f == Field.Id:
                self.index[f] = value.id
            elif f == Field.ValueType:
                self.index[f] = value.type
            elif f == Field.OwnerPk:
                self.index[f] = (value.owner.get_id() if value.owner else None)
            elif f == Field.SeqNum:
                self.index[f] = value.seq
            elif f == Field.UserType:
                self.index[f] = value.user_type

    @classmethod
    def from_fields(cls, fields: Sequence[Field], row: Sequence
                    ) -> "FieldValueIndex":
        fvi = cls()
        for f, v in zip(fields, row):
            fvi.index[Field(f)] = v
        return fvi

    def contained_in(self, other: "FieldValueIndex") -> bool:
        """True if every (field, value) here also appears in ``other``."""
        return all(other.index.get(f) == v for f, v in self.index.items())

    def __eq__(self, other):
        return isinstance(other, FieldValueIndex) and self.index == other.index

    def __repr__(self):
        return f"FieldValueIndex({self.index})"


class Query:
    """SELECT <fields> WHERE <constraints> (ref: value.h:819-880)."""

    __slots__ = ("select", "where", "none")

    def __init__(self, select: Optional[Select] = None,
                 where: Optional[Where] = None, q: str = ""):
        self.select = select or Select()
        self.where = where or Where()
        self.none = False
        if q:
            self._parse(q)

    def _parse(self, q: str) -> None:
        """Minimal SQL-ish parser (ref: value.h:838-849 ctor)."""
        toks = q.replace(",", " ").split()
        mode = None
        for tok in toks:
            up = tok.upper()
            if up == "SELECT":
                mode = "select"
            elif up == "WHERE":
                mode = "where"
            elif mode == "select":
                if up == "*":
                    continue
                name = {"ID": Field.Id, "VALUE_TYPE": Field.ValueType,
                        "OWNER_PK": Field.OwnerPk, "SEQ": Field.SeqNum,
                        "USER_TYPE": Field.UserType}.get(up)
                if name:
                    self.select.field(name)
            elif mode == "where" and "=" in tok:
                k, _, val = tok.partition("=")
                ku = k.upper()
                if ku == "ID":
                    self.where.id(int(val, 0))
                elif ku == "VALUE_TYPE":
                    self.where.value_type(int(val, 0))
                elif ku == "SEQ":
                    self.where.seq(int(val, 0))
                elif ku == "USER_TYPE":
                    self.where.user_type(val.strip("'\""))

    def is_satisfied_by(self, other: "Query") -> bool:
        """Would ``other``'s reply satisfy us?
        (ref: Query::isSatisfiedBy src/value.cpp:423-425)"""
        return self.none or (self.where.is_satisfied_by(other.where)
                             and self.select.is_satisfied_by(other.select))

    def pack(self):
        return {"s": self.select.pack(), "w": self.where.pack()}

    @classmethod
    def unpack(cls, obj) -> "Query":
        if not obj:
            return cls()
        return cls(Select.unpack(obj.get("s")), Where.unpack(obj.get("w")))

    def __bool__(self):
        return bool(self.select) or bool(self.where)

    def __eq__(self, other):
        return (isinstance(other, Query) and self.select == other.select
                and self.where == other.where)
