"""CBE, the canonical binary encoding (copy of corda_tpu/serialization/cbe.py).

Transaction ids are Merkle roots over CBE bytes, so the port's encoding
must be byte-identical to the reference's. A registered dataclass is named
``"<last module segment>.<qualname>"`` unless it passes an explicit name:
the port keeps the reference's module and class names, and every explicit
``register_custom`` name, so that its bytes, and its ids, do not change.

Grammar (one tag byte, then payload):
    0x00 None            0x01 False            0x02 True
    0x03 int             zigzag varint
    0x04 bytes           varint len + raw
    0x05 str             varint len + utf8
    0x06 list/tuple      varint count + items
    0x07 map             varint count + (key, value)*, sorted by encoded key
    0x08 object          str type-name + map of fields
    0x09 float64         8 bytes big-endian IEEE754
    0x0A set             varint count + items sorted by encoded bytes

Top-level envelope: magic ``CT`` + version byte 0x01 + value (the versioned
header mirrors the reference's ``KryoHeaderV0_1`` scheme-negotiation byte
prefix, SerializationScheme.kt).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable

MAGIC = b"CT\x01"

_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03
_T_BYTES = 0x04
_T_STR = 0x05
_T_LIST = 0x06
_T_MAP = 0x07
_T_OBJ = 0x08
_T_FLOAT = 0x09
_T_SET = 0x0A

# type-name -> (class, from_fields) registry for registered serializable types
_REGISTRY: dict[str, tuple[type, Callable[[dict], Any]]] = {}
# class -> (type-name, to_fields)
_ENCODERS: dict[type, tuple[str, Callable[[Any], dict]]] = {}


class SerializationError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class GenericRecord:
    """Decoded stand-in for a type not registered locally.

    Parity with the reference's class carpenter: a peer can send us an object
    of a type we don't have; we still get a structured, re-encodable value.
    """

    type_name: str
    fields: tuple  # tuple of (name, value) pairs, in encoded order

    def __getattr__(self, name):
        for k, v in object.__getattribute__(self, "fields"):
            if k == name:
                return v
        raise AttributeError(name)

    def as_dict(self) -> dict:
        return dict(self.fields)


def cbe_serializable(cls=None, *, name: str | None = None,
                     renamed_from: tuple = (),
                     field_aliases: dict | None = None):
    """Class decorator registering a dataclass for CBE object encoding.

    The equivalent of the reference's ``@CordaSerializable`` marker
    (core/.../serialization/SerializationAPI.kt) — but opt-in registration
    doubles as the serialization *whitelist* (CordaClassResolver parity):
    only registered types round-trip to their Python class; everything else
    surfaces as :class:`GenericRecord`.

    Evolution (the role of the reference's ``EvolutionSerializer``,
    node-api/.../serialization/amqp/EvolutionSerializer.kt — a rolling
    upgrade must let old and new versions of a type cross the wire in both
    directions without wedging either side):

    - **added field** (old writer → new reader): absent fields take the
      dataclass default; a field added *without* a default raises a clean
      ``SerializationError`` naming the type, never a bare TypeError.
    - **removed field** (old writer → new reader): unknown keys in the
      payload are dropped (the new class no longer carries them).
    - **renamed field**: ``field_aliases={"new_name": "old_name"}`` maps an
      old writer's key onto the renamed field (the
      CordaSerializationTransformRenames role).
    - **renamed type**: ``renamed_from=("old.wire.Name", ...)`` registers
      decode aliases so payloads tagged with a retired type name decode
    through the current class; encoding always uses the current name.
    """
    aliases = dict(field_aliases or {})

    def wrap(c):
        type_name = name or f"{c.__module__.split('.')[-1]}.{c.__qualname__}"
        if not dataclasses.is_dataclass(c):
            raise SerializationError(f"@cbe_serializable requires a dataclass: {c}")
        field_names = [f.name for f in dataclasses.fields(c)]

        def to_fields(obj) -> dict:
            return {fn: getattr(obj, fn) for fn in field_names}

        def from_fields(d: dict):
            known = {f.name for f in dataclasses.fields(c)}
            kwargs = {k: v for k, v in d.items() if k in known}
            for new, old in aliases.items():
                if new not in kwargs and old in d:
                    kwargs[new] = d[old]
            try:
                return c(**kwargs)
            except TypeError as e:
                raise SerializationError(
                    f"evolution mismatch decoding {type_name!r}: {e} — a "
                    "field added after a writer's version must carry a "
                    "default"
                ) from None

        _REGISTRY[type_name] = (c, from_fields)
        _ENCODERS[c] = (type_name, to_fields)
        c.__cbe_name__ = type_name
        for old_name in renamed_from:
            register_rename(old_name, c)
        return c

    return wrap(cls) if cls is not None else wrap


def register_rename(old_name: str, cls: type) -> None:
    """Alias a retired wire name onto ``cls``'s current registration, so
    payloads written by peers still running the old type name decode into
    the current class (renamed-type evolution). The current name stays the
    only one encoded."""
    current = _ENCODERS.get(cls)
    if current is None:
        raise SerializationError(
            f"{cls.__qualname__} must be registered before aliasing "
            f"{old_name!r} to it"
        )
    existing = _REGISTRY.get(old_name)
    if existing is not None and existing[0] is not cls:
        raise SerializationError(
            f"serialization name {old_name!r} already registered for "
            f"{existing[0].__qualname__}; refusing to alias to "
            f"{cls.__qualname__}"
        )
    _REGISTRY[old_name] = (cls, _REGISTRY[current[0]][1])


def register_custom(cls: type, name: str, to_fields, from_fields) -> None:
    """Register a non-dataclass type with explicit field mappers.

    Re-registering a name with a *different* class is rejected: the registry
    is the wire-format whitelist (the reference's CordaClassResolver refuses
    unregistered/ambiguous classes for the same reason), and a silent
    overwrite would let one component's encoder feed another's decoder.
    """
    existing = _REGISTRY.get(name)
    if existing is not None and existing[0] is not cls:
        raise SerializationError(
            f"serialization name {name!r} already registered for "
            f"{existing[0].__qualname__}; refusing to rebind to "
            f"{cls.__qualname__}"
        )
    _REGISTRY[name] = (cls, from_fields)
    _ENCODERS[cls] = (name, to_fields)
    cls.__cbe_name__ = name


# ---------------------------------------------------------------- varints

def _write_uvarint(buf: bytearray, n: int) -> None:
    if n < 0:
        raise SerializationError("uvarint must be non-negative")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise SerializationError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            # Canonical-form enforcement: the encoding of a value must be
            # unique, so a non-minimal final byte (0x00 continuation) is
            # rejected. Consensus-critical: tx ids hash CBE bytes.
            if b == 0 and shift > 0:
                raise SerializationError("non-minimal varint")
            return result, pos
        shift += 7
        if shift > 640:
            raise SerializationError("varint too long")


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


def _unzigzag(n: int) -> int:
    return (n >> 1) if not (n & 1) else -((n + 1) >> 1)


# ---------------------------------------------------------------- encode

def _encode(buf: bytearray, obj: Any) -> None:
    if obj is None:
        buf.append(_T_NONE)
    elif obj is True:
        buf.append(_T_TRUE)
    elif obj is False:
        buf.append(_T_FALSE)
    elif isinstance(obj, int):
        buf.append(_T_INT)
        _write_uvarint(buf, _zigzag(obj))
    elif isinstance(obj, float):
        buf.append(_T_FLOAT)
        buf += struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        buf.append(_T_BYTES)
        b = bytes(obj)
        _write_uvarint(buf, len(b))
        buf += b
    elif isinstance(obj, str):
        buf.append(_T_STR)
        b = obj.encode("utf-8")
        _write_uvarint(buf, len(b))
        buf += b
    elif type(obj) in _ENCODERS:
        type_name, to_fields = _ENCODERS[type(obj)]
        buf.append(_T_OBJ)
        nb = type_name.encode("utf-8")
        _write_uvarint(buf, len(nb))
        buf += nb
        _encode_map(buf, to_fields(obj))
    elif isinstance(obj, GenericRecord):
        buf.append(_T_OBJ)
        nb = obj.type_name.encode("utf-8")
        _write_uvarint(buf, len(nb))
        buf += nb
        _encode_map(buf, dict(obj.fields))
    elif isinstance(obj, (list, tuple)):
        buf.append(_T_LIST)
        _write_uvarint(buf, len(obj))
        for item in obj:
            _encode(buf, item)
    elif isinstance(obj, dict):
        _encode_map(buf, obj)
    elif isinstance(obj, (set, frozenset)):
        buf.append(_T_SET)
        _write_uvarint(buf, len(obj))
        encoded = sorted(encode(item) for item in obj)
        for e in encoded:
            buf += e
    else:
        raise SerializationError(
            f"type {type(obj).__name__} is not CBE-serializable (register it "
            f"with @cbe_serializable)"
        )


def _encode_map(buf: bytearray, d: dict) -> None:
    buf.append(_T_MAP)
    _write_uvarint(buf, len(d))
    entries = sorted((encode(k), encode(v)) for k, v in d.items())
    for ek, ev in entries:
        buf += ek
        buf += ev


def encode(obj: Any) -> bytes:
    """Encode a single value, without the envelope."""
    buf = bytearray()
    _encode(buf, obj)
    return bytes(buf)


def serialize(obj: Any) -> bytes:
    """Encode with the versioned envelope — the public entry point."""
    return MAGIC + encode(obj)


# ---------------------------------------------------------------- decode

def _decode(data: bytes, pos: int) -> tuple[Any, int]:
    if pos >= len(data):
        raise SerializationError("truncated value")
    tag = data[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        n, pos = _read_uvarint(data, pos)
        return _unzigzag(n), pos
    if tag == _T_FLOAT:
        if pos + 8 > len(data):
            raise SerializationError("truncated float")
        return struct.unpack(">d", data[pos:pos + 8])[0], pos + 8
    if tag == _T_BYTES:
        n, pos = _read_uvarint(data, pos)
        if pos + n > len(data):
            raise SerializationError("truncated bytes")
        return data[pos:pos + n], pos + n
    if tag == _T_STR:
        n, pos = _read_uvarint(data, pos)
        if pos + n > len(data):
            raise SerializationError("truncated str")
        return data[pos:pos + n].decode("utf-8"), pos + n
    if tag == _T_LIST:
        n, pos = _read_uvarint(data, pos)
        items = []
        for _ in range(n):
            item, pos = _decode(data, pos)
            items.append(item)
        return items, pos
    if tag == _T_SET:
        n, pos = _read_uvarint(data, pos)
        items = []
        prev_enc = None
        for _ in range(n):
            start = pos
            item, pos = _decode(data, pos)
            enc = data[start:pos]
            if prev_enc is not None and enc <= prev_enc:
                raise SerializationError("non-canonical set: items not strictly sorted")
            prev_enc = enc
            items.append(item)
        return frozenset(items), pos
    if tag == _T_MAP:
        n, pos = _read_uvarint(data, pos)
        d = {}
        prev_enc = None
        for _ in range(n):
            start = pos
            k, pos = _decode(data, pos)
            enc = data[start:pos]
            if prev_enc is not None and enc <= prev_enc:
                raise SerializationError("non-canonical map: keys not strictly sorted")
            prev_enc = enc
            v, pos = _decode(data, pos)
            d[k] = v
        return d, pos
    if tag == _T_OBJ:
        n, pos = _read_uvarint(data, pos)
        type_name = data[pos:pos + n].decode("utf-8")
        pos += n
        fields, pos = _decode(data, pos)
        if not isinstance(fields, dict):
            raise SerializationError("object fields must be a map")
        if type_name in _REGISTRY:
            _, from_fields = _REGISTRY[type_name]
            return from_fields(fields), pos
        # Map decode already enforced canonical key order, so insertion order
        # IS the encoded order (and mixed-type keys must not crash here).
        return GenericRecord(type_name, tuple(fields.items())), pos
    raise SerializationError(f"unknown CBE tag 0x{tag:02x}")


def decode(data: bytes) -> Any:
    obj, pos = _decode(data, 0)
    if pos != len(data):
        raise SerializationError(f"{len(data) - pos} trailing bytes")
    return obj


def deserialize(data: bytes) -> Any:
    if data[:3] != MAGIC:
        raise SerializationError("bad CBE envelope magic")
    return decode(data[3:])
