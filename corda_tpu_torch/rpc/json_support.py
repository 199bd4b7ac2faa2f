"""JSON (de)serialization for framework types — the client/jackson tier (the port's copy of
corda_tpu/rpc/json_support.py, import root changed).

Capability parity with the reference's JacksonSupport
(client/jackson/.../JacksonSupport.kt:40-180): a mapper that renders the
platform's core types in human-usable JSON forms and parses them back,
with PARTIES resolved through a pluggable backend — the identity service
in-process, or live RPC for remote clients (RpcObjectMapper /
IdentityObjectMapper / NoPartyObjectMapper roles).

Wire forms (matching the reference serializers' shapes):

- ``SecureHash``     → hex string
- ``PublicKey``      → ``"<scheme_id>:<hex>"``
- ``CordaX500Name``  → X.500 string (``"O=Bank A, L=London, C=GB"``)
- ``Party``          → its X.500 string (deserialized via resolution)
- ``AnonymousParty`` → its key form
- ``Amount``         → ``"<quantity> <product>"`` for plain tokens
                       (AmountDeserializer's string form), structural
                       object for Issued tokens
- ``StateRef``       → ``"<txhash>(<index>)"``
- ``bytes``          → base64
- dataclasses        → ``{field: value}`` objects (+ ``"@type"`` tag for
                       CBE-registered classes, so parsing is type-driven)
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import typing

from corda_tpu_torch.crypto import SecureHash
from corda_tpu_torch.crypto.keys import PublicKey
from corda_tpu_torch.ledger import (
    Amount,
    AnonymousParty,
    CordaX500Name,
    Party,
    StateRef,
)
from corda_tpu_torch.serialization.cbe import _ENCODERS, _REGISTRY


class JsonSerializationError(Exception):
    pass


class JsonMapper:
    """The NoPartyObjectMapper tier: serializes everything, refuses to
    DESERIALIZE parties (no resolution backend)."""

    # ------------------------------------------------------------ writing

    def to_json_value(self, obj):
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        if isinstance(obj, SecureHash):
            return str(obj)
        if isinstance(obj, PublicKey):
            return f"{obj.scheme_id}:{obj.encoded.hex()}"
        if isinstance(obj, CordaX500Name):
            return str(obj)
        if isinstance(obj, Party):
            return str(obj)
        if isinstance(obj, AnonymousParty):
            # key form (reference: AnonymousPartySerializer writes the key,
            # not the display string — it must parse back)
            return self.to_json_value(obj.owning_key)
        if isinstance(obj, StateRef):
            return str(obj)
        if isinstance(obj, Amount):
            if isinstance(obj.token, str):
                return f"{obj.quantity} {obj.token}"
            return {
                "quantity": obj.quantity,
                "token": self.to_json_value(obj.token),
            }
        if isinstance(obj, (bytes, bytearray)):
            return base64.b64encode(bytes(obj)).decode()
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, dict):
            return {str(k): self.to_json_value(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple, set, frozenset)):
            return [self.to_json_value(x) for x in obj]
        if dataclasses.is_dataclass(obj):
            out = {}
            reg = _ENCODERS.get(type(obj))
            if reg is not None:
                out["@type"] = reg[0]
            for f in dataclasses.fields(obj):
                out[f.name] = self.to_json_value(getattr(obj, f.name))
            return out
        # objects exposing their registered-field form (e.g. CBE customs
        # that are not dataclasses)
        reg = _ENCODERS.get(type(obj))
        if reg is not None:
            name, to_fields = reg
            out = {"@type": name}
            for k, v in to_fields(obj).items():
                out[k] = self.to_json_value(v)
            return out
        raise JsonSerializationError(
            f"no JSON form for {type(obj).__name__}"
        )

    def to_json(self, obj, **kwargs) -> str:
        return json.dumps(self.to_json_value(obj), **kwargs)

    # ------------------------------------------------------------ parties

    def well_known_party_from_x500_name(self, name: CordaX500Name):
        raise JsonSerializationError(
            "this mapper cannot resolve parties — use an identity- or "
            "RPC-backed mapper"
        )

    def party_from_key(self, key: PublicKey):
        raise JsonSerializationError(
            "this mapper cannot resolve parties — use an identity- or "
            "RPC-backed mapper"
        )

    # ------------------------------------------------------------ reading

    def parse(self, value, cls):
        """Parse a JSON value (already json.loads'ed) as ``cls``."""
        origin = typing.get_origin(cls)
        if origin in (list, tuple, set, frozenset):
            args = typing.get_args(cls) or (object,)
            item_cls = args[0]
            seq = [self.parse(v, item_cls) for v in value]
            return origin(seq) if origin is not list else seq
        if origin is dict:
            kt, vt = (typing.get_args(cls) or (str, object))[:2]
            return {
                self.parse(k, kt): self.parse(v, vt)
                for k, v in value.items()
            }
        if origin is typing.Union or str(origin) == "types.UnionType":
            last_err = None
            for alt in typing.get_args(cls):
                if alt is type(None):
                    if value is None:
                        return None
                    continue
                try:
                    return self.parse(value, alt)
                except Exception as e:
                    last_err = e
            raise JsonSerializationError(f"no union arm matched: {last_err}")
        if cls in (object, typing.Any) or cls is None:
            return value
        if cls in (list, tuple, set, frozenset):  # unparameterized
            return cls(value)
        if cls is dict:
            return dict(value)
        if cls is SecureHash:
            return SecureHash.parse(value)
        if cls is PublicKey:
            scheme, _, hexed = value.partition(":")
            return PublicKey(int(scheme), bytes.fromhex(hexed))
        if cls is CordaX500Name:
            return CordaX500Name.parse(value)
        if cls is Party:
            party = self.well_known_party_from_x500_name(
                CordaX500Name.parse(value)
            )
            if party is None:
                raise JsonSerializationError(f"unknown party: {value!r}")
            return party
        if cls is AnonymousParty:
            scheme, _, hexed = value.partition(":")
            return AnonymousParty(PublicKey(int(scheme), bytes.fromhex(hexed)))
        if cls is StateRef:
            head, _, idx = value.rpartition("(")
            return StateRef(SecureHash.parse(head), int(idx.rstrip(")")))
        if cls is Amount:
            if isinstance(value, str):
                qty, _, product = value.partition(" ")
                return Amount(int(qty), product)
            return Amount(
                value["quantity"], self.parse(value["token"], object)
            )
        if cls is bytes:
            return base64.b64decode(value)
        if isinstance(cls, type) and issubclass(cls, enum.Enum):
            return cls(value)
        if cls is int or cls is float or cls is str or cls is bool:
            return cls(value)
        if isinstance(value, dict) and "@type" in value:
            reg = _REGISTRY.get(value["@type"])
            if reg is None:
                raise JsonSerializationError(
                    f"unknown @type {value['@type']!r}"
                )
            reg_cls, from_fields = reg
            fields = {
                k: self._parse_registered_field(reg_cls, k, v)
                for k, v in value.items() if k != "@type"
            }
            return from_fields(fields)
        if (isinstance(cls, type) and dataclasses.is_dataclass(cls)
                and isinstance(value, dict)):
            hints = typing.get_type_hints(cls)
            kwargs = {
                f.name: self.parse(value[f.name], hints.get(f.name, object))
                for f in dataclasses.fields(cls) if f.name in value
            }
            return cls(**kwargs)
        raise JsonSerializationError(
            f"cannot parse {value!r} as {getattr(cls, '__name__', cls)}"
        )

    def _parse_registered_field(self, cls, name, value):
        hints = {}
        if isinstance(cls, type) and dataclasses.is_dataclass(cls):
            try:
                hints = typing.get_type_hints(cls)
            except Exception:
                hints = {}
        return self.parse(value, hints.get(name, object))

    def from_json(self, text: str, cls):
        return self.parse(json.loads(text), cls)


class IdentityJsonMapper(JsonMapper):
    """Party resolution via an in-process IdentityService (reference:
    IdentityObjectMapper)."""

    def __init__(self, identity_service):
        self._identities = identity_service

    def well_known_party_from_x500_name(self, name):
        return self._identities.party_from_name(name)

    def party_from_key(self, key):
        return self._identities.party_from_key(key)


class RpcJsonMapper(JsonMapper):
    """Party resolution through a live RPC proxy (reference:
    RpcObjectMapper) — the remote client's mapper."""

    def __init__(self, ops):
        self._ops = ops

    def well_known_party_from_x500_name(self, name):
        return self._ops.well_known_party_from_x500_name(name)

    def party_from_key(self, key):
        return self._ops.party_from_key(key)
