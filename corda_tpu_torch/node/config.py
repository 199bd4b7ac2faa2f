"""Typed node configuration (the port's copy of
corda_tpu/node/config.py, import root changed).

Parity with the reference's Typesafe-HOCON config stack
(node/.../services/config/NodeConfiguration.kt:17-106 — ``verifierType``,
``notary { validating, raft{...}, bftSMaRt{...} }``, rpcUsers, devMode,
``messageRedeliveryDelaySeconds``; defaults from
node/src/main/resources/reference.conf). Re-designed as frozen dataclasses
loaded from a HOCON-compatible subset (JSON superset: ``key = value``,
``key { ... }`` nesting, ``//``/``#`` comments, unquoted scalars) so the
reference's config files port mechanically.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import hmac
import json
import os
import re
from pathlib import Path


class VerifierType(enum.Enum):
    """Reference: enum VerifierType { InMemory, OutOfProcess }
    (NodeConfiguration.kt:106) plus the device batching tier this framework
    adds as the production default."""

    InMemory = "InMemory"
    OutOfProcess = "OutOfProcess"
    DeviceBatched = "DeviceBatched"


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Reference: RaftConfig (NodeConfiguration.kt:45)."""

    node_address: str
    cluster_addresses: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class BFTConfig:
    """Reference: BFTSMaRtConfiguration (NodeConfiguration.kt:51) — replica
    id plus the debug race-exposure flag."""

    replica_id: int
    cluster_addresses: tuple[str, ...] = ()
    expose_races: bool = False


@dataclasses.dataclass(frozen=True)
class NotaryConfig:
    """Reference: NotaryConfig (NodeConfiguration.kt:39) — exactly one of
    raft/bft may be set; validating controls tear-off vs full verification."""

    validating: bool = False
    raft: RaftConfig | None = None
    bft: BFTConfig | None = None

    def __post_init__(self):
        if self.raft is not None and self.bft is not None:
            raise ValueError("notary config cannot be both raft and bftSMaRt")


@dataclasses.dataclass(frozen=True)
class RpcUser:
    """An RPC credential entry (reference: NodeConfiguration.kt rpcUsers).

    ``password`` holds either a plaintext secret (dev ensembles) or a
    salted-hash entry of the form ``pbkdf2$<iters>$<salt_hex>$<hash_hex>``
    produced by :func:`hash_rpc_password` — the at-rest form a production
    node.conf should carry. Either way, candidate checks go through
    :meth:`check_password`, which compares in constant time.
    """

    username: str
    password: str
    permissions: tuple[str, ...] = ()

    def check_password(self, candidate: str) -> bool:
        stored = self.password
        if stored.startswith("pbkdf2$"):
            try:
                _, iters, salt_hex, hash_hex = stored.split("$")
                expected = bytes.fromhex(hash_hex)
                derived = hashlib.pbkdf2_hmac(
                    "sha256", candidate.encode(), bytes.fromhex(salt_hex),
                    int(iters),
                )
            except (ValueError, TypeError):
                return False
            return hmac.compare_digest(derived, expected)
        return hmac.compare_digest(stored.encode(), candidate.encode())


def _plain_password(value: str) -> str:
    """Guard the shared-field encoding: a plaintext ``password`` that starts
    with the hash-entry prefix would silently become uncheckable (every
    candidate takes the hash branch and fails) — reject it at load time."""
    if value.startswith("pbkdf2$"):
        raise ValueError(
            "plaintext rpcUsers password may not start with 'pbkdf2$'; "
            "if this is a hash entry, put it under the passwordHash key"
        )
    return value


def hash_rpc_password(password: str, *, iterations: int = 120_000,
                      _salt: bytes | None = None) -> str:
    """Produce a salted-hash rpcUsers entry for node.conf (``passwordHash``)."""
    salt = _salt if _salt is not None else os.urandom(16)
    derived = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, iterations
    )
    return f"pbkdf2${iterations}${salt.hex()}${derived.hex()}"


@dataclasses.dataclass(frozen=True)
class NodeConfiguration:
    """The typed root (reference: NodeConfiguration.kt:17-36 +
    FullNodeConfiguration :63)."""

    my_legal_name: str
    base_directory: str = "."
    p2p_address: str = "localhost:10002"
    rpc_address: str | None = None
    notary: NotaryConfig | None = None
    verifier_type: VerifierType = VerifierType.DeviceBatched
    rpc_users: tuple[RpcUser, ...] = ()
    dev_mode: bool = True
    network_map_address: str | None = None
    message_redelivery_delay_seconds: float = 30.0
    flow_timeout_seconds: float = 120.0
    verification_batch_max: int = 1024
    verification_window_ms: float = 5.0
    database_path: str | None = None  # None → <base_directory>/node.db
    # python packages imported at boot so their contracts/flows/serializers
    # register — the reference's CordappLoader plugins-directory scan
    # (node/.../internal/cordapp/CordappLoader.kt:41) as explicit config
    cordapp_packages: tuple[str, ...] = ()
    # the reference's plugins-directory scan: every module/package in this
    # directory loads as an app at boot (node/cordapp.py CordappLoader)
    cordapp_directory: str | None = None
    # device-mesh fan-out for signature batches (SURVEY §2.9 P3): None =
    # auto (on when >1 accelerator device is visible), true/false forces
    mesh_fan_out: bool | None = None

    @property
    def db_path(self) -> str:
        if self.database_path is not None:
            return self.database_path
        return str(Path(self.base_directory) / "node.db")


# --- HOCON-subset parser -----------------------------------------------------

_COMMENT = re.compile(r"(?m)(//|#).*$")


class _Hocon:
    """Recursive-descent parser for the HOCON subset the reference's config
    files use: ``key = value`` / ``key : value`` / ``key { ... }`` nesting,
    optional commas, quoted or bare keys, JSON values plus unquoted strings."""

    def __init__(self, text: str):
        self.s = _COMMENT.sub("", text)
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\r\n,":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self) -> dict:
        if self._peek() == "{":
            return self._object()
        return self._object(bare=True)

    def _object(self, bare: bool = False) -> dict:
        if not bare:
            self.i += 1  # consume '{'
        out: dict = {}
        while True:
            c = self._peek()
            if c == "" or c == "}":
                if c == "}":
                    self.i += 1
                return out
            key = self._key()
            c = self._peek()
            if c in "=:":
                self.i += 1
                out[key] = self._value()
            elif c == "{":
                out[key] = self._object()
            else:
                raise ValueError(f"expected = : or {{ after key {key!r} at {self.i}")

    def _key(self) -> str:
        if self._peek() == '"':
            return self._string()
        m = re.match(r"[\w.$-]+", self.s[self.i:])
        if not m:
            raise ValueError(f"bad key at offset {self.i}")
        self.i += m.end()
        return m.group(0)

    def _string(self) -> str:
        m = re.match(r'"((?:[^"\\]|\\.)*)"', self.s[self.i:])
        if not m:
            raise ValueError(f"unterminated string at {self.i}")
        self.i += m.end()
        return json.loads('"' + m.group(1) + '"')

    def _value(self):
        c = self._peek()
        if c == "{":
            return self._object()
        if c == "[":
            return self._array()
        if c == '"':
            return self._string()
        # bare scalar: runs to end-of-line / comma / closer
        m = re.match(r"[^\n,\]}]*", self.s[self.i:])
        raw = m.group(0).strip()
        self.i += m.end()
        if re.fullmatch(r"-?\d+", raw):
            return int(raw)
        if re.fullmatch(r"-?\d+\.\d*([eE][+-]?\d+)?", raw):
            return float(raw)
        if raw in ("true", "false"):
            return raw == "true"
        if raw == "null":
            return None
        return raw

    def _array(self) -> list:
        self.i += 1  # consume '['
        out = []
        while True:
            c = self._peek()
            if c == "]":
                self.i += 1
                return out
            if c == "":
                raise ValueError("unterminated array")
            out.append(self._value())


def parse_hocon(text: str) -> dict:
    return _Hocon(text).parse()


def _notary_from(d: dict) -> NotaryConfig:
    raft = bft = None
    if "raft" in d:
        r = d["raft"]
        raft = RaftConfig(
            node_address=r["nodeAddress"],
            cluster_addresses=tuple(r.get("clusterAddresses", [])),
        )
    if "bftSMaRt" in d:
        b = d["bftSMaRt"]
        bft = BFTConfig(
            replica_id=int(b["replicaId"]),
            cluster_addresses=tuple(b.get("clusterAddresses", [])),
            expose_races=bool(b.get("exposeRaces", False)),
        )
    return NotaryConfig(validating=bool(d.get("validating", False)), raft=raft, bft=bft)


def config_from_dict(d: dict) -> NodeConfiguration:
    users = tuple(
        RpcUser(
            u["username"],
            # passwordHash carries a pbkdf2$... entry (hash_rpc_password);
            # check_password dispatches on the prefix, so both land in the
            # same field
            u["passwordHash"] if "passwordHash" in u
            else _plain_password(u["password"]),
            tuple(u.get("permissions", [])),
        )
        for u in d.get("rpcUsers", [])
    )
    return NodeConfiguration(
        my_legal_name=d["myLegalName"],
        base_directory=d.get("baseDirectory", "."),
        p2p_address=d.get("p2pAddress", "localhost:10002"),
        rpc_address=d.get("rpcAddress"),
        notary=_notary_from(d["notary"]) if "notary" in d else None,
        verifier_type=VerifierType(d.get("verifierType", "DeviceBatched")),
        rpc_users=users,
        dev_mode=bool(d.get("devMode", True)),
        network_map_address=d.get("networkMapAddress"),
        message_redelivery_delay_seconds=float(
            d.get("messageRedeliveryDelaySeconds", 30.0)
        ),
        flow_timeout_seconds=float(d.get("flowTimeoutSeconds", 120.0)),
        verification_batch_max=int(d.get("verificationBatchMax", 1024)),
        cordapp_packages=tuple(d.get("cordappPackages", [])),
        cordapp_directory=d.get("cordappDirectory"),
        mesh_fan_out=(
            bool(d["meshFanOut"]) if "meshFanOut" in d else None
        ),
        verification_window_ms=float(d.get("verificationWindowMs", 5.0)),
        database_path=d.get("databasePath"),
    )


def load_config(path: str | Path) -> NodeConfiguration:
    """Load a node.conf (HOCON subset or plain JSON)."""
    text = Path(path).read_text()
    try:
        d = json.loads(text)
    except json.JSONDecodeError:
        d = parse_hocon(text)
    return config_from_dict(d)
