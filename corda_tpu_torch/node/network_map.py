"""Network map: the node directory service
(counterpart of corda_tpu/node/network_map.py, copied whole).

Parity with the reference's node/.../services/network/ —
``NetworkMapCache`` (local cache of NodeInfos, notary discovery, change
feed) and the registration protocol of ``NetworkMapService``
(NetworkMapService.kt:66-74 fetch/register/subscribe/push topics). The
messaging-protocol variant rides the messaging layer's topics; a
file-based bootstrap (reference: NodeInfoWatcher) is the simple path for
driver/demo setups.
"""

from __future__ import annotations

import dataclasses
import threading

from ..ledger import CordaX500Name, Party
from ..serialization import deserialize, register_custom, serialize


@dataclasses.dataclass(frozen=True)
class NodeInfo:
    """(reference: core/.../node/NodeInfo.kt — addresses, identities,
    platform version, serial for last-write-wins updates)."""

    addresses: tuple[str, ...]
    legal_identities: tuple[Party, ...]
    platform_version: int = 1
    serial: int = 0
    # "validating" | "simple" | "" — advertised notary service, so peers
    # learn notaries (and their protocol mode) from map registration alone
    notary_mode: str = ""

    @property
    def legal_identity(self) -> Party:
        return self.legal_identities[0]


register_custom(
    NodeInfo, "node.NodeInfo",
    to_fields=lambda n: {
        "addresses": list(n.addresses),
        "identities": list(n.legal_identities),
        "pv": n.platform_version,
        "serial": n.serial,
        "notary_mode": n.notary_mode,
    },
    from_fields=lambda d: NodeInfo(
        tuple(d["addresses"]), tuple(d["identities"]), d["pv"], d["serial"],
        d.get("notary_mode", ""),
    ),
)


class NetworkMapCache:
    """Thread-safe directory cache with a change feed (reference:
    PersistentNetworkMapCache / NetworkMapCache interface)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._nodes: dict[CordaX500Name, NodeInfo] = {}
        self._notaries: list[Party] = []
        self._validating_notaries: set = set()  # owning_key set
        self._subscribers: list = []

    def add_node(self, info: NodeInfo) -> None:
        with self._lock:
            name = info.legal_identity.name
            existing = self._nodes.get(name)
            if existing is not None and existing.serial > info.serial:
                return  # stale update (last-write-wins by serial)
            self._nodes[name] = info
            # the notary side effect stays under the lock so the serial
            # last-write-wins check above also orders notary updates — a
            # stale registration must not re-promote a decommissioned notary
            if info.notary_mode:
                self.add_notary(
                    info.legal_identity,
                    validating=(info.notary_mode == "validating"),
                )
            else:
                self._remove_notary(info.legal_identity)
            subs = list(self._subscribers)
        for cb in subs:
            cb("ADD", info)

    def _remove_notary(self, party: Party) -> None:
        with self._lock:
            self._notaries = [
                n for n in self._notaries
                if n.owning_key != party.owning_key
            ]
            self._validating_notaries.discard(party.owning_key)

    def remove_node(self, info: NodeInfo) -> None:
        self._remove_notary(info.legal_identity)
        with self._lock:
            self._nodes.pop(info.legal_identity.name, None)
            subs = list(self._subscribers)
        for cb in subs:
            cb("REMOVE", info)

    def get_node_by_legal_name(self, name: CordaX500Name) -> NodeInfo | None:
        with self._lock:
            return self._nodes.get(name)

    def get_node_by_party(self, party: Party) -> NodeInfo | None:
        with self._lock:
            for info in self._nodes.values():
                if any(p.owning_key == party.owning_key
                       for p in info.legal_identities):
                    return info
        return None

    def all_nodes(self) -> list[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    def untrack(self, callback) -> None:
        with self._lock:
            try:
                self._subscribers.remove(callback)
            except ValueError:
                pass

    def track(self, callback) -> list[NodeInfo]:
        with self._lock:
            self._subscribers.append(callback)
            return list(self._nodes.values())

    # -- notaries -------------------------------------------------------------

    def add_notary(self, party: Party, validating: bool = True) -> None:
        with self._lock:
            if all(n.owning_key != party.owning_key for n in self._notaries):
                self._notaries.append(party)
            if validating:
                self._validating_notaries.add(party.owning_key)
            else:
                self._validating_notaries.discard(party.owning_key)

    @property
    def notary_identities(self) -> list[Party]:
        with self._lock:
            return list(self._notaries)

    def get_notary(self, name: CordaX500Name | None = None) -> Party | None:
        with self._lock:
            if name is None:
                return self._notaries[0] if self._notaries else None
            for n in self._notaries:
                if n.name == name:
                    return n
        return None

    def is_notary(self, party: Party) -> bool:
        with self._lock:
            return any(n.owning_key == party.owning_key for n in self._notaries)

    def is_validating_notary(self, party: Party) -> bool:
        """Whether the notary runs the validating protocol — decides what
        the client sends it: the full SignedTransaction (validating) or a
        privacy-preserving tear-off (non-validating). Reference: the service
        type advertised in the network map entry."""
        with self._lock:
            return party.owning_key in self._validating_notaries


class NetworkMapClient:
    """Register with / fetch from a network-map node over messaging topics
    (reference: NetworkMapService fetch/register/subscribe protocol)."""

    TOPIC_REGISTER = "platform.network-map.register"
    TOPIC_FETCH = "platform.network-map.fetch"
    TOPIC_PUSH = "platform.network-map.push"

    def __init__(self, messaging, cache: NetworkMapCache):
        self._messaging = messaging
        self._cache = cache
        messaging.add_handler(self.TOPIC_PUSH, self._on_push)

    def _on_push(self, msg, ack=None) -> None:
        self._cache.add_node(deserialize(msg.payload))
        if ack:
            ack()

    def register(self, map_peer, my_info: NodeInfo) -> None:
        self._messaging.send(map_peer, self.TOPIC_REGISTER, serialize(my_info))


class NetworkMapServer:
    """The map-service side: accept registrations, push updates to all
    subscribers (reference: PersistentNetworkMapService)."""

    def __init__(self, messaging, cache: NetworkMapCache | None = None):
        self._messaging = messaging
        self.cache = cache or NetworkMapCache()
        self._subscribers: set = set()
        self._lock = threading.Lock()
        messaging.add_handler(NetworkMapClient.TOPIC_REGISTER, self._on_register)

    def _on_register(self, msg, ack=None) -> None:
        info = deserialize(msg.payload)
        self.cache.add_node(info)
        with self._lock:
            self._subscribers.add(msg.sender)
            targets = list(self._subscribers)
        # push the full map to the newcomer and the newcomer to everyone
        for node in self.cache.all_nodes():
            self._messaging.send(
                msg.sender, NetworkMapClient.TOPIC_PUSH, serialize(node)
            )
        for peer in targets:
            if peer != msg.sender:
                self._messaging.send(
                    peer, NetworkMapClient.TOPIC_PUSH, serialize(info)
                )
        if ack:
            ack()
