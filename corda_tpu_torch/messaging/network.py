"""In-process messaging network + the client protocol (counterpart of
corda_tpu/messaging/network.py).

The deterministic fake-transport tier (reference:
testing/node-driver/.../InMemoryMessagingNetwork.kt:47 and the MockNetwork
around it, MockNode.kt:61-80): every node gets an inbound queue in one
process; delivery happens only when the network is *pumped* — either one
message at a time (``pump(block=False)`` — race-free protocol stepping) or
by a background pump thread (``start_pumping``). Per-recipient dedupe by
message id mirrors the processed-message table of
NodeMessagingClient.kt:187,429-439.

``MessagingClient`` is the node-facing API; production transports (the
durable broker of queue.py bridged over TCP/gRPC between hosts) implement
the same surface, so flow/session code is transport-blind.

With network-path telemetry on (``messaging/netstats.py``), ``_deliver``
stamps each edge's sends, drops, delays, duplicates and deliveries, and
``pump`` runs the partition check.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque

from .netstats import active_netstats
from .queue import Message

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PeerHandle:
    """Network address of a node (reference: SingleMessageRecipient)."""

    name: str


@dataclasses.dataclass(frozen=True)
class TopicMessage:
    topic: str
    payload: bytes
    sender: str
    msg_id: str


def auto_ack(handler):
    """Adapt a one-argument topic handler to the (msg, ack) calling
    convention: ack (when the transport provides one) fires after the
    handler returns. Shared by protocol layers (raft, bft, network map)
    whose handlers are synchronous."""

    def wrapped(msg, ack=None):
        handler(msg)
        if ack:
            ack()

    return wrapped


class MessagingClient:
    """Topic-addressed node messaging (reference: MessagingService,
    node/.../services/messaging/Messaging.kt)."""

    @property
    def me(self) -> PeerHandle:
        raise NotImplementedError

    def send(
        self, recipient: PeerHandle | str, topic: str, payload: bytes,
        *, msg_id: str | None = None,
    ) -> str:
        raise NotImplementedError

    def add_handler(self, topic: str, callback) -> None:
        """callback(TopicMessage) runs on delivery. One handler per topic
        handles the platform protocols; extra handlers fan out."""
        raise NotImplementedError

    def stop(self) -> None:
        pass


class _InMemoryNode(MessagingClient):
    def __init__(self, network: "InMemoryMessagingNetwork", name: str):
        self._network = network
        self._name = name
        self._handlers: dict[str, list] = {}
        self._inbox: deque[TopicMessage] = deque()
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self.running = True

    @property
    def me(self) -> PeerHandle:
        return PeerHandle(self._name)

    def send(self, recipient, topic, payload, *, msg_id=None) -> str:
        name = recipient.name if isinstance(recipient, PeerHandle) else recipient
        msg_id = msg_id or Message.fresh_id()
        self._network._deliver(
            name, TopicMessage(topic, payload, self._name, msg_id)
        )
        return msg_id

    def add_handler(self, topic, callback) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(callback)

    def _enqueue(self, msg: TopicMessage, *, front: bool = False,
                 force: bool = False) -> bool:
        """``front`` models fault-injected reordering; ``force`` bypasses
        the dedupe set — an injected DUPLICATE must reach the handlers
        (simulating broker visibility-timeout redelivery), because the
        dedupe being exercised is the protocol layer's, not the
        transport's. Returns False when the message was swallowed (node
        stopped, or the transport dedupe dropped a duplicate wire id) —
        the edge telemetry's duplicates-dropped feed."""
        with self._lock:
            if not self.running:
                return False
            if not force:
                if msg.msg_id in self._seen:
                    return False  # dedupe / dropped-after-stop
                self._seen.add(msg.msg_id)
            if front:
                self._inbox.appendleft(msg)
            else:
                self._inbox.append(msg)
            return True

    def _pump_one(self) -> bool:
        with self._lock:
            if not self._inbox:
                return False
            msg = self._inbox.popleft()
            handlers = list(self._handlers.get(msg.topic, ()))
        if not handlers:
            # undeliverable: keep it pending until a handler registers
            # (the reference parks messages for unknown topics the same way)
            with self._lock:
                self._inbox.append(msg)
            return False
        for h in handlers:
            try:
                h(msg)
            except Exception:
                # a handler crashing on one (possibly hostile) message must
                # not kill delivery for the whole network — a Byzantine
                # replica sending garbage would otherwise stop the shared
                # pump thread, a total liveness loss. Mirrors the broker's
                # per-message error isolation.
                logger.exception(
                    "handler for topic %r failed on message from %s",
                    msg.topic, msg.sender,
                )
        return True

    def stop(self) -> None:
        with self._lock:
            self.running = False


class InMemoryMessagingNetwork:
    """The shared fake transport. Deterministic: messages deliver only on
    ``pump``; round-robin over nodes keeps ordering reproducible.

    With a ``FaultInjector`` attached (``set_fault_injector``) every
    delivery first passes through the seeded plan: messages may drop,
    delay (by pump rounds), duplicate past the dedupe set, or jump the
    queue; partitioned edges drop both ways. Pump hooks
    (``add_pump_hook``) fire once per round with the round number — the
    chaos orchestrator drives crash/restart schedules from them."""

    def __init__(self, fault_injector=None):
        self._nodes: dict[str, _InMemoryNode] = {}
        self._lock = threading.Lock()
        self._pump_thread: threading.Thread | None = None
        self._pumping = threading.Event()
        self.dropped: list[tuple[str, TopicMessage]] = []
        self._injector = fault_injector
        self._round = 0
        self._delayed: list[tuple[int, str, TopicMessage]] = []
        self._pump_hooks: list = []

    def set_fault_injector(self, injector) -> None:
        self._injector = injector

    def add_pump_hook(self, hook) -> None:
        """hook(round_number) runs at the start of every pump round."""
        with self._lock:
            self._pump_hooks.append(hook)

    def create_node(self, name: str) -> MessagingClient:
        with self._lock:
            if name in self._nodes:
                raise ValueError(f"node name {name!r} already on network")
            node = _InMemoryNode(self, name)
            self._nodes[name] = node
            return node

    def _deliver(self, recipient: str, msg: TopicMessage,
                 *, matured: bool = False) -> None:
        nets = active_netstats()
        if nets is not None and not matured:
            # the edge send stamp: first entry of a wire id into the
            # transport (a matured delayed message was already stamped)
            nets.on_send(msg.sender, recipient, msg.msg_id)
        inj = self._injector
        duplicate = reorder = False
        if inj is not None and not matured:
            # matured (previously delayed) messages skip re-decision: a
            # delayed message would otherwise re-roll its fate each round
            verdict = inj.on_deliver(
                msg.sender, recipient, msg.msg_id, self._round
            )
            if verdict.drop:
                self.dropped.append((recipient, msg))
                if nets is not None:
                    nets.on_drop(msg.sender, recipient,
                                 verdict.reason or "drop")
                return
            if verdict.delay_rounds:
                with self._lock:
                    self._delayed.append(
                        (self._round + verdict.delay_rounds, recipient, msg)
                    )
                if nets is not None:
                    nets.on_delay(msg.sender, recipient, verdict.delay_rounds)
                return
            duplicate, reorder = verdict.duplicate, verdict.reorder
        with self._lock:
            node = self._nodes.get(recipient)
        if node is None or not node.running:
            self.dropped.append((recipient, msg))
            if nets is not None:
                nets.on_drop(msg.sender, recipient, "down")
            return
        enqueued = node._enqueue(msg, front=reorder)
        if nets is not None:
            if enqueued:
                nets.on_deliver(msg.sender, recipient, msg.msg_id)
            else:
                nets.on_duplicate(msg.sender, recipient)
        if duplicate:
            node._enqueue(msg, force=True)
        if self._pumping.is_set():
            pass  # background pump thread will pick it up

    # ------------------------------------------------------------ pumping
    def pump(self) -> bool:
        """Deliver at most one message per node; True if anything moved.
        The manual deterministic stepper (reference: pumpReceive)."""
        moved = False
        with self._lock:
            self._round += 1
            rnd = self._round
            due = [e for e in self._delayed if e[0] <= rnd]
            if due:
                self._delayed = [e for e in self._delayed if e[0] > rnd]
            hooks = list(self._pump_hooks)
            nodes = list(self._nodes.values())
        for hook in hooks:
            hook(rnd)
        for _rel, recipient, msg in due:
            self._deliver(recipient, msg, matured=True)
            moved = True
        for node in nodes:
            moved |= node._pump_one()
        nets = active_netstats()
        if nets is not None:
            # partition detection rides the pump: an edge with pending
            # sends and no delivery past the deadline raises its suspect
            # event here, once per episode
            nets.check_partitions()
        return moved

    def run_until_quiescent(self, max_rounds: int = 10_000) -> int:
        """Pump until no messages move; returns rounds used."""
        rounds = 0
        while self.pump():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError("network did not quiesce (message loop?)")
        return rounds

    def start_pumping(self, interval_s: float = 0.001) -> None:
        """Background delivery for integration-style tests."""
        if self._pump_thread is not None:
            return
        self._pumping.set()

        def loop():
            while self._pumping.is_set():
                if not self.pump():
                    time.sleep(interval_s)

        self._pump_thread = threading.Thread(
            target=loop, name="mock-net-pump", daemon=True
        )
        self._pump_thread.start()

    def stop_pumping(self) -> None:
        self._pumping.clear()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
            self._pump_thread = None

    def stop_node(self, name: str) -> None:
        """Simulate node death: in-flight messages to it drop."""
        with self._lock:
            node = self._nodes.get(name)
        if node is not None:
            node.stop()

    def restart_node(self, name: str) -> MessagingClient:
        """Bring a stopped node back with an empty inbox (its durable state
        lives in the node's own persistence, not the transport)."""
        with self._lock:
            old = self._nodes.pop(name, None)
        if old is not None:
            old.stop()
        return self.create_node(name)
