"""Broker-backed MessagingClient: durable node messaging (counterpart of
corda_tpu/messaging/broker_client.py).

Bridges the durable queue broker (queue.py) to the MessagingClient surface:
each node owns queue ``p2p.<name>``; a consumer thread leases messages and
dispatches to topic handlers **with the ack callback** — handlers ack only
once the message's effect is durable (the flow engine acks a SessionData
when its payload is recorded in the op log). Un-acked messages redeliver
after the visibility timeout, exactly the Artemis consumer contract the
reference's state machine rides (NodeMessagingClient.kt:249-273).

In-process the broker is shared (one per simulated host); across real hosts
the same broker fronts a TCP/gRPC bridge — the client surface is identical.

With those layers on, netstats stamps each send, spoofed drop and delivery,
and flowprof books the publish as ``serialize``.
"""

from __future__ import annotations

import json
import threading

from .netstats import active_netstats
from .network import MessagingClient, PeerHandle, TopicMessage
from .queue import DurableQueueBroker, QueueClosedError


def p2p_queue(name: str) -> str:
    return f"p2p.{name}"


class BrokerMessagingClient(MessagingClient):
    def __init__(self, broker: DurableQueueBroker, name: str):
        self._broker = broker
        self._name = name
        self._handlers: dict[str, list] = {}
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(
            target=self._consume_loop, name=f"msg-{name}", daemon=True
        )
        self._thread.start()

    @property
    def me(self) -> PeerHandle:
        return PeerHandle(self._name)

    def send(self, recipient, topic, payload, *, msg_id=None) -> str:
        name = recipient.name if isinstance(recipient, PeerHandle) else recipient
        # the durable publish blocks the CALLING (flow) thread — envelope
        # framing plus a broker write (sqlite insert, or a secure-fabric
        # round trip across hosts). flowprof books that wall as
        # ``serialize``: it is transport handoff cost, not transit (the
        # receiver-side clock), and would otherwise hide in engine_other.
        from ..observability.flowprof import flowprof_frame

        with flowprof_frame("serialize"):
            # envelope carries the topic + sender; payload stays opaque bytes
            header = json.dumps({"topic": topic, "sender": self._name}).encode()
            framed = len(header).to_bytes(4, "big") + header + payload
            mid = self._broker.publish(
                p2p_queue(name), framed, msg_id=msg_id, sender=self._name
            )
        nets = active_netstats()
        if nets is not None:
            nets.on_send(self._name, name, mid)
        return mid

    def add_handler(self, topic, callback) -> None:
        # ack-unaware (single-parameter) handlers get auto-ack-on-return
        # semantics; signature inspected once here, not per message
        try:
            import inspect

            params = inspect.signature(callback).parameters
            takes_ack = len(params) >= 2 or any(
                p.kind == p.VAR_POSITIONAL for p in params.values()
            )
        except (TypeError, ValueError):
            takes_ack = True
        if not takes_ack:
            inner = callback

            def callback(msg, ack, _inner=inner):
                _inner(msg)
                ack()

        with self._lock:
            self._handlers.setdefault(topic, []).append(callback)

    def _consume_loop(self) -> None:
        while self._running:
            try:
                msg = self._broker.consume(p2p_queue(self._name), timeout=0.5)
            except (QueueClosedError, ConnectionError):
                # broker closed or the secure-fabric channel tore down —
                # either way the transport is gone; exit cleanly
                return
            if msg is None:
                continue
            hlen = int.from_bytes(msg.payload[:4], "big")
            header = json.loads(msg.payload[4 : 4 + hlen])
            body = msg.payload[4 + hlen :]
            # message attribution: the broker stamps Message.sender with
            # the transport-authenticated identity (the secure fabric's
            # channel peer; in-process, the publishing client's own name).
            # An envelope claiming a DIFFERENT sender is a spoof attempt —
            # a certified-but-malicious peer must not speak as the notary
            # — and is dropped, so the mutual-auth boundary extends from
            # the socket to per-message attribution.
            nets = active_netstats()
            if msg.sender and msg.sender != header["sender"]:
                if nets is not None:
                    nets.on_drop(msg.sender, self._name, "spoof")
                try:
                    self._broker.ack(msg.msg_id)
                except (QueueClosedError, ConnectionError):
                    return
                continue
            tmsg = TopicMessage(
                header["topic"], body, header["sender"], msg.msg_id
            )
            if nets is not None:
                # delivery stamp: the leased message reached its consumer
                # (handler dispatch below; redeliveries restamp honestly)
                nets.on_deliver(header["sender"], self._name, msg.msg_id)
            with self._lock:
                handlers = list(self._handlers.get(tmsg.topic, ()))
            if not handlers:
                try:
                    self._broker.nack(msg.msg_id)  # no handler yet: requeue
                except (QueueClosedError, ConnectionError):
                    return
                continue
            acked = threading.Event()

            def ack(msg_id=msg.msg_id):
                if not acked.is_set():
                    acked.set()
                    try:
                        self._broker.ack(msg_id)
                    except (QueueClosedError, ConnectionError):
                        pass  # fabric torn down: redelivery will settle it

            for h in handlers:
                h(tmsg, ack)

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=5)
