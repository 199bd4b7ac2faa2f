"""Messaging — layer 4 (counterpart of corda_tpu/messaging).

- ``DurableQueueBroker`` — named durable queues with at-least-once delivery:
  explicit ack, visibility-timeout redelivery, competing consumers,
  publisher dedupe (``queue.py``), backed by an append-only sqlite log; the
  C++ engine (``native_queue.py``, ``NativeQueueBroker``) slots under the
  identical interface as the single-process tier.
- ``InMemoryMessagingNetwork`` — the deterministic in-process fake used by
  the MockNetwork test tier, with manual ``pump`` stepping for race-free
  protocol tests.
- ``MessagingClient`` protocol — the node-facing API (send/subscribe/ack),
  identical over the in-memory fake and the broker.
- ``netstats`` — off-by-default per-edge network-path telemetry: a
  ``(src, dst)`` delivery/transit/retransmit ledger fed by both
  transports, plus an edge-triggered partition-suspect detector.

Not ported yet (ROADMAP.md, Queue 1 step 9): ``fabric`` and
``secure_transport`` (the authenticated cross-host transport), which need a
transport without the ``cryptography`` package.
"""

from .netstats import (
    NetTelemetry,
    active_netstats,
    configure_netstats,
    netstats,
    netstats_section,
)
from .queue import DurableQueueBroker, Message, QueueClosedError
from .network import (
    auto_ack,
    InMemoryMessagingNetwork,
    MessagingClient,
    PeerHandle,
)
from .broker_client import BrokerMessagingClient, p2p_queue
from .retry import RetryPolicy
from .native_queue import (
    NativeEngineUnavailable,
    NativeQueueBroker,
    make_broker,
    native_engine_available,
)

__all__ = [
    "auto_ack",
    "DurableQueueBroker",
    "Message",
    "QueueClosedError",
    "InMemoryMessagingNetwork",
    "MessagingClient",
    "PeerHandle",
    "BrokerMessagingClient",
    "p2p_queue",
    "RetryPolicy",
    "NativeEngineUnavailable", "NativeQueueBroker", "make_broker",
    "native_engine_available",
    "NetTelemetry", "active_netstats", "configure_netstats",
    "netstats", "netstats_section",
]
