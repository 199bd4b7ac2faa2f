"""Messaging — layer 4 (counterpart of corda_tpu/messaging).

- ``DurableQueueBroker`` — named durable queues with at-least-once delivery:
  explicit ack, visibility-timeout redelivery, competing consumers,
  publisher dedupe (``queue.py``), backed by an append-only sqlite log.
- ``InMemoryMessagingNetwork`` — the deterministic in-process fake used by
  the MockNetwork test tier, with manual ``pump`` stepping for race-free
  protocol tests.
- ``MessagingClient`` protocol — the node-facing API (send/subscribe/ack),
  identical over the in-memory fake and the broker.

Not ported yet (ROADMAP.md, Queue 1 step 4b): ``netstats`` (per-edge
telemetry), ``native_queue`` (the C++ broker engine), ``fabric`` and
``secure_transport`` (the authenticated cross-host transport).
"""

from .queue import DurableQueueBroker, Message, QueueClosedError
from .network import (
    auto_ack,
    InMemoryMessagingNetwork,
    MessagingClient,
    PeerHandle,
)
from .broker_client import BrokerMessagingClient, p2p_queue
from .retry import RetryPolicy

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
]
