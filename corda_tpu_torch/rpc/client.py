"""RPC client: a typed proxy of the node's CordaRPCOps (the port's copy of
corda_tpu/rpc/client.py, import root changed).

Capability parity with ``CordaRPCClient`` / ``RPCClientProxyHandler``
(client/rpc/.../CordaRPCClient.kt, internal/RPCClientProxyHandler.kt):
``start(username, password)`` yields a connection whose ``proxy`` exposes
every remote operation as a method; feed methods return an ``Observable``
carrying the snapshot plus pushed updates; ``close()`` unsubscribes and
detaches.
"""

from __future__ import annotations

import secrets
import threading
from collections import deque

from corda_tpu_torch.serialization import deserialize, serialize

from .server import (
    Observation,
    RPC_REPLY_TOPIC,
    RPC_REQUEST_TOPIC,
    RpcReply,
    RpcRequest,
)


class RPCException(Exception):
    pass


class Observable:
    """A feed: snapshot + pushed updates (the reference returns rx
    Observables from vaultTrackBy etc.; this is the host-side equivalent
    with callback and blocking-poll consumption)."""

    def __init__(self, subscription_id: str, snapshot, unsubscribe):
        self.subscription_id = subscription_id
        self.snapshot = snapshot
        self._unsubscribe = unsubscribe
        self._lock = threading.Condition()
        self._updates: deque = deque()
        self._callbacks: list = []
        self._closed = False

    def subscribe(self, callback) -> None:
        with self._lock:
            self._callbacks.append(callback)
            backlog = list(self._updates)
        for u in backlog:
            callback(u)

    def poll(self, timeout: float | None = None):
        """Block for the next update (None on timeout/closed)."""
        with self._lock:
            deadline = None
            while not self._updates:
                if self._closed:
                    return None
                if not self._lock.wait(timeout=timeout):
                    return None
            return self._updates.popleft()

    def _push(self, update) -> None:
        with self._lock:
            self._updates.append(update)
            callbacks = list(self._callbacks)
            self._lock.notify_all()
        for cb in callbacks:
            cb(update)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._unsubscribe(self.subscription_id)


_FEED_METHODS = {
    "vault_track", "network_map_feed", "validated_transactions_track",
}


class RPCConnection:
    """One authenticated link to a node; ``proxy`` is self (methods are
    dispatched dynamically)."""

    def __init__(self, messaging, server_name: str, username: str,
                 password: str, timeout_s: float = 30.0):
        self._messaging = messaging
        self._server = server_name
        self._username = username
        self._password = password
        self._timeout_s = timeout_s
        self._lock = threading.Condition()
        self._replies: dict[str, RpcReply] = {}
        self._observables: dict[str, Observable] = {}
        # observations can arrive BEFORE the subscribe reply registers the
        # Observable (the server starts pushing immediately); park them
        self._pending_observations: dict[str, list] = {}
        self._closed = False
        messaging.add_handler(RPC_REPLY_TOPIC, self._on_reply)

    @property
    def proxy(self) -> "RPCConnection":
        return self

    # ------------------------------------------------------------ plumbing
    def _on_reply(self, msg, ack=None) -> None:
        obj = deserialize(msg.payload)
        if isinstance(obj, RpcReply):
            with self._lock:
                self._replies[obj.request_id] = obj
                self._lock.notify_all()
        elif isinstance(obj, Observation):
            update = deserialize(obj.payload_blob)
            with self._lock:
                obs = self._observables.get(obj.subscription_id)
                if obs is None:
                    self._pending_observations.setdefault(
                        obj.subscription_id, []
                    ).append(update)
                    # bound the parking lot: drop oldest orphaned subs
                    # (e.g. a subscribe whose reply errored out)
                    while len(self._pending_observations) > 64:
                        self._pending_observations.pop(
                            next(iter(self._pending_observations))
                        )
            if obs is not None:
                obs._push(update)
        if ack:
            ack()

    def _call(self, method: str, *args, **kwargs):
        if self._closed:
            raise RPCException("connection closed")
        request_id = secrets.token_hex(8)
        req = RpcRequest(
            request_id=request_id,
            username=self._username,
            password=self._password,
            method=method,
            args=tuple(args),
            kwargs_blob=serialize(kwargs) if kwargs else b"",
            reply_to=self._messaging.me.name,
        )
        self._messaging.send(
            self._server, RPC_REQUEST_TOPIC, serialize(req),
            msg_id=f"rpc-{request_id}",
        )
        with self._lock:
            while request_id not in self._replies:
                if not self._lock.wait(timeout=self._timeout_s):
                    raise RPCException(f"RPC {method} timed out")
            reply = self._replies.pop(request_id)
        if not reply.ok:
            raise RPCException(reply.error)
        return deserialize(reply.payload_blob)

    # ------------------------------------------------------------ surface
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        if name in _FEED_METHODS:
            def feed_call(*args, **kwargs):
                result = self._call(name, *args, **kwargs)
                obs = Observable(
                    result["subscription_id"], result["snapshot"],
                    lambda sid: self._call("unsubscribe", sid),
                )
                with self._lock:
                    sid = result["subscription_id"]
                    self._observables[sid] = obs
                    backlog = self._pending_observations.pop(sid, [])
                for update in backlog:
                    obs._push(update)
                return obs

            return feed_call

        def remote_call(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        return remote_call

    def close(self) -> None:
        with self._lock:
            observables = list(self._observables.values())
            self._observables.clear()
        for obs in observables:
            try:
                obs.close()
            except Exception:
                pass
        self._closed = True


class CordaRPCClient:
    """Entry point (reference: CordaRPCClient(hostAndPort).start(user, pw)).
    ``messaging`` is the client's own endpoint on the shared transport
    (an InMemoryMessagingNetwork node, a broker client, or a gRPC stub in
    deployment); ``server_name`` addresses the node."""

    def __init__(self, messaging, server_name: str):
        self._messaging = messaging
        self._server = server_name

    def start(self, username: str, password: str,
              timeout_s: float = 30.0) -> RPCConnection:
        return RPCConnection(
            self._messaging, self._server, username, password, timeout_s
        )
