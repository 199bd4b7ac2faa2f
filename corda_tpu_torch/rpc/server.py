"""RPC server: exposes CordaRPCOps over the messaging layer (the port's copy of
corda_tpu/rpc/server.py, import root changed).

Capability parity with the reference's ``RPCServer``
(node/.../services/messaging/RPCServer.kt) speaking the RPCApi protocol
(node-api/.../RPCApi.kt:15-50): clients send ``RpcRequest`` to the node's
request topic with a reply topic; replies carry the result or error;
streamed feeds (vault track, network map feed, state machine updates) are
pushed as ``Observation`` messages tagged by subscription id until the
client unsubscribes.

Auth mirrors the reference's rpcUsers model (NodeConfiguration.kt rpcUsers
+ per-method/per-flow permission strings): every request carries
username/password checked against the configured users; flow starts
additionally require ``StartFlow.<class>`` (or ``ALL``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

from corda_tpu_torch.node.config import RpcUser
from corda_tpu_torch.serialization import cbe_serializable, deserialize, serialize

from .ops import CordaRPCOps, PermissionException, start_flow_permission

logger = logging.getLogger(__name__)

# decoy for unknown usernames: runs the same constant-time plaintext
# compare a known dev-mode user would, so unknown-vs-known timing is
# equalized for the plaintext (dev default) case without handing
# unauthenticated callers a pbkdf2 CPU-amplification lever. (For hashed
# entries the pbkdf2 cost itself still differs from the decoy; hashing
# at rest trades that residual username-timing signal for not storing
# secrets in clear.)
_DUMMY_USER = RpcUser("", "\x00corda-tpu-rpc-decoy\x00", ())

RPC_REQUEST_TOPIC = "rpc.request"


@cbe_serializable(name="rpc.Request")
@dataclasses.dataclass(frozen=True)
class RpcRequest:
    request_id: str
    username: str
    password: str
    method: str
    args: tuple = ()
    kwargs_blob: bytes = b""     # CBE dict (kwargs keys are strings)
    reply_to: str = ""           # client node name on the transport


@cbe_serializable(name="rpc.Reply")
@dataclasses.dataclass(frozen=True)
class RpcReply:
    request_id: str
    ok: bool
    payload_blob: bytes = b""    # CBE result when ok
    error: str = ""


@cbe_serializable(name="rpc.Observation")
@dataclasses.dataclass(frozen=True)
class Observation:
    subscription_id: str
    payload_blob: bytes
    completed: bool = False


RPC_REPLY_TOPIC = "rpc.reply"

# methods any authenticated user may call; everything else needs an explicit
# permission or ALL (flow starts use StartFlow.<class>)
_OPEN_METHODS = {
    "ping", "current_node_time", "node_info", "network_map_snapshot",
    "notary_identities", "registered_flows",
}

# feed methods: invoked with a server-side callback bridged to Observations
_FEED_METHODS = {
    "vault_track": "vault_track",
    "network_map_feed": "network_map_feed",
    "validated_transactions_track": "validated_transactions_track",
}


class RPCServer:
    """Dispatches RpcRequests against a CordaRPCOps instance."""

    def __init__(self, ops: CordaRPCOps, messaging, rpc_users=(),
                 max_workers: int = 8):
        self._ops = ops
        self._messaging = messaging
        self._users = {u.username: u for u in rpc_users}
        self._lock = threading.Lock()
        self._subscriptions: dict[str, dict] = {}  # sub id -> {client, push}
        self._counter = 0
        # requests dispatch on a pool, NEVER on the transport's delivery
        # thread: a blocking op (flow_result while the flow still needs
        # messaging) would otherwise deadlock all message delivery
        # (reference: RPCServer's rpc-server thread pool)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="rpc-server"
        )
        messaging.add_handler(RPC_REQUEST_TOPIC, self._on_request)

    # ------------------------------------------------------------ auth
    def _authenticate(self, req: RpcRequest):
        user = self._users.get(req.username)
        # check_password compares in constant time (and handles pbkdf2$
        # salted-hash at-rest entries); always run it — even for unknown
        # users, against a dummy — so response timing doesn't leak whether
        # a username exists
        candidate = user if user is not None else _DUMMY_USER
        if not candidate.check_password(req.password) or user is None:
            raise PermissionException("invalid RPC credentials")
        return user

    @staticmethod
    def _authorise(user, req: RpcRequest) -> None:
        if req.method in _OPEN_METHODS:
            return
        perms = set(user.permissions)
        if "ALL" in perms:
            return
        if req.method == "start_flow_dynamic":
            needed = start_flow_permission(req.args[0])
            if needed in perms:
                return
            raise PermissionException(
                f"user {user.username} may not start {req.args[0]}"
            )
        if req.method in perms or f"InvokeRpc.{req.method}" in perms:
            return
        raise PermissionException(
            f"user {user.username} may not call {req.method}"
        )

    # ------------------------------------------------------------ dispatch
    def _on_request(self, msg, ack=None) -> None:
        try:
            req = deserialize(msg.payload)
            assert isinstance(req, RpcRequest)
        except Exception:
            logger.exception("malformed RPC request dropped")
            if ack:
                ack()
            return
        self._pool.submit(self._handle, req, ack)

    def _handle(self, req: RpcRequest, ack) -> None:
        try:
            user = self._authenticate(req)
            self._authorise(user, req)
            if req.method in _FEED_METHODS:
                result = self._subscribe_feed(req)
            elif req.method == "unsubscribe":
                result = self._unsubscribe(req.args[0])
            else:
                fn = getattr(self._ops, req.method, None)
                if fn is None or req.method.startswith("_"):
                    raise PermissionException(
                        f"unknown RPC method {req.method}"
                    )
                kwargs = deserialize(req.kwargs_blob) if req.kwargs_blob else {}
                result = fn(*req.args, **kwargs)
            reply = RpcReply(req.request_id, True, serialize(result))
        except Exception as e:
            reply = RpcReply(
                req.request_id, False, b"", f"{type(e).__name__}: {e}"
            )
        self._messaging.send(
            req.reply_to, RPC_REPLY_TOPIC, serialize(reply),
            msg_id=f"rpcreply-{req.request_id}",
        )
        if ack:
            ack()

    # ------------------------------------------------------------- feeds
    def _subscribe_feed(self, req: RpcRequest):
        with self._lock:
            self._counter += 1
            sub_id = f"sub-{self._counter}"
        client = req.reply_to
        seq = {"n": 0}

        def push(*update):
            payload = update[0] if len(update) == 1 else list(update)
            with self._lock:
                if sub_id not in self._subscriptions:
                    return
                seq["n"] += 1
                n = seq["n"]
            try:
                self._messaging.send(
                    client, RPC_REPLY_TOPIC,
                    serialize(Observation(sub_id, serialize(payload))),
                    msg_id=f"obs-{sub_id}-{n}",
                )
            except Exception:
                logger.exception("dropping observation for %s", sub_id)

        with self._lock:
            self._subscriptions[sub_id] = {"client": client, "push": push}
        snapshot = getattr(self._ops, _FEED_METHODS[req.method])(push)
        return {"subscription_id": sub_id, "snapshot": snapshot}

    def _unsubscribe(self, sub_id: str) -> bool:
        with self._lock:
            sub = self._subscriptions.pop(sub_id, None)
        if sub is None:
            return False
        # detach from the underlying feed so long-lived nodes don't
        # accumulate dead callbacks
        self._ops.untrack(sub["push"])
        return True

    def stop(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
