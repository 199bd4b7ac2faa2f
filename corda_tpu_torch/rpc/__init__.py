"""RPC tier (SURVEY.md §2.1 RPC surface, §2.3 RPC server, §2.5 client/rpc) (the port's copy of
corda_tpu/rpc/__init__.py, import root changed).

The reference serves ``CordaRPCOps`` (core/.../messaging/CordaRPCOps.kt:54,
30+ operations) over Artemis queues with a hand-rolled protocol of
request/reply plus server-pushed Observables (node-api/.../RPCApi.kt:15-50;
server: node/.../messaging/RPCServer.kt; client:
client/rpc/.../CordaRPCClient.kt + RPCClientProxyHandler.kt).

Here the same surface rides the framework's messaging layer (in-memory or
durable broker; gRPC/DCN in deployment): one request topic per node, one
reply topic per client, CBE payloads, and streamed feeds as pushed
``Observation`` messages keyed by subscription id — the Artemis-Observable
muxing redesigned as plain topic streams.
"""

from .ops import CordaRPCOps, PermissionException
from .server import RPCServer
from .client import CordaRPCClient, RPCConnection, Observable
from .json_support import (
    IdentityJsonMapper,
    JsonMapper,
    JsonSerializationError,
    RpcJsonMapper,
)
from .string_calls import (
    CallParseError,
    ParsedMethodCall,
    StringToMethodCallParser,
)

__all__ = [
    "CordaRPCOps", "PermissionException",
    "RPCServer",
    "CordaRPCClient", "RPCConnection", "Observable",
    "IdentityJsonMapper", "JsonMapper", "JsonSerializationError",
    "RpcJsonMapper",
    "CallParseError", "ParsedMethodCall", "StringToMethodCallParser",
]
