"""Node process entry point (counterpart of corda_tpu/node/startup.py).

Capability parity with the reference's boot path (node/.../Corda.kt:7 main
→ NodeStartup.kt:30: banner, config load, node assembly, run-until-exit).

Standalone processes on one host share a sqlite-file DurableQueueBroker as
the message fabric (the role the reference's Artemis broker + localhost
bridges play in driver deployments); one node additionally runs the
network-map service, and every node registers with it on boot
(reference: registerWithNetworkMapIfConfigured, AbstractNode.kt:245).

    python -m corda_tpu_torch.node.startup --config node.conf --broker shared.db

Config is the HOCON subset of node/.../reference.conf (see config.py).
The node runs on the card (``build_node(..., device=None)``; ``device="cpu"``
runs the plain versions). The secure fabric (``--fabric-listen``,
``--fabric``) is not ported yet: it needs ``messaging/fabric.py`` and
``secure_transport.py`` (ROADMAP.md, Queue 1 step 9, the fabric item) and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

BANNER = r"""
   ______                __        ______  __  __
  / ____/___  _________/ /___ _  /_  __/ / / / / /
 / /   / __ \/ ___/ __  / __ `/   / /   / /_/ / / /
/ /___/ /_/ / /  / /_/ / /_/ /   / /   / ____/ /_/
\____/\____/_/   \__,_/\__,_/   /_/   /_/    (_)
        distributed ledger, PyTorch/CUDA port
"""


def _is_loopback_address(addr: str) -> bool:
    """True when ``host[:port]`` names the local host, including the IPv6
    forms ``[::1]:port`` and bare ``::1`` (rpartition-on-colon would
    mangle those)."""
    if addr.startswith("["):                       # [v6-host]:port
        host = addr[1:].partition("]")[0]
    elif addr.count(":") > 1:                      # bare IPv6 literal
        host = addr
    else:
        host, _, _ = addr.partition(":")
    return host in ("localhost", "127.0.0.1", "::1")


def build_node(
    config, broker_path: str, is_network_map: bool = False,
    fabric_listen: str | None = None, fabric_address: str | None = None,
    device=None,
):
    """Assemble a node over the fabric, on ``device`` (the card unless
    ``device="cpu"``).

    Three transports (reference: every wire is the node's Artemis broker,
    ArtemisMessagingServer.kt:132-376):

    - ``fabric_listen``: this node EMBEDS the broker and serves it to
      certified peers over the authenticated transport (the
      ArtemisMessagingServer role — required client certs). The node
      itself talks to its in-process broker directly, like the
      reference's NODE_USER local session.
    - ``fabric_address``: connect to a remote node's broker as a
      certified peer (the bridge/client role). The handshake fails —
      before any payload crosses — unless this node's certificate chains
      to the network trust root.
    - neither: open the shared sqlite broker file directly (single-host
      dev ensembles; the pre-secure-fabric mode).

    The first two raise ``NotImplementedError`` until the fabric item of
    ROADMAP.md Queue 1 step 9 is ported.

    Certificates auto-provision from the well-known dev CA only when
    ``config.dev_mode`` (reference: devMode certificate generation);
    production mode requires operator-provisioned certificate files.
    """
    from corda_tpu_torch.messaging import BrokerMessagingClient, DurableQueueBroker
    from corda_tpu_torch.node.network_map import (
        NetworkMapCache,
        NetworkMapClient,
        NetworkMapServer,
    )
    from corda_tpu_torch.node.node import Node

    from corda_tpu_torch.ledger import CordaX500Name

    import dataclasses as _dc
    import re as _re

    canonical = str(CordaX500Name.parse(config.my_legal_name))
    if config.base_directory == ".":
        # multiple nodes on one host must not share vault/checkpoint
        # files — default the base dir to a per-identity subdirectory
        safe = _re.sub(r"[^A-Za-z0-9._-]+", "_", canonical)
        config = _dc.replace(config, base_directory=f"./{safe}")

    if fabric_listen and fabric_address:
        raise ValueError(
            "--fabric-listen and --fabric are mutually exclusive: a node "
            "either embeds the broker or connects to a remote one"
        )
    # RPC rides the fabric; a non-localhost rpcAddress without the
    # authenticated transport would send credentials in clear (the
    # reference always rides TLS — ArtemisMessagingServer required
    # client certs). Dev ensembles keep rpcAddress on localhost.
    if (
        config.rpc_address
        and not _is_loopback_address(config.rpc_address)
        and not (fabric_listen or fabric_address)
    ):
        raise ValueError(
            f"rpcAddress {config.rpc_address!r} is not localhost: serving "
            "RPC off-host requires the secure fabric (--fabric-listen / "
            "--fabric), otherwise credentials cross the wire in clear"
        )
    if fabric_listen or fabric_address:
        raise NotImplementedError(
            "the node's secure fabric (--fabric-listen / --fabric) needs "
            "messaging/fabric.py and secure_transport.py, which come with the "
            "fabric item of ROADMAP.md Queue 1 step 9; use the shared broker file"
        )
    messaging = BrokerMessagingClient(DurableQueueBroker(broker_path), canonical)
    cache = NetworkMapCache()
    node = Node(
        config, messaging, network_map=cache,
        persistent=broker_path != ":memory:", device=device,
    )
    if is_network_map:
        node.network_map_server = NetworkMapServer(messaging, cache)
    node.network_map_client = NetworkMapClient(messaging, cache)
    node.start()
    if config.network_map_address:
        node.network_map_client.register(config.network_map_address, node.info)
    return node


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="corda-tpu-node",
        description="Run a corda_tpu_torch node (reference: NodeStartup)",
    )
    parser.add_argument("--config", required=True, help="HOCON node config")
    parser.add_argument(
        "--broker", default="broker.db",
        help="shared durable-broker sqlite file (the host message fabric)",
    )
    parser.add_argument(
        "--network-map", action="store_true",
        help="also run the network-map service on this node",
    )
    parser.add_argument(
        "--fabric-listen", default=None, metavar="HOST:PORT",
        help="embed the broker and serve it to certified peers over the "
             "mutually-authenticated transport (ArtemisMessagingServer role)",
    )
    parser.add_argument(
        "--fabric", default=None, metavar="HOST:PORT", dest="fabric_address",
        help="connect to a remote node's broker as a certified peer "
             "instead of opening the sqlite fabric file",
    )
    parser.add_argument("--no-banner", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-7s [%(name)s] %(message)s",
    )
    # operator stack dump on demand: `kill -USR1 <pid>` writes every
    # thread's Python stack to stderr (the node log) — the first tool for
    # a wedged node (reference role: jstack on a JVM node)
    import faulthandler
    import signal

    try:
        faulthandler.register(signal.SIGUSR1)
    except (AttributeError, ValueError):
        pass  # platform without SIGUSR1; non-main-thread registration
    if not args.no_banner:
        print(BANNER)

    from corda_tpu_torch.node.config import load_config

    config = load_config(args.config)
    node = build_node(
        config, args.broker, is_network_map=args.network_map,
        fabric_listen=args.fabric_listen, fabric_address=args.fabric_address,
    )
    print(f"Node {node.party.name} started. RPC users: "
          f"{[u.username for u in config.rpc_users]}")
    sys.stdout.flush()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    print("Shutting down…")
    node.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
