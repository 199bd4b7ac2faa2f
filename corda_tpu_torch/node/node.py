"""The node container: configuration → a running node (counterpart of
corda_tpu/node/node.py).

Capability parity with the reference's boot path (node/.../Corda.kt:7 →
NodeStartup.kt:30 → AbstractNode.start(), AbstractNode.kt:202-255): from a
``NodeConfiguration``, assemble persistence, services (vault, identity,
keys, attachments, network map, scheduler), the verifier service selected
by ``verifierType``, the notary service selected by the notary config
(simple / validating / batched / Raft / BFT —
AbstractNode.makeCoreNotaryService :615-632), the flow state machine, and
the RPC server; register with the network map; start the scheduler;
restore checkpointed flows.

Transport is injected (an ``InMemoryMessagingNetwork`` for in-process
ensembles — the driver/demo mode — or a ``DurableQueueBroker`` client for
crash-durable messaging; a gRPC transport slots in the same interface for
multi-host DCN deployment).

The node runs on ``device`` (the card unless ``device="cpu"``; with no CUDA
device it raises): its ``ServiceHub`` and so its flow engine's checks, the
``DeviceBatched`` verifier service and, with the state store's gate on, the
notary's ``DeviceShardedUniquenessProvider``. ``OutOfProcess`` with no
broker transport logs and takes the in-process pool, as in the reference:
host verification either way.
"""

from __future__ import annotations

import logging
from pathlib import Path

from corda_tpu_torch.crypto import generate_keypair
from corda_tpu_torch.device import resolve_device
from corda_tpu_torch.ledger import CordaX500Name, Party

from .config import NodeConfiguration, VerifierType
from .identity import IdentityService, KeyManagementService
from .network_map import NetworkMapCache, NodeInfo
from .scheduler import NodeSchedulerService
from .services import ServiceHub
from .storage import AttachmentStorage, DBTransactionStorage
from .vault import NodeVaultService

logger = logging.getLogger(__name__)


class Node:
    """A fully-assembled node (reference: AbstractNode + Node)."""

    def __init__(
        self,
        config: NodeConfiguration,
        messaging,
        network_map: NetworkMapCache | None = None,
        party_resolver=None,
        keypair=None,
        persistent: bool = False,
        device=None,
    ):
        # the flow engine and the verifier import the observability layers,
        # which may read node.monitoring while this package initialises
        from corda_tpu_torch.flows import CheckpointStorage, StateMachineManager

        self.device = resolve_device(device)
        self.config = config
        self.messaging = messaging
        # CorDapp loading (reference: CordappLoader.kt:41-63) — named
        # packages plus the plugins-directory scan; the loader records a
        # manifest of what each app registered (contracts, responders,
        # wire types) for the provider queries
        from corda_tpu_torch.node.cordapp import CordappLoader

        self.cordapp_loader = CordappLoader()
        for pkg in config.cordapp_packages:
            self.cordapp_loader.load_package(pkg)
        if config.cordapp_directory:
            self.cordapp_loader.load_directory(config.cordapp_directory)
        if config.mesh_fan_out is not None:
            # force the device-mesh fan-out policy (default: auto when
            # multiple accelerator devices are visible)
            from corda_tpu_torch.parallel import enable_service_mesh

            enable_service_mesh(config.mesh_fan_out)
        name = CordaX500Name.parse(config.my_legal_name) if isinstance(
            config.my_legal_name, str
        ) else config.my_legal_name
        self.keypair = keypair or generate_keypair()
        self.party = Party(name, self.keypair.public)
        notary_mode = ""
        if config.notary is not None:
            notary_mode = "validating" if config.notary.validating else "simple"
        self.info = NodeInfo(
            (config.p2p_address,), (self.party,), notary_mode=notary_mode
        )
        # peers address us by the canonical X.500 string — a transport
        # endpoint registered under anything else silently receives nothing
        expected = str(self.party.name)
        if messaging.me.name != expected:
            raise ValueError(
                f"messaging endpoint is {messaging.me.name!r} but peers "
                f"will address {expected!r} — create the transport node "
                "with str(CordaX500Name.parse(config.my_legal_name))"
            )

        base = Path(config.base_directory)
        if persistent:
            base.mkdir(parents=True, exist_ok=True)
        db = (lambda f: str(base / f)) if persistent else (lambda f: ":memory:")
        self._durable_store_for = self._make_durability_factory(base)

        network_map = network_map or NetworkMapCache()
        identity_service = IdentityService()
        kms = KeyManagementService([self.keypair], identity_service)
        self._notary_uniqueness = None
        notary_service = self._make_notary_service(db)
        self.services = ServiceHub(
            my_info=self.info,
            key_management_service=kms,
            identity_service=identity_service,
            vault_service=NodeVaultService(
                db("vault.db"), my_keys=kms.keys,
                journal=self._durable_store_for("vault"), device=self.device,
            ),
            validated_transactions=DBTransactionStorage(db("transactions.db")),
            attachments=AttachmentStorage(db("attachments.db")),
            network_map_cache=network_map,
            verifier_service=self._make_verifier_service(),
            notary_service=notary_service,
            device=self.device,
        )
        # attachment-carried contract code: the verify path resolves
        # unknown contract names from transaction attachments through this
        # store (ledger/attachment_code.py; reference:
        # AttachmentsClassLoader.kt:24)
        from corda_tpu_torch.ledger.attachment_code import set_attachment_fetcher

        attachments_store = self.services.attachments

        def _fetch(att_id):
            att = attachments_store.open_attachment(att_id)
            return att.data if att is not None else None

        set_attachment_fetcher(_fetch)
        if party_resolver is None:
            def party_resolver(sender_name: str):
                info = network_map.get_node_by_legal_name(
                    CordaX500Name.parse(sender_name)
                )
                return info.legal_identity if info else None
        flow_store = self._durable_store_for("flows")
        if flow_store is not None:
            from corda_tpu_torch.flows import WalCheckpointStorage

            checkpoints = WalCheckpointStorage(flow_store)
        else:
            checkpoints = CheckpointStorage(db("checkpoints.db"))
        self.smm = StateMachineManager(
            messaging,
            checkpoints,
            self.party,
            party_resolver,
            services=self.services,
        )
        # imported here, not at module level: rpc depends on node.vault,
        # so a module-level import would make corda_tpu_torch.rpc unimportable
        # on its own (circular) — deferred, both import orders work
        from corda_tpu_torch.rpc import CordaRPCOps, RPCServer

        self.rpc_ops = CordaRPCOps(self.services, self.smm)
        self.rpc_server = RPCServer(
            self.rpc_ops, messaging, rpc_users=config.rpc_users
        )
        from .scheduler import make_scheduled_flow_starter

        self._start_scheduled_flow = make_scheduled_flow_starter(
            self.smm, self.party.name
        )
        self.scheduler = NodeSchedulerService(self._start_scheduled_flow)
        self.services.scheduler_service = self.scheduler
        # SchedulableState outputs recorded to the vault drive time-based
        # flow starts (reference: ScheduledActivityObserver wired in
        # AbstractNode); the track snapshot re-derives schedules on restart
        self.scheduler.observe_vault(self.services.vault_service)
        # app-provided node services (reference: @CordaService classes
        # instantiated in AbstractNode.installCordaServices) — only those
        # defined by cordapps THIS node's config loaded
        from corda_tpu_torch.node.cordapp import install_corda_services

        install_corda_services(
            self.services, self.party, self.keypair,
            loaded_modules={
                app.module for app in self.cordapp_loader.cordapps
            },
        )
        self._started = False

    # ------------------------------------------------------------ assembly
    def _make_durability_factory(self, base: Path):
        """Owner-name → DurableStore factory, or a None-returning stub
        when durability is off (the default: nothing imported beyond the
        cheap enabled() probe, no files opened, no metrics created —
        docs/DURABILITY.md). Enabled with ``CORDA_TPU_DURABILITY=1``; the
        base directory is ``CORDA_TPU_WAL_DIR`` (one subdirectory per
        node name, so in-process ensembles sharing the env don't collide)
        or the node's own base directory."""
        from corda_tpu_torch.durability import durability_enabled, store_for

        if not durability_enabled():
            return lambda owner: None
        import os as _os
        import re as _re

        env_base = _os.environ.get("CORDA_TPU_WAL_DIR", "")
        # per-node-name slug in BOTH branches: in-process ensembles whose
        # configs share a base_directory (the default ".") must not share
        # one WAL directory — two WriteAheadLogs on the same files would
        # truncate each other's live tail segments
        slug = _re.sub(r"[^A-Za-z0-9_.=,-]", "_", str(self.party.name))
        root = _os.path.join(env_base or str(base / "durability"), slug)
        return lambda owner: store_for(owner, base_dir=root)

    def _make_verifier_service(self):
        from corda_tpu_torch.verifier import BatchedVerifierService, InMemoryVerifierService

        vt = self.config.verifier_type
        if vt is VerifierType.DeviceBatched:
            return BatchedVerifierService(
                max_batch=self.config.verification_batch_max,
                window_s=self.config.verification_window_ms / 1000.0,
                device=self.device,
            )
        if vt is VerifierType.OutOfProcess:
            # external workers compete on the broker's verifier.requests
            # queue (reference: Node.makeTransactionVerifierService →
            # NodeMessagingClient.verifierService, Node.kt:103)
            broker = getattr(self.messaging, "_broker", None)
            if broker is not None:
                from corda_tpu_torch.verifier.worker import (
                    OutOfProcessVerifierService,
                )

                return OutOfProcessVerifierService(
                    broker, str(self.party.name)
                )
            logger.warning(
                "verifierType=OutOfProcess needs a broker transport; "
                "falling back to the in-process pool"
            )
        return InMemoryVerifierService()

    def _make_notary_service(self, db):
        """reference: AbstractNode.makeCoreNotaryService
        (AbstractNode.kt:615-632) — notary flavor from config."""
        cfg = self.config.notary
        if cfg is None:
            return None
        from corda_tpu_torch.notary import PersistentUniquenessProvider
        from corda_tpu_torch.notary.service import (
            SimpleNotaryService,
            ValidatingNotaryService,
        )

        if cfg.raft is not None:
            # multi-process CFT cluster: this node is one Raft replica,
            # speaking raft.* topics over its own fabric endpoint to the
            # peers named in clusterAddresses (reference: the out-of-
            # process Copycat cluster, NodeConfiguration.kt:45). Started
            # with the node (start()/stop()).
            from corda_tpu_torch.notary import RaftUniquenessProvider

            me = str(self.party.name)
            # replica names ARE fabric endpoint names (canonical X.500
            # node names — the shape the process driver generates); a
            # nodeAddress differing from this node's name, or a peer
            # entry that isn't an X.500 name (e.g. a reference-style
            # host:port), would yield divergent/unresolvable membership
            # and the cluster would hang without quorum. Fail fast.
            if cfg.raft.node_address and cfg.raft.node_address != me:
                raise ValueError(
                    f"raft nodeAddress {cfg.raft.node_address!r} must equal "
                    f"this node's name {me!r} (replicas are addressed by "
                    "node name on the messaging fabric)"
                )
            from corda_tpu_torch.ledger import CordaX500Name

            peers = set()
            for peer in cfg.raft.cluster_addresses:
                try:
                    # accept any valid X.500 spelling; members resolve by
                    # the CANONICAL form (which is what node endpoints
                    # register as)
                    peers.add(str(CordaX500Name.parse(peer)))
                except Exception:
                    raise ValueError(
                        f"raft clusterAddresses entry {peer!r} is not an "
                        "X.500 node name — replicas are addressed by node "
                        "name on the messaging fabric, not host:port"
                    ) from None
            names = sorted({me, *peers})
            storage_path = db("raft.db")
            uniqueness = RaftUniquenessProvider.make_node_on_endpoint(
                me, names, self.messaging,
                storage_path=(
                    storage_path if storage_path != ":memory:" else None
                ),
            )
        else:
            # BFT clusters remain externally wired (they need the whole
            # replica set's keys up front); the container builds the
            # single-replica and Raft tiers
            notary_store = self._durable_store_for("notary")
            from corda_tpu_torch.statestore import statestore_enabled

            if statestore_enabled():
                # device-resident consumed set (docs/STATE_STORE.md);
                # the durable store, when configured, becomes its
                # recovery/spill journal
                from corda_tpu_torch.statestore import (
                    DeviceShardedUniquenessProvider,
                )

                uniqueness = DeviceShardedUniquenessProvider(notary_store, device=self.device)
            elif notary_store is not None:
                from corda_tpu_torch.notary import DurableUniquenessProvider

                uniqueness = DurableUniquenessProvider(notary_store)
            else:
                uniqueness = PersistentUniquenessProvider(db("notary.db"))
        self._notary_uniqueness = uniqueness
        cls = ValidatingNotaryService if cfg.validating else SimpleNotaryService
        return cls(self.party, self.keypair, uniqueness)

    def set_notary_uniqueness_provider(self, provider) -> None:
        """Swap in a replicated (Raft/BFT) uniqueness provider built by the
        cluster driver before ``start()``. The container-built local
        provider is closed and fully replaced."""
        if self.services.notary_service is None:
            raise ValueError("node has no notary service")
        old = self._notary_uniqueness
        if old is not None and hasattr(old, "close"):
            old.close()
        self._notary_uniqueness = provider
        self.services.notary_service.uniqueness = provider

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Node":
        # add_node also registers us as a notary when info.notary_mode is
        # set — single source of truth for the mode
        self.services.network_map_cache.add_node(self.info)
        raft_node = getattr(self._notary_uniqueness, "node", None)
        if raft_node is not None:
            raft_node.start()
        self.scheduler.start()
        restored = self.smm.restore()
        if restored:
            logger.info(
                "%s: restored %d checkpointed flow(s)",
                self.party.name, len(restored),
            )
        self._started = True
        return self

    def run_flow(self, flow, timeout: float = 60):
        return self.smm.start_flow(flow).result.result(timeout=timeout)

    def stop(self) -> None:
        self.scheduler.stop()
        self.rpc_server.stop()
        self.smm.stop()
        # the durable checkpoint tier owns an open WAL tail: release it
        # on stop so an in-process restart (the chaos orchestrator's
        # restart_fn shape) never has two handles appending to one
        # segment. The legacy sqlite storage keeps its historical
        # never-closed semantics.
        from corda_tpu_torch.flows import WalCheckpointStorage

        if isinstance(self.smm.checkpoints, WalCheckpointStorage):
            self.smm.checkpoints.close()
        self.services.shutdown()
        if self._notary_uniqueness is not None and hasattr(
            self._notary_uniqueness, "close"
        ):
            self._notary_uniqueness.close()
        self._started = False

    def __repr__(self):
        return f"Node({self.party.name}, started={self._started})"
