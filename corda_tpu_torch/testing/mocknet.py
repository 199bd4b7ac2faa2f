"""In-process mock network of full nodes (counterpart of
corda_tpu/testing/mocknet.py).

Capability parity with the reference's ``MockNetwork``
(testing/node-driver/.../node/MockNode.kt:78-177): N nodes with real
services (vault, storage, identity, flows, notary) wired onto an
``InMemoryMessagingNetwork`` in one process, with background pumping for
integration-style tests or manual pumping for deterministic step-through.
This is test tier 2 of the reference's ladder (SURVEY.md §4) — protocols
exercised without processes.

Every node's ``ServiceHub`` runs on ``device`` and ``tier`` (the card
unless ``device="cpu"``), and so does a notary node's batched notary
(``create_notary_node(batched=True)``). A node restarts from its durable
state (``keypair``, ``endpoint``, ``checkpoints``; docs/DURABILITY.md).
Each node runs the node scheduler over its schedulable vault states
(``node/scheduler.py``), pumped by hand under an injected ``clock``.

One difference: the mock network's nodes park a waiting flow after
``MOCK_PARKING_GRACE_S`` (1 s), not after the engine's 50 ms.
"""

from __future__ import annotations

from ..crypto import generate_keypair
from ..flows import CheckpointStorage, StateMachineManager
from ..ledger import CordaX500Name, Party
from ..messaging import InMemoryMessagingNetwork
from ..node import NetworkMapCache, NodeInfo, ServiceHub
from ..node.identity import IdentityService, KeyManagementService

# Every node of a mock network shares one interpreter, so a flow's wait for
# its peer takes in the peer's work, every other node's and the heap's full
# collections (100-200 ms on an H100 machine's host). A parked flow resumes
# by replaying its whole op log, decoding every received batch again, so at
# the engine's 50 ms one such stall late in a 1,000-round back-chain resolve
# can make both peers park again and again, and the rounds turn quadratic.
# Back to the engine's default once a replay no longer grows with the log.
MOCK_PARKING_GRACE_S = 1.0


def make_test_party(name: str, city: str = "London", country: str = "GB"):
    kp = generate_keypair()
    return Party(CordaX500Name(name, city, country), kp.public), kp


class MockNode:
    """One full in-process node: ServiceHub + StateMachineManager over the
    shared mock transport (reference: MockNode, MockNode.kt:177). Its
    identity is ``keypair`` (a fresh one by default).

    Restartable for crash/recovery scenarios (docs/DURABILITY.md): pass
    ``keypair`` (the identity must survive the restart), ``endpoint``
    (the transport handle ``net.restart_node(name)`` returned) and
    ``checkpoints`` (the durable storage the previous incarnation wrote)
    to rebuild a node from durable state alone — the kill-storm soak's
    restart path."""

    def __init__(self, net: InMemoryMessagingNetwork, name: str,
                 network_map: NetworkMapCache, party_resolver,
                 notary_service_factory=None, clock=None, keypair=None, endpoint=None,
                 checkpoints=None, device=None, tier=None):
        self.keypair = keypair or generate_keypair()
        self.party = Party(
            CordaX500Name(name, "London", "GB"), self.keypair.public
        )
        identity_service = IdentityService()
        kms = KeyManagementService([self.keypair], identity_service)
        self.info = NodeInfo(("mock:" + name,), (self.party,))
        notary_service = None
        if notary_service_factory is not None:
            notary_service = notary_service_factory(self.party, self.keypair)
        self.services = ServiceHub(
            my_info=self.info,
            key_management_service=kms,
            identity_service=identity_service,
            network_map_cache=network_map,
            notary_service=notary_service,
            device=device,
            tier=tier,
        )
        self.smm = StateMachineManager(
            endpoint if endpoint is not None
            else net.create_node(str(self.party.name)),
            checkpoints if checkpoints is not None else CheckpointStorage(),
            self.party,
            party_resolver,
            services=self.services,
            parking_grace_s=MOCK_PARKING_GRACE_S,
        )
        # manual-pump scheduler over SchedulableState vault outputs: tests
        # inject a clock and call scheduler.pump() to fire due activities
        # deterministically (the reference's TestClock idiom; a node of
        # node/node.py runs the same service threaded)
        import time as _time

        from ..node.scheduler import NodeSchedulerService, make_scheduled_flow_starter

        self.scheduler = NodeSchedulerService(
            make_scheduled_flow_starter(self.smm, self.party.name),
            clock=clock or _time.time,
        )
        self.services.scheduler_service = self.scheduler
        self.scheduler.observe_vault(self.services.vault_service)

    def run_flow(self, flow, timeout: float = 60):
        """Start a flow and block for its result."""
        return self.smm.start_flow(flow).result.result(timeout=timeout)

    def stop(self):
        self.smm.stop()
        notary = self.services.notary_service
        if hasattr(notary, "shutdown"):
            notary.shutdown()  # a batched notary's window threads
        self.services.shutdown()


class MockNetworkNodes:
    """A named collection of MockNodes over one InMemoryMessagingNetwork +
    shared network map (reference: MockNetwork + InMemoryMessagingNetwork,
    with background pump or manual ``pump()`` for deterministic tests)."""

    def __init__(self, pump: bool = True, device=None, tier=None):
        self.device = device
        self.tier = tier
        self.net = InMemoryMessagingNetwork()
        self.nmap = NetworkMapCache()
        self.parties: dict[str, Party] = {}
        self.nodes: dict[str, MockNode] = {}
        if pump:
            self.net.start_pumping()

    def create_node(self, name: str, notary_service_factory=None,
                    validating_notary: bool | None = None, clock=None, keypair=None,
                    endpoint=None, checkpoints=None, tier=None) -> MockNode:
        """A node on the network's device; ``tier`` overrides the
        network's ed25519 tier for this node. ``notary_service_factory
        (party, keypair)`` makes it a notary node running the service the
        factory builds, advertised as validating unless
        ``validating_notary`` is False (a validating notary is sent the
        whole transaction, a non-validating one a tear-off). With
        ``endpoint`` the node is a restart (``MockNode``): it is already
        in the network map."""
        node = MockNode(
            self.net, name, self.nmap, self.parties.get, notary_service_factory, clock=clock,
            keypair=keypair, endpoint=endpoint, checkpoints=checkpoints,
            device=self.device, tier=tier or self.tier,
        )
        self.parties[str(node.party.name)] = node.party
        if endpoint is None:
            self.nmap.add_node(node.info)
        if notary_service_factory is not None and endpoint is None:
            self.nmap.add_notary(
                node.party,
                validating=True if validating_notary is None else validating_notary,
            )
        self.nodes[name] = node
        return node

    def create_notary_node(self, name: str = "Notary", validating: bool = True,
                           batched: bool = False, **batched_kw) -> MockNode:
        """A notary node over an in-memory uniqueness provider: the host's
        ``ValidatingNotaryService`` or ``SimpleNotaryService`` by
        ``validating``, or with ``batched`` a ``BatchedNotaryService`` on
        the network's device and ed25519 tier, taking ``batched_kw``
        (``max_batch``, ``window_s``, ...). A batched notary is sent whole
        transactions."""
        from ..notary import (
            BatchedNotaryService,
            InMemoryUniquenessProvider,
            SimpleNotaryService,
            ValidatingNotaryService,
        )

        if batched:
            def factory(party, kp):
                return BatchedNotaryService(party, kp, InMemoryUniquenessProvider(),
                                            device=self.device, tier=self.tier, **batched_kw)
        else:
            cls = ValidatingNotaryService if validating else SimpleNotaryService

            def factory(party, kp):
                return cls(party, kp, InMemoryUniquenessProvider())
        return self.create_node(name, notary_service_factory=factory,
                                validating_notary=validating or batched)

    def pump(self) -> bool:
        """Deliver one round of messages (deterministic manual mode)."""
        return self.net.pump()

    def run_until_quiescent(self) -> int:
        return self.net.run_until_quiescent()

    def stop(self):
        for node in self.nodes.values():
            node.stop()
        self.net.stop_pumping()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
