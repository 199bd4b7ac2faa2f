"""ServiceHub: the node's service locator (counterpart of
corda_tpu/node/services.py).

Parity with the reference's ``ServiceHub`` (core/.../node/ServiceHub.kt:62-209
— vaultService, keyManagementService, identityService, attachments,
validatedTransactions, networkMapCache, transactionVerifierService, clock,
``loadState``/``toStateAndRef`` resolution, ``signInitialTransaction``,
``recordTransactions``) and ``ServiceHubInternal``
(node/.../services/api/ — + monitoring, scheduler). One concrete class;
every service injectable for the MockServices test tier.

The hub runs on the card unless it is given ``device="cpu"``: its default
verifier is the port's ``BatchedVerifierService`` on the shared scheduler
(the reference's is the host's ``InMemoryVerifierService``, :65), and
``device`` and ``tier`` are what the flows read to reach the card (the
resolve flow's ``verify_transaction_dag``, the top-level signature check).
A scheduler error or timeout in ``verify_stx_signatures`` fails the flow:
the reference sheds to the host check there (:150-156); the port has no
host fallback (ROADMAP.md, Queue 1 step 2, item 5).
"""

from __future__ import annotations

import time

from ..crypto import KeyPair, SecureHash
from ..ledger import (
    Party,
    SignedTransaction,
    StateAndRef,
    StateRef,
    TransactionState,
)
from ..device import resolve_device
from ..ops.ed25519 import Ed25519Tier
from ..serving import INTERACTIVE, device_scheduler
from ..verifier import BatchedVerifierService

from .identity import IdentityService, KeyManagementService
from .monitoring import MetricRegistry
from .network_map import NetworkMapCache
from .storage import AttachmentStorage, DBTransactionStorage
from .vault import NodeVaultService


class TransactionResolutionError(Exception):
    def __init__(self, tx_id: SecureHash):
        self.tx_id = tx_id
        super().__init__(f"transaction {tx_id} not found in storage")


class ServiceHub:
    """The service locator handed to flows and contracts."""

    def __init__(
        self,
        my_info=None,
        key_management_service: KeyManagementService | None = None,
        identity_service: IdentityService | None = None,
        vault_service: NodeVaultService | None = None,
        validated_transactions: DBTransactionStorage | None = None,
        attachments: AttachmentStorage | None = None,
        network_map_cache: NetworkMapCache | None = None,
        verifier_service=None,
        metrics: MetricRegistry | None = None,
        clock=time.time,
        notary_service=None,
        device=None,
        tier: Ed25519Tier | None = None,
    ):
        self.device = resolve_device(device)
        self.tier = tier
        self.my_info = my_info
        self.key_management_service = key_management_service or KeyManagementService()
        self.identity_service = identity_service or IdentityService()
        self.validated_transactions = validated_transactions or DBTransactionStorage()
        self.vault_service = vault_service or NodeVaultService(
            my_keys=self.key_management_service.keys, device=self.device
        )
        self.attachments = attachments or AttachmentStorage()
        self.network_map_cache = network_map_cache or NetworkMapCache()
        self.transaction_verifier_service = verifier_service or BatchedVerifierService(
            device=self.device, tier=tier
        )
        self.metrics = metrics or MetricRegistry()
        self.clock = clock
        self.scheduler_service = None  # wired by the node container
        # the NotaryService this node runs, if it is a notary (reference:
        # AbstractNode.makeCoreNotaryService, AbstractNode.kt:615-632)
        self.notary_service = notary_service
        # commit listeners: the flow engine registers here so a PARKED
        # wait_for_ledger_commit wakes when its transaction records (the
        # reference's equivalent push is DBTransactionStorage.updates
        # feeding waitForLedgerCommit)
        self._commit_listeners: list = []

    def add_commit_listener(self, fn) -> None:
        """``fn(stx)`` fires after each NEWLY-recorded transaction."""
        self._commit_listeners.append(fn)

    # -- identity conveniences ------------------------------------------------

    @property
    def my_identity(self) -> Party | None:
        if self.my_info is None:
            return None
        return self.my_info.legal_identity

    # -- state resolution (reference: ServiceHub.loadState/toStateAndRef) -----

    def load_state(self, ref: StateRef) -> TransactionState:
        stx = self.validated_transactions.get(ref.txhash)
        if stx is None:
            raise TransactionResolutionError(ref.txhash)
        return stx.tx.outputs[ref.index]

    def to_state_and_ref(self, ref: StateRef) -> StateAndRef:
        return StateAndRef(self.load_state(ref), ref)

    # -- recording (reference: ServiceHub.recordTransactions) -----------------

    def record_transactions(self, *stxs: SignedTransaction) -> None:
        """Store validated transactions and feed the vault; idempotent on
        replays (first-write-wins in storage, vault update skipped)."""
        for stx in stxs:
            if self.validated_transactions.add_transaction(stx):
                self.vault_service.record_transaction(stx)
                for fn in list(self._commit_listeners):
                    fn(stx)

    # -- signature verification routing ---------------------------------------

    def verify_stx_signatures(self, stx, allowed_missing=frozenset()) -> None:
        """Signature-set + signer-set validation of one transaction for the
        flow hot path. When this node runs the device-batched verifier
        tier, the check routes through the shared serving scheduler of the
        hub's device and tier (INTERACTIVE class) so concurrent flows'
        singleton verifies coalesce with verifier/notary batches into one
        device dispatch instead of paying a host loop each. Verdicts match
        ``stx.verify_signatures_except`` exactly (pass/fail per tx);
        invalid signatures surface as the batch tier's
        ``InvalidSignatureError``. A closed or saturated scheduler
        (``ServingError``), a failed dispatch or a timeout raises into the
        calling flow: nothing sheds to the host check.

        Traced as ``flow.verify_stx`` under the calling flow's span
        (docs/OBSERVABILITY.md), with the scheduler batch that served it
        (``serving.batch``)."""
        from ..observability import SPAN_FLOW_VERIFY, tracer

        trc = tracer()
        span = trc.start(SPAN_FLOW_VERIFY, trc.current(),
                         attrs={"tx.id": str(stx.id)})
        with span, trc.activate(span):
            allowed = set(allowed_missing)
            svc = self.transaction_verifier_service
            if getattr(svc, "routes_via_scheduler", False):
                report = device_scheduler(self.device, self.tier).submit_transactions(
                    [stx], [allowed], priority=INTERACTIVE,
                    use_device=getattr(svc, "use_device", False),
                ).result(timeout=120)
                span.set_attr("serving.batch", report.batch_seq)
                report.raise_first()
                return
            from ..observability.flowprof import flowprof_frame

            with flowprof_frame("host_verify"):
                stx.verify_signatures_except(allowed)

    # -- signing (reference: ServiceHub.signInitialTransaction :187-209) ------

    def _keypair_for(self, public_key=None) -> KeyPair:
        kms = self.key_management_service
        if public_key is None:
            if self.my_identity is not None:
                public_key = self.my_identity.owning_key
            else:
                public_key = next(iter(kms.keys))
        return kms._require(public_key)

    def sign_initial_transaction(self, builder, public_key=None) -> SignedTransaction:
        return builder.sign_initial_transaction(self._keypair_for(public_key))

    def add_signature(self, stx: SignedTransaction, public_key=None) -> SignedTransaction:
        key = public_key or self.my_identity.owning_key
        sig = self.key_management_service.sign(stx.id, key)
        return stx.with_additional_signature(sig)

    # -- ledger-tx resolution for verification --------------------------------

    def resolve_to_ledger_transaction(self, stx: SignedTransaction):
        return stx.tx.to_ledger_transaction(self.load_state)

    def shutdown(self) -> None:
        self.transaction_verifier_service.shutdown()
        self.validated_transactions.close()
        self.vault_service.close()
        self.attachments.close()
