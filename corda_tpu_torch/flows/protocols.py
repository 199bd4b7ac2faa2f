"""Built-in protocol flows (counterpart of corda_tpu/flows/protocols.py).

Copied from the reference's core flow library
(core/src/main/kotlin/net/corda/core/flows/ + core/.../internal/):

- ``SendTransactionFlow`` / ``ReceiveTransactionFlow`` — transaction
  propagation with back-chain data vending
  (SendTransactionFlow.kt, ReceiveTransactionFlow.kt:32).
- ``ResolveTransactionsFlow`` — BFS dependency download with a DoS cap,
  then wavefront-parallel verification of the fetched DAG on the card
  (``parallel/wavefront.py``; ResolveTransactionsFlow.kt:38-107).
- ``NotaryFlowClient`` / ``NotaryServiceFlow`` — the notarisation round
  trip (NotaryFlow.kt:35-144), validating and non-validating (tear-off);
  the responder serves a simple, a validating or a batched notary.
- ``FinalityFlow`` — verify, notarise, record, broadcast
  (FinalityFlow.kt:28-62), with ``BroadcastTransactionFlow`` /
  ``ReceiveBroadcastFlow`` for each recipient.
- ``CollectSignaturesFlow`` / ``SignTransactionFlow`` — multi-party signing
  (CollectSignaturesFlow.kt).
- ``NotaryChangeFlow`` / ``ContractUpgradeFlow`` — the state-replacement
  protocols (NotaryChangeFlow.kt, ContractUpgradeFlow.kt,
  AbstractStateReplacementFlow.kt) over the special ledger forms.

Wire shape: after the initial SignedTransaction message the *sender* turns
into a data vendor answering ``FetchRequest`` batches ("tx" /
"attachment" / "end") — the session-local equivalent of the reference's
FetchDataFlow request/response rounds (FetchDataFlow.kt:39-141), except
requests are batched per BFS level rather than one hash per round-trip.

Two differences from the reference, both by the port's rule that the card
is the default and nothing falls back to the host:

- ``ResolveTransactionsFlow`` resolves on the card unless it is given
  ``use_device=False`` (the reference's default, :161-165, is the host).
  It reads the device and the ed25519 tier from the node's ``ServiceHub``
  (``services.device``, ``services.tier``), not from its own arguments: a
  flow's arguments are serialised into its checkpoint.
- The top-level signature check (``_verify_sigs``) goes through the
  ``ServiceHub``, whose shared-scheduler route raises a scheduler error
  into the flow instead of shedding to the host check.

Left out (ROADMAP.md, Queue 1 step 4b): the flow profiler's park hint
around the notary round trip (``flowprof_hint``, :335 and :352).
"""

from __future__ import annotations

import dataclasses

from ..crypto import is_fulfilled_by
from ..ledger import (
    ComponentGroupType,
    FilteredTransaction,
    NotaryChangeCommand,
    Party,
    SignedTransaction,
    StateAndRef,
    StateRef,
    TransactionBuilder,
    UpgradeCommand,
    resolve_contract,
)
from ..serialization import cbe_serializable

from .api import FlowException, FlowLogic, FlowSession, InitiatedBy

# DoS bound on dependency resolution, mirroring the reference's hard cap
# (ResolveTransactionsFlow.kt:76).
MAX_RESOLVE_TRANSACTIONS = 5000


class NotaryException(FlowException):
    """Notarisation failed — double spend, bad time window, wrong notary
    (reference: NotaryException wrapping NotaryError)."""


@cbe_serializable(name="flows.FetchRequest")
@dataclasses.dataclass(frozen=True)
class FetchRequest:
    """One data-vending round: ask the sender for transactions or
    attachments by hash; kind == "end" closes the vending loop."""

    kind: str            # "tx" | "attachment" | "end"
    hashes: tuple = ()


def _verify_sigs(flow: FlowLogic, stx: SignedTransaction, allowed: set) -> None:
    """Flow-side signature verification: routed through the serving
    scheduler (INTERACTIVE class) when the node's ServiceHub runs the
    device-batched verifier tier — concurrent flows' singleton verifies
    then coalesce into one device batch — and the plain host check
    otherwise (identical verdicts either way). A scheduler error fails
    the flow: the port's hub does not shed to the host check."""
    services = getattr(flow, "services", None)
    if services is not None and hasattr(services, "verify_stx_signatures"):
        services.verify_stx_signatures(stx, allowed)
    else:
        stx.verify_signatures_except(allowed)


# --------------------------------------------------------------- vending

def vend_data(flow: FlowLogic, session: FlowSession,
              root_stx: SignedTransaction,
              max_served: int = MAX_RESOLVE_TRANSACTIONS) -> None:
    """Serve the counterparty's FetchRequests from local storage until it
    sends kind="end". Sender side of the back-chain protocol.

    Only hashes in the *back-chain closure* of ``root_stx`` are served: the
    authorised set starts at the root's direct dependencies/attachments and
    grows only when a transaction in the closure is actually served (its
    own dependencies become requestable). A counterparty probing for
    unrelated private transactions gets a rejection, mirroring the
    reference DataVendingFlow's authorised-transaction tracking."""
    services = flow.services
    authorised_tx = {ref.txhash for ref in root_stx.inputs}
    authorised_att = set(root_stx.tx.attachments)
    served = 0
    while True:
        req = session.receive(FetchRequest).unwrap(lambda r: r)
        if req.kind == "end":
            return
        served += len(req.hashes)
        if served > max_served:
            raise FlowException("counterparty requested too much data")
        if req.kind == "tx":
            items = []
            for h in req.hashes:
                if h not in authorised_tx:
                    raise FlowException(
                        f"transaction {h} is not in the back-chain being sent"
                    )
                stx = services.validated_transactions.get(h)
                if stx is None:
                    raise FlowException(f"transaction {h} not found")
                items.append(stx)
                authorised_tx.update(ref.txhash for ref in stx.inputs)
                authorised_att.update(stx.tx.attachments)
            session.send(items)
        elif req.kind == "attachment":
            items = []
            for h in req.hashes:
                if h not in authorised_att:
                    raise FlowException(
                        f"attachment {h} is not referenced by the chain being sent"
                    )
                att = services.attachments.open_attachment(h)
                if att is None:
                    raise FlowException(f"attachment {h} not found")
                items.append(att.data)
            session.send(items)
        else:
            raise FlowException(f"unknown fetch kind {req.kind!r}")


class SendTransactionFlow(FlowLogic):
    """Send ``stx`` and then vend its back-chain / attachments on request
    (reference: SendTransactionFlow + DataVendingFlow)."""

    def __init__(self, session: FlowSession, stx: SignedTransaction):
        self.session = session
        self.stx = stx

    def call(self):
        self.session.send(self.stx)
        vend_data(self, self.session, self.stx)


class ResolveTransactionsFlow(FlowLogic):
    """Fetch and verify every unvalidated dependency of ``stx`` via the
    open session, then record them in topological order.

    The reference walks the back-chain with one request per hash and
    verifies sequentially deps-first (ResolveTransactionsFlow.kt:84-107).
    Here each BFS level is fetched as one batch, and the downloaded DAG is
    verified wavefront-parallel on the node's device (all transactions of
    equal depth are one batched signature dispatch — parallel/wavefront.py);
    ``use_device=False`` is the reference's host route."""

    def __init__(self, stx: SignedTransaction, session: FlowSession,
                 use_device: bool = True):
        self.stx = stx
        self.session = session
        self.use_device = use_device

    def call(self):
        services = self.services
        storage = services.validated_transactions
        fetched: dict = {}

        # every "is it already in storage?" decision is RECORDED: it gates
        # which fetch ops run, and storage mutates between a park and its
        # replay (this very flow records what it fetches — an unrecorded
        # gate would make the replay skip ops and misalign the op log)
        frontier = self.record(lambda: sorted(
            {ref.txhash for ref in self.stx.inputs
             if ref.txhash not in storage},
            key=lambda h: h.bytes,
        ))
        while frontier:
            if len(fetched) + len(frontier) > MAX_RESOLVE_TRANSACTIONS:
                raise FlowException(
                    f"back-chain exceeds {MAX_RESOLVE_TRANSACTIONS} transactions"
                )
            items = self.session.send_and_receive(
                list, FetchRequest("tx", tuple(frontier))
            ).unwrap(lambda xs: xs)
            if len(items) != len(frontier):
                raise FlowException("wrong number of transactions returned")
            for want, got in zip(frontier, items):
                if not isinstance(got, SignedTransaction) or got.id != want:
                    # downloaded-data integrity: the check of
                    # FetchDataFlow.kt:84-91 — id is the Merkle root of the
                    # received bytes, so a lying peer cannot substitute
                    raise FlowException(f"peer sent wrong transaction for {want}")
                fetched[got.id] = got

            def next_frontier(items=items):
                out = set()
                for got in items:
                    for ref in got.inputs:
                        h = ref.txhash
                        if h not in fetched and h not in storage:
                            out.add(h)
                return sorted(out, key=lambda h: h.bytes)

            frontier = self.record(next_frontier)

        self._fetch_attachments(fetched)
        self.session.send(FetchRequest("end"))

        if fetched:
            def resolve_external(ref):
                stx = storage.get(ref.txhash)
                if stx is None:
                    return None
                return stx.tx.outputs[ref.index]

            result = self.record(lambda: self._verify_and_note(
                fetched, resolve_external
            ))
            order = result["order"]
            services.record_transactions(
                *[fetched[tid] for tid in order]
            )
        return sorted(fetched, key=lambda h: h.bytes)

    def _verify_and_note(self, fetched, resolve_external):
        from ..parallel import verify_transaction_dag

        # only plain ids leave this call: it runs inside ``record``, and a
        # park unwinds through it, so no device buffer or scheduler future
        # may outlive it
        result = verify_transaction_dag(
            fetched,
            resolve_external=resolve_external,
            use_device=self.use_device,
            device=getattr(self.services, "device", None),
            tier=getattr(self.services, "tier", None),
        )
        return {"order": result.order}

    def _fetch_attachments(self, fetched: dict) -> None:
        services = self.services

        def compute_needed():
            needed = set()
            for stx in list(fetched.values()) + [self.stx]:
                for h in stx.tx.attachments:
                    if not services.attachments.has_attachment(h):
                        needed.add(h)
            # contract-code pseudo-attachments are registry hashes, not
            # stored blobs — never fetch those (covers input-contract
            # hashes that TransactionBuilder auto-attached, which outputs
            # alone would miss)
            from ..ledger.states import (
                registered_contract_code_hashes,
            )

            needed -= registered_contract_code_hashes()
            return sorted(needed, key=lambda h: h.bytes)

        # recorded for the same reason as the tx frontier: the attachment
        # store mutates between a park and its replay, and this gate
        # decides whether the fetch ops below run at all
        hashes = self.record(compute_needed)
        if not hashes:
            return
        blobs = self.session.send_and_receive(
            list, FetchRequest("attachment", tuple(hashes))
        ).unwrap(lambda xs: xs)
        if len(blobs) != len(hashes):
            raise FlowException("wrong number of attachments returned")
        for want, blob in zip(hashes, blobs):
            got = self.record(
                lambda blob=blob: services.attachments.import_or_get(blob)
            )
            if got != want:
                raise FlowException(f"peer sent wrong attachment for {want}")


class ReceiveTransactionFlow(FlowLogic):
    """Receive a SignedTransaction, resolve + verify its back-chain, verify
    it, optionally record it (reference: ReceiveTransactionFlow.kt:32)."""

    def __init__(self, session: FlowSession,
                 check_sufficient_signatures: bool = True,
                 allowed_missing_keys: set | None = None,
                 check_signatures: bool = True,
                 check_contracts: bool = True,
                 record: bool = False):
        self.session = session
        self.check_sufficient_signatures = check_sufficient_signatures
        self.allowed_missing_keys = allowed_missing_keys or set()
        # check_signatures/check_contracts=False skip verification of the
        # *top-level* transaction only (the back-chain always verifies in
        # ResolveTransactionsFlow) — for callers that re-verify anyway,
        # e.g. the notary service, to keep the hot path single-pass
        self.check_signatures = check_signatures
        self.check_contracts = check_contracts
        self.record_it = record

    def call(self) -> SignedTransaction:
        stx = self.session.receive(SignedTransaction).unwrap(lambda s: s)
        self.sub_flow(ResolveTransactionsFlow(stx, self.session))
        if self.check_signatures:
            allowed = set(self.allowed_missing_keys)
            if not self.check_sufficient_signatures:
                # still demand every *present* signature verifies;
                # completeness is relaxed by the caller's allowed set + notary
                if stx.notary is not None:
                    allowed.add(stx.notary.owning_key)
            _verify_sigs(self, stx, allowed)
        if self.check_contracts:
            ltx = self.services.resolve_to_ledger_transaction(stx)
            ltx.verify()
        if self.record_it:
            self.services.record_transactions(stx)
        return stx


# --------------------------------------------------------------- notary

class NotaryFlowClient(FlowLogic):
    """Request notarisation of ``stx`` from its notary; returns the notary
    signature(s) (reference: NotaryFlow.Client, NotaryFlow.kt:35-92)."""

    def __init__(self, stx: SignedTransaction):
        self.stx = stx

    def flow_fields(self):
        return {"stx": self.stx}

    @classmethod
    def from_flow_fields(cls, fields):
        return cls(fields["stx"])

    def call(self) -> list:
        stx = self.stx
        notary = stx.notary
        if notary is None:
            raise NotaryException("transaction names no notary")
        _verify_sigs(self, stx, {notary.owning_key})
        # the point of no return: once the request may have reached the
        # notary, a deadline shed would abandon a possibly committed spend
        # before the vault records it, and its inputs would be selected
        # again and double-spend for ever. The deadline still sheds at the
        # notary's own doors; this flow runs to completion.
        self.commit_pin()
        session = self.initiate_flow(notary)
        if self.services.network_map_cache.is_validating_notary(notary):
            self.sub_flow(SendTransactionFlow(session, stx))
            sigs = session.receive(list).unwrap(lambda s: s)
        else:
            groups = {
                ComponentGroupType.INPUTS,
                ComponentGroupType.TIMEWINDOW,
                ComponentGroupType.NOTARY,
            }
            ftx = FilteredTransaction.build(stx.tx, lambda comp, group: group in groups)
            sigs = session.send_and_receive(list, ftx).unwrap(lambda s: s)
        self._validate_response(sigs, notary, stx.id)
        return sigs

    @staticmethod
    def _validate_response(sigs: list, notary: Party, tx_id) -> None:
        if not sigs:
            raise NotaryException("notary returned no signatures")
        for sig in sigs:
            sig.verify(tx_id)
        if not is_fulfilled_by(notary.owning_key, {s.by for s in sigs}):
            raise NotaryException(
                "notary response signatures do not fulfil the notary key"
            )


@InitiatedBy(NotaryFlowClient)
class NotaryServiceFlow(FlowLogic):
    """Responder run by the notary node (reference: NotaryFlow.Service,
    NotaryFlow.kt:114-150). Dispatches on the node's notary service: a
    validating or batched service receives the whole transaction and its
    back-chain, a simple one a tear-off."""

    def __init__(self, session: FlowSession):
        self.session = session

    def call(self):
        from ..notary import (
            BatchedNotaryService,
            NotaryError,
            SimpleNotaryService,
            ValidatingNotaryService,
        )

        service = self.services.notary_service
        if service is None:
            raise FlowException("this node does not run a notary service")
        caller = str(self.session.counterparty.name)
        try:
            if isinstance(service, SimpleNotaryService):
                ftx = self.session.receive(FilteredTransaction).unwrap(lambda f: f)
                self.commit_pin()  # process() commits synchronously
                sig = self.record(lambda: service.process(ftx, caller))
            elif isinstance(service, BatchedNotaryService):
                # the service verifies the signatures and contracts itself,
                # so the receive skips the top-level checks
                stx = self.sub_flow(ReceiveTransactionFlow(
                    self.session, check_signatures=False, check_contracts=False,
                ))
                # the flow's deadline sheds at the service's door, before
                # the request joins a window; once it has joined, the
                # window may commit it, so this responder waits it out and
                # answers rather than abandon a committed spend
                self.commit_pin()
                sig = self.record(lambda: service.request(
                    stx, self.services.load_state, caller
                ).result(timeout=60.0))
            elif isinstance(service, ValidatingNotaryService):
                stx = self.sub_flow(ReceiveTransactionFlow(
                    self.session, check_signatures=False, check_contracts=False,
                ))
                self.commit_pin()  # process() commits synchronously
                sig = self.record(lambda: service.process(
                    stx, self.services.load_state, caller
                ))
            else:
                raise FlowException(
                    f"unsupported notary service {type(service).__name__}"
                )
        except NotaryError as e:
            raise NotaryException(str(e)) from e
        self.session.send([sig])


# --------------------------------------------------------------- finality

class BroadcastTransactionFlow(FlowLogic):
    """Push a finalised transaction to one recipient (reference:
    BroadcastTransactionFlow.kt); the recipient resolves, verifies and
    records it."""

    def __init__(self, recipient: Party, stx: SignedTransaction):
        self.recipient = recipient
        self.stx = stx

    def flow_fields(self):
        return {"recipient": self.recipient, "stx": self.stx}

    @classmethod
    def from_flow_fields(cls, fields):
        return cls(fields["recipient"], fields["stx"])

    def call(self):
        session = self.initiate_flow(self.recipient)
        self.sub_flow(SendTransactionFlow(session, self.stx))
        # wait for the recipient's recorded-ack: when FinalityFlow returns,
        # every broadcast recipient has durably recorded the transaction
        # (stronger than the reference's fire-and-forget broadcast — the
        # deterministic-replay engine makes the ack free)
        ok = session.receive(bool).unwrap(lambda b: b)
        if not ok:
            raise FlowException("recipient failed to record the transaction")


@InitiatedBy(BroadcastTransactionFlow)
class ReceiveBroadcastFlow(FlowLogic):
    def __init__(self, session: FlowSession):
        self.session = session

    def call(self):
        stx = self.sub_flow(ReceiveTransactionFlow(
            self.session, check_sufficient_signatures=True, record=True
        ))
        self.session.send(True)
        return stx


class FinalityFlow(FlowLogic):
    """Verify, notarise, record, broadcast (reference:
    FinalityFlow.kt:28-62)."""

    def __init__(self, stx: SignedTransaction, extra_recipients=()):
        self.stx = stx
        self.extra_recipients = tuple(extra_recipients)

    def flow_fields(self):
        return {"stx": self.stx, "extra_recipients": list(self.extra_recipients)}

    @classmethod
    def from_flow_fields(cls, fields):
        return cls(fields["stx"], tuple(fields["extra_recipients"]))

    def call(self) -> SignedTransaction:
        stx = self.stx
        notary = stx.notary
        allowed = {notary.owning_key} if notary is not None else set()
        _verify_sigs(self, stx, allowed)
        ltx = self.services.resolve_to_ledger_transaction(stx)
        ltx.verify()

        notarised = stx
        if self._needs_notarisation(stx):
            sigs = self.sub_flow(NotaryFlowClient(stx))
            notarised = notarised.plus(sigs)
        self.record(lambda: self.services.record_transactions(notarised) or 0)

        for party in self._recipients(notarised):
            self.sub_flow(BroadcastTransactionFlow(party, notarised))
        return notarised

    @staticmethod
    def _needs_notarisation(stx: SignedTransaction) -> bool:
        # an issue with no inputs and no time window has no notary
        # obligation (reference: needsNotarySignature in FinalityFlow.kt)
        return stx.notary is not None and (
            bool(stx.inputs) or stx.tx.time_window is not None
        )

    def _recipients(self, stx: SignedTransaction) -> list[Party]:
        my_key = self.our_identity.owning_key if self.our_identity else None
        seen: set = set()
        out: list[Party] = []
        participants = []
        for ts in stx.tx.outputs:
            participants.extend(ts.data.participants)
        participants.extend(self.extra_recipients)
        for p in participants:
            party = p
            if not isinstance(p, Party):
                party = self.services.identity_service.well_known_party_from_anonymous(p)
                if party is None:
                    continue  # an unknown anonymous participant: not broadcastable
            if my_key is not None and party.owning_key == my_key:
                continue
            if party.owning_key in seen:
                continue
            seen.add(party.owning_key)
            out.append(party)
        return out


# --------------------------------------------------------- multi-signing

class CollectSignaturesFlow(FlowLogic):
    """Gather counterparty signatures over a partially-signed transaction
    (reference: CollectSignaturesFlow.kt). One SendTransactionFlow + reply
    per session; signatures are checked as they arrive."""

    def __init__(self, partially_signed: SignedTransaction, sessions):
        self.partially_signed = partially_signed
        self.sessions = list(sessions)

    def call(self) -> SignedTransaction:
        stx = self.partially_signed
        notary_key = stx.notary.owning_key if stx.notary else None
        required = stx.required_signing_keys
        for session in self.sessions:
            self.sub_flow(SendTransactionFlow(session, stx))
            sigs = session.receive(list).unwrap(lambda s: s)
            for sig in sigs:
                sig.verify(stx.id)
                if sig.by not in required and sig.by != notary_key:
                    raise FlowException(
                        "counterparty signed with a key the transaction "
                        "does not require"
                    )
            stx = stx.plus(sigs)
        allowed = {notary_key} if notary_key is not None else set()
        _verify_sigs(self, stx, allowed)
        return stx


class SignTransactionFlow(FlowLogic):
    """Abstract responder for CollectSignaturesFlow (reference:
    SignTransactionFlow in CollectSignaturesFlow.kt). Subclass and override
    ``check_transaction`` with app-level acceptance rules; raise
    FlowException to reject."""

    def __init__(self, session: FlowSession):
        self.session = session

    def check_transaction(self, stx: SignedTransaction) -> None:
        """App hook — validate business terms before signing."""

    def call(self) -> SignedTransaction:
        my_keys = self.services.key_management_service.keys
        stx = self.sub_flow(ReceiveTransactionFlow(
            self.session, check_sufficient_signatures=False,
            allowed_missing_keys=set(my_keys),
        ))
        self.check_transaction(stx)
        to_sign = stx.required_signing_keys & set(my_keys)
        if not to_sign:
            raise FlowException(
                "transaction does not require a signature from this node"
            )
        sigs = [
            self.record(lambda k=k: self.services.key_management_service.sign(
                stx.id, k
            ))
            for k in sorted(to_sign, key=lambda k: (k.scheme_id, k.encoded))
        ]
        self.session.send(sigs)
        return stx.plus(sigs)


# ----------------------------------------------- state replacement flows

class AbstractStateReplacementFlow:
    """Propose replacing a state with a modified copy, collect every
    participant's approval and signature, then finalise (reference:
    AbstractStateReplacementFlow.kt). The concrete forms are
    ``NotaryChangeFlow`` and ``ContractUpgradeFlow``."""

    class Instigator(FlowLogic):
        def __init__(self, state_and_ref: StateAndRef):
            self.state_and_ref = state_and_ref

        def flow_fields(self):
            return {"state_and_ref": self.state_and_ref}

        @classmethod
        def from_flow_fields(cls, fields):
            return cls(fields["state_and_ref"])

        def assemble_builder(self) -> TransactionBuilder:
            raise NotImplementedError

        def call(self) -> StateAndRef:
            builder = self.assemble_builder()
            stx = self.sign_builder(builder)
            my_key = self.our_identity.owning_key
            parties = []
            seen = set()
            for p in self.state_and_ref.state.data.participants:
                party = p if isinstance(p, Party) else (
                    self.services.identity_service.well_known_party_from_anonymous(p)
                )
                if party is None:
                    raise FlowException(
                        "cannot resolve a participant to a well-known party"
                    )
                if party.owning_key == my_key or party.owning_key in seen:
                    continue
                seen.add(party.owning_key)
                parties.append(party)
            sessions = [self.initiate_flow(p) for p in parties]
            stx = self.sub_flow(CollectSignaturesFlow(stx, sessions))
            final = self.sub_flow(FinalityFlow(stx))
            return StateAndRef(final.tx.outputs[0], StateRef(final.id, 0))

    class Acceptor(SignTransactionFlow):
        """Participants approve structurally valid replacements; the
        ledger's special-form checks (``LedgerTransaction``'s
        ``_verify_notary_change`` / ``_verify_contract_upgrade``) already
        ran inside ``ReceiveTransactionFlow``."""


class NotaryChangeFlow(AbstractStateReplacementFlow.Instigator):
    """Re-point a state at a new notary (reference: NotaryChangeFlow.kt)."""

    def __init__(self, state_and_ref: StateAndRef, new_notary: Party):
        super().__init__(state_and_ref)
        self.new_notary = new_notary

    def flow_fields(self):
        return {"state_and_ref": self.state_and_ref, "new_notary": self.new_notary}

    @classmethod
    def from_flow_fields(cls, fields):
        return cls(fields["state_and_ref"], fields["new_notary"])

    def assemble_builder(self) -> TransactionBuilder:
        ts = self.state_and_ref.state
        signers = [p.owning_key for p in ts.data.participants]
        b = TransactionBuilder(notary=ts.notary)
        b.add_input_state(self.state_and_ref)
        b.add_output_state(ts.data, ts.contract, notary=self.new_notary,
                           encumbrance=ts.encumbrance, constraint=ts.constraint)
        b.add_command(NotaryChangeCommand(self.new_notary), *signers)
        return b


@InitiatedBy(NotaryChangeFlow)
class NotaryChangeAcceptor(AbstractStateReplacementFlow.Acceptor):
    def check_transaction(self, stx: SignedTransaction) -> None:
        ltx = self.services.resolve_to_ledger_transaction(stx)
        if not ltx.commands_of_type(NotaryChangeCommand):
            raise FlowException("expected a notary-change transaction")


class ContractUpgradeFlow(AbstractStateReplacementFlow.Instigator):
    """Upgrade a state to a new contract version (reference:
    ContractUpgradeFlow.kt). ``new_contract`` is the registered name of a
    contract class that declares ``legacy_contract`` and
    ``upgrade(state)``."""

    def __init__(self, state_and_ref: StateAndRef, new_contract: str):
        super().__init__(state_and_ref)
        self.new_contract = new_contract

    def flow_fields(self):
        return {"state_and_ref": self.state_and_ref, "new_contract": self.new_contract}

    @classmethod
    def from_flow_fields(cls, fields):
        return cls(fields["state_and_ref"], fields["new_contract"])

    def assemble_builder(self) -> TransactionBuilder:
        ts = self.state_and_ref.state
        upgraded = resolve_contract(self.new_contract).upgrade(ts.data)
        signers = [p.owning_key for p in ts.data.participants]
        b = TransactionBuilder(notary=ts.notary)
        b.add_input_state(self.state_and_ref)
        b.add_output_state(upgraded, self.new_contract,
                           encumbrance=ts.encumbrance, constraint=ts.constraint)
        b.add_command(UpgradeCommand(self.new_contract), *signers)
        return b


@InitiatedBy(ContractUpgradeFlow)
class ContractUpgradeAcceptor(AbstractStateReplacementFlow.Acceptor):
    def check_transaction(self, stx: SignedTransaction) -> None:
        ltx = self.services.resolve_to_ledger_transaction(stx)
        if not ltx.commands_of_type(UpgradeCommand):
            raise FlowException("expected a contract-upgrade transaction")
