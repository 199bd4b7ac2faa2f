"""LedgerTransaction: a fully-resolved transaction ready for contract
verification (copy of corda_tpu/ledger/ledger_tx.py).

Capability parity with the reference's ``LedgerTransaction``
(core/.../transactions/LedgerTransaction.kt:30-128): inputs resolved to
their actual states, commands resolved to parties, and ``verify()`` =
constraint validation + running every referenced contract's ``verify``
against the whole transaction (groupStates helper included for fungible
per-(token, issuer) group verification as used by Cash-like contracts).

A contract resolves as in the reference: a registered contract wins,
then the transaction's own attachments are searched for restricted
contract source defining the name (``attachment_code.py``). Not ported:
the contracts of the reference's samples (``REFERENCE_CONTRACTS``). A
transaction naming one that no attachment supplies raises
``NotImplementedError`` naming ROADMAP.md Queue 1 item 13, out of
``verify`` and ``verify_ledger_batch`` alike, rather than being rejected:
the reference would run it. Any other contract found nowhere is rejected
with the reference's ``TransactionVerificationException``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from ..crypto import SecureHash
from ..serialization import register_custom

from .identity import Party
from .states import (
    Command,
    NotaryChangeCommand,
    StateAndRef,
    StateRef,
    TimeWindow,
    TransactionState,
    TransactionVerificationException,
    UpgradeCommand,
    contract_code_hash,
    resolve_contract,
)

# Contracts the reference registers (the modules of its samples) that the
# port has not ported yet: ROADMAP.md Queue 1 item 13.
REFERENCE_CONTRACTS = frozenset({
    "samples.DocumentContract", "samples.simm.OGTrade",
    "samples.simm.PortfolioSwap", "samples.InterestRateSwap",
})


@dataclasses.dataclass(frozen=True)
class LedgerTransaction:
    tx_id: SecureHash
    inputs: tuple       # tuple[StateAndRef, ...]
    outputs: tuple      # tuple[TransactionState, ...]
    commands: tuple     # tuple[Command, ...]
    attachments: tuple  # tuple[SecureHash, ...]
    notary: Party | None
    time_window: TimeWindow | None

    @property
    def id(self) -> SecureHash:
        return self.tx_id

    # ------------------------------------------------------------ accessors
    def input_states(self) -> list:
        return [sr.state.data for sr in self.inputs]

    def output_states(self) -> list:
        return [ts.data for ts in self.outputs]

    def out_ref(self, index: int) -> StateAndRef:
        return StateAndRef(self.outputs[index], StateRef(self.tx_id, index))

    def commands_of_type(self, cls) -> list[Command]:
        return [c for c in self.commands if isinstance(c.value, cls)]

    def inputs_of_type(self, cls) -> list:
        return [s for s in self.input_states() if isinstance(s, cls)]

    def outputs_of_type(self, cls) -> list:
        return [s for s in self.output_states() if isinstance(s, cls)]

    def group_states(self, cls, key_fn):
        """Group inputs+outputs of a type by a grouping key (reference:
        LedgerTransaction.groupStates — the fungible-asset verification
        pattern, e.g. Cash groups by (currency, issuer))."""
        groups: dict = defaultdict(lambda: ([], []))
        for s in self.inputs_of_type(cls):
            groups[key_fn(s)][0].append(s)
        for s in self.outputs_of_type(cls):
            groups[key_fn(s)][1].append(s)
        return [
            InOutGroup(tuple(ins), tuple(outs), key)
            for key, (ins, outs) in groups.items()
        ]

    # ------------------------------------------------------------ verify
    def referenced_contracts(self) -> list[str]:
        seen, out = set(), []
        for ts in [sr.state for sr in self.inputs] + list(self.outputs):
            if ts.contract not in seen:
                seen.add(ts.contract)
                out.append(ts.contract)
        return out

    def contract_code_for(self, name: str):
        """Resolve a contract to (class, code_hash).

        Locally REGISTERED contracts win (the node's audited code, hashed
        as the registry pseudo-attachment); otherwise the transaction's
        OWN attachments are searched for restricted-executable contract
        source defining the name (ledger/attachment_code.py — the
        reference's attachments-classloader capability,
        AttachmentsClassLoader.kt:24). The returned code hash is what the
        state's constraint is checked against, so HashAttachmentConstraint
        pins the exact code that runs. A contract of the reference's
        samples that no attachment supplies raises ``NotImplementedError``
        (ROADMAP.md Queue 1 item 13)."""
        try:
            return resolve_contract(name), contract_code_hash(name)
        except TransactionVerificationException:
            pass
        from .attachment_code import resolve_from_attachments

        hit = resolve_from_attachments(name, self.attachments)
        if hit is not None:
            return hit
        if name in REFERENCE_CONTRACTS:
            raise NotImplementedError(
                f"contract {name!r} is registered by the reference but not "
                "by the PyTorch package, and no transaction attachment "
                "carries it: ROADMAP.md Queue 1 item 13 (the samples)"
            )
        raise TransactionVerificationException(
            self.tx_id,
            f"unknown contract {name!r}: not registered and not carried "
            "by any transaction attachment",
        )

    def verify_constraints(self) -> None:
        """Every state's constraint must accept the contract code in scope
        (reference: LedgerTransaction.verifyConstraints, :92-106)."""
        for ts in [sr.state for sr in self.inputs] + list(self.outputs):
            _cls, code_hash = self.contract_code_for(ts.contract)
            if code_hash not in self.attachments:
                raise TransactionVerificationException(
                    self.tx_id,
                    f"missing attachment for contract {ts.contract}",
                )
            if not ts.constraint.is_satisfied_by(code_hash):
                raise TransactionVerificationException(
                    self.tx_id,
                    f"constraint {ts.constraint} rejected contract {ts.contract}",
                )

    def verify_contracts(self) -> None:
        """Instantiate and run each referenced contract (reference:
        LedgerTransaction.verifyContracts, :110-128)."""
        for name in self.referenced_contracts():
            contract = self.contract_code_for(name)[0]()
            try:
                contract.verify(self)
            except TransactionVerificationException:
                raise
            except Exception as e:
                raise TransactionVerificationException(
                    self.tx_id, f"contract {name} rejected: {e}"
                ) from e

    def check_no_notary_change(self) -> None:
        if self.notary is not None:
            for sr in self.inputs:
                if sr.state.notary != self.notary:
                    raise TransactionVerificationException(
                        self.tx_id,
                        "input states point to a different notary",
                    )

    def check_encumbrances(self) -> None:
        """Encumbered inputs must bring their encumbrance into the tx;
        output encumbrance indices must be valid (reference:
        TransactionVerificationException.TransactionMissingEncumbranceException)."""
        input_refs = {sr.ref for sr in self.inputs}
        for sr in self.inputs:
            enc = sr.state.encumbrance
            if enc is not None:
                needed = StateRef(sr.ref.txhash, enc)
                if needed not in input_refs:
                    raise TransactionVerificationException(
                        self.tx_id,
                        f"missing encumbrance input {needed}",
                    )
        for i, ts in enumerate(self.outputs):
            if ts.encumbrance is not None and not (
                0 <= ts.encumbrance < len(self.outputs) and ts.encumbrance != i
            ):
                raise TransactionVerificationException(
                    self.tx_id, f"output {i} has invalid encumbrance"
                )

    def verify(self) -> None:
        """Full semantic verification (reference: LedgerTransaction.verify,
        :77-128). Signature checking lives on SignedTransaction; this is the
        contract-semantics half the out-of-process verifier runs.

        Notary-change and contract-upgrade transactions are special forms
        (the reference models them as distinct wire-transaction types exempt
        from contract code); they verify structurally instead."""
        if self.commands_of_type(NotaryChangeCommand):
            self._verify_notary_change()
            return
        if self.commands_of_type(UpgradeCommand):
            self._verify_contract_upgrade()
            return
        self.check_no_notary_change()
        self.check_encumbrances()
        self.verify_constraints()
        self.verify_contracts()

    # ------------------------------------------------ special tx forms
    def _check_participants_are_signers(self, cmd: Command) -> None:
        """Every participant of every consumed state must be a required
        signer — without this anyone could re-point or upgrade someone
        else's state (the reference enforces it via the state-replacement
        tx's required signing keys)."""
        signers = set(cmd.signers)
        for sr in self.inputs:
            for p in sr.state.data.participants:
                key = getattr(p, "owning_key", p)
                if key not in signers:
                    raise TransactionVerificationException(
                        self.tx_id,
                        "state-replacement command is missing a participant "
                        "signer",
                    )

    def _verify_notary_change(self) -> None:
        """Inputs re-notarised verbatim: same data, same contract, new
        notary on every output (reference: NotaryChangeWireTransaction —
        exempt from contract verification by construction)."""
        cmds = self.commands_of_type(NotaryChangeCommand)
        if len(self.commands) != 1 or len(cmds) != 1:
            raise TransactionVerificationException(
                self.tx_id, "notary-change tx must carry exactly one command"
            )
        new_notary = cmds[0].value.new_notary
        self._check_participants_are_signers(cmds[0])
        if len(self.inputs) == 0 or len(self.inputs) != len(self.outputs):
            raise TransactionVerificationException(
                self.tx_id, "notary-change tx must map each input to one output"
            )
        for sr, out in zip(self.inputs, self.outputs):
            # everything except the notary must be preserved VERBATIM —
            # comparing only data would let the tx silently drop an
            # encumbrance or swap the attachment constraint
            if dataclasses.replace(sr.state, notary=new_notary) != out:
                raise TransactionVerificationException(
                    self.tx_id,
                    "notary-change tx altered more than the notary",
                )

    def _verify_contract_upgrade(self) -> None:
        """Each output must be exactly ``NewContract.upgrade(input)`` with
        ``NewContract.legacy_contract`` naming the old contract (reference:
        ContractUpgradeFlow.kt upgrade validation)."""
        cmds = self.commands_of_type(UpgradeCommand)
        if len(self.commands) != 1 or len(cmds) != 1:
            raise TransactionVerificationException(
                self.tx_id, "upgrade tx must carry exactly one command"
            )
        new_name = cmds[0].value.upgraded_contract
        self._check_participants_are_signers(cmds[0])
        new_cls = resolve_contract(new_name)
        legacy = getattr(new_cls, "legacy_contract", None)
        if legacy is None:
            raise TransactionVerificationException(
                self.tx_id,
                f"contract {new_name} does not declare legacy_contract",
            )
        if len(self.inputs) == 0 or len(self.inputs) != len(self.outputs):
            raise TransactionVerificationException(
                self.tx_id, "upgrade tx must map each input to one output"
            )
        for sr, out in zip(self.inputs, self.outputs):
            if sr.state.contract != legacy:
                raise TransactionVerificationException(
                    self.tx_id,
                    f"input contract {sr.state.contract} is not the declared "
                    f"legacy contract {legacy}",
                )
            if out.contract != new_name:
                raise TransactionVerificationException(
                    self.tx_id, "upgrade output not under the new contract"
                )
            expected = new_cls.upgrade(sr.state.data)
            if out.data != expected:
                raise TransactionVerificationException(
                    self.tx_id, "upgrade output is not upgrade(input)"
                )
            if out.notary != sr.state.notary:
                raise TransactionVerificationException(
                    self.tx_id, "upgrade tx must not change the notary"
                )
            # encumbrance and constraint carry over verbatim — an upgrade
            # must not be a loophole for shedding either
            if out.encumbrance != sr.state.encumbrance:
                raise TransactionVerificationException(
                    self.tx_id, "upgrade tx must not change the encumbrance"
                )
            if out.constraint != sr.state.constraint:
                raise TransactionVerificationException(
                    self.tx_id, "upgrade tx must not change the constraint"
                )


def verify_ledger_batch(ltxs: list[LedgerTransaction]) -> list:
    """Batched ``ltx.verify()`` over many transactions → one result slot
    per tx (None = valid, else the TransactionVerificationException).

    Structural checks (special forms, notary pinning, encumbrances,
    constraints) run per-tx — they are cheap dict/set work. Contract
    SEMANTICS dispatch once per contract class across the whole cohort:
    a contract exposing ``verify_batch(ltxs) -> list[Exception | None]``
    checks all its transactions in one fused pass (the vectorizable
    fungible fast path, SURVEY §7 hard part (f)); others fall back to
    per-tx ``verify``. This is the validating batched notary's host half —
    per-tx Python overhead is what bounds notarised-tx/sec once signatures
    are on device.
    """
    n = len(ltxs)
    results: list = [None] * n
    live: list[int] = []
    for i, ltx in enumerate(ltxs):
        try:
            if ltx.commands_of_type(NotaryChangeCommand):
                ltx._verify_notary_change()
                continue
            if ltx.commands_of_type(UpgradeCommand):
                ltx._verify_contract_upgrade()
                continue
            ltx.check_no_notary_change()
            ltx.check_encumbrances()
            ltx.verify_constraints()
            live.append(i)
        except TransactionVerificationException as e:
            results[i] = e
        except NotImplementedError:
            raise
        except Exception as e:
            results[i] = TransactionVerificationException(
                ltx.tx_id, f"structural check failed: {e}"
            )

    cohorts: dict[str, list[int]] = {}
    for i in live:
        for name in ltxs[i].referenced_contracts():
            cohorts.setdefault(name, []).append(i)

    for name, idxs in cohorts.items():
        idxs = [i for i in idxs if results[i] is None]
        if not idxs:
            continue
        try:
            contract = resolve_contract(name)()
        except TransactionVerificationException:
            # not registered: each tx resolves from its OWN attachments
            # (two txs may legitimately carry different code for one name)
            for i in idxs:
                try:
                    contract_i = ltxs[i].contract_code_for(name)[0]()
                    contract_i.verify(ltxs[i])
                except TransactionVerificationException as e:
                    results[i] = e
                except Exception as e:
                    results[i] = TransactionVerificationException(
                        ltxs[i].tx_id, f"contract {name} rejected: {e}"
                    )
            continue
        except Exception as e:
            for i in idxs:
                results[i] = TransactionVerificationException(
                    ltxs[i].tx_id, f"contract {name} failed to instantiate: {e}"
                )
            continue
        batch_fn = getattr(contract, "verify_batch", None)
        errs = None
        if batch_fn is not None:
            # trust boundary: a hook that raises or returns the wrong
            # number of slots must not fail (or worse, fail-OPEN for) the
            # other transactions — fall back to the per-tx verifier
            try:
                errs = batch_fn([ltxs[i] for i in idxs])
                if len(errs) != len(idxs):
                    errs = None
            except Exception:
                errs = None
        if errs is not None:
            for i, err in zip(idxs, errs):
                if err is not None and results[i] is None:
                    results[i] = (
                        err
                        if isinstance(err, TransactionVerificationException)
                        else TransactionVerificationException(
                            ltxs[i].tx_id, f"contract {name} rejected: {err}"
                        )
                    )
        else:
            for i in idxs:
                try:
                    contract.verify(ltxs[i])
                except TransactionVerificationException as e:
                    results[i] = e
                except Exception as e:
                    results[i] = TransactionVerificationException(
                        ltxs[i].tx_id, f"contract {name} rejected: {e}"
                    )
    return results


@dataclasses.dataclass(frozen=True)
class InOutGroup:
    inputs: tuple
    outputs: tuple
    grouping_key: object


register_custom(
    LedgerTransaction, "ledger.LedgerTransaction",
    to_fields=lambda t: {
        "tx_id": t.tx_id, "inputs": list(t.inputs), "outputs": list(t.outputs),
        "commands": list(t.commands), "attachments": list(t.attachments),
        "notary": t.notary if t.notary else 0,
        "time_window": t.time_window if t.time_window else 0,
    },
    from_fields=lambda d: LedgerTransaction(
        d["tx_id"], tuple(d["inputs"]), tuple(d["outputs"]),
        tuple(d["commands"]), tuple(d["attachments"]),
        d["notary"] if d["notary"] != 0 else None,
        d["time_window"] if d["time_window"] != 0 else None,
    ),
)
