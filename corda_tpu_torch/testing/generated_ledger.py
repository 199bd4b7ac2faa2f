"""Seeded generator of valid transaction DAGs (copy of
corda_tpu/testing/generated_ledger.py).

``GeneratedLedger`` makes issuances and value-conserving moves of a test
asset, every one fully signed, with fan-in (a move spends up to three
states), fan-out (up to three outputs), several signers and the notary:
the DAG shapes the wavefront verifier, the batched verifier and the
notaries are fuzzed with. ``GenAsset``, ``GenCommand`` and the
``testing.GenContract`` contract keep the reference's CBE names, so a DAG
carried across as bytes has the reference's ids.

Unlike the reference's, whose keys are random, the parties' and the
notary's keys and every privacy salt come from the seeded
``random.Random``: a seed fixes the whole DAG. Each transaction's
signatures are made in one ``ed25519_sign_batch`` on ``device`` (the card
unless ``device="cpu"``; ed25519 signing is deterministic, so the bytes do
not depend on where). The reference's streamed generator (``stream``) and its
commit-request stream are not copied (nothing in the port runs them).
"""

from __future__ import annotations

import dataclasses
import random

from ..crypto import (
    CURRENT_PLATFORM_VERSION,
    EDDSA_ED25519_SHA512,
    SignableData,
    SignatureMetadata,
    TransactionSignature,
    derive_keypair_from_entropy,
)
from ..ops.ed25519_sign import ed25519_sign_batch
from ..ledger import (
    CordaX500Name,
    Party,
    PrivacySalt,
    SignedTransaction,
    StateAndRef,
    StateRef,
    TransactionBuilder,
    register_contract,
)
from ..serialization import register_custom


@dataclasses.dataclass(frozen=True)
class GenAsset:
    value: int
    owner: Party

    @property
    def participants(self):
        return [self.owner]


@dataclasses.dataclass(frozen=True)
class GenCommand:
    op: str


register_custom(
    GenAsset, "testing.GenAsset",
    to_fields=lambda s: {"value": s.value, "owner": s.owner},
    from_fields=lambda d: GenAsset(d["value"], d["owner"]),
)
register_custom(
    GenCommand, "testing.GenCommand",
    to_fields=lambda c: {"op": c.op},
    from_fields=lambda d: GenCommand(d["op"]),
)

GEN_CONTRACT_ID = "testing.GenContract"


def sign_tx_ids(jobs, device=None) -> list:
    """A TransactionSignature over each (ed25519 KeyPair, tx id) job, all
    in one ``ed25519_sign_batch`` on ``device`` (the card unless
    ``device="cpu"``)."""
    meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, EDDSA_ED25519_SHA512)
    raw = ed25519_sign_batch([kp.private.encoded for kp, _tid in jobs],
                             [SignableData(tid, meta).to_bytes() for _kp, tid in jobs],
                             device=device)
    return [TransactionSignature(sig, kp.public, meta) for sig, (kp, _tid) in zip(raw, jobs)]


@register_contract(GEN_CONTRACT_ID)
class GenContract:
    def verify(self, tx):
        cmds = tx.commands_of_type(GenCommand)
        if not cmds:
            raise ValueError("no GenCommand")
        ins = sum(s.value for s in tx.inputs_of_type(GenAsset))
        outs = sum(s.value for s in tx.outputs_of_type(GenAsset))
        op = cmds[0].value.op
        if op == "issue":
            if tx.inputs:
                raise ValueError("issue must not consume")
        elif ins != outs:
            raise ValueError(f"value not conserved: {ins} -> {outs}")


class GeneratedLedger:
    """Seeded generator of valid transaction DAGs.

    ``generate(n)`` returns ``{tx_id: SignedTransaction}`` where every
    transaction is fully signed (the owners of its consumed states, and the
    notary on a move) and every input resolves inside the set: input for
    ``verify_transaction_dag``, the batched verifier or the notaries.
    ``device``: where the signatures are made (the card unless
    ``device="cpu"``)."""

    def __init__(self, seed: int = 0, n_parties: int = 3,
                 notary: Party | None = None, notary_keypair=None, device=None):
        self.device = device
        self.rng = random.Random(seed)
        self.keypairs = {}
        self.parties = []
        for i in range(n_parties):
            kp = derive_keypair_from_entropy(4, self.rng.randbytes(32))
            p = Party(CordaX500Name(f"Gen Party {i}", "City", "GB"), kp.public)
            self.keypairs[p.owning_key] = kp
            self.parties.append(p)
        if notary is None:
            nkp = derive_keypair_from_entropy(4, self.rng.randbytes(32))
            notary = Party(CordaX500Name("Gen Notary", "City", "GB"), nkp.public)
            notary_keypair = nkp
        self.notary = notary
        self.notary_keypair = notary_keypair
        self.unspent: list[tuple[StateAndRef, Party]] = []
        self.transactions: dict = {}

    # ------------------------------------------------------------- steps
    def _builder(self) -> TransactionBuilder:
        b = TransactionBuilder(notary=self.notary)
        b.set_privacy_salt(PrivacySalt(self.rng.randbytes(32)))
        return b

    def _sign(self, builder: TransactionBuilder, signer_keys,
              with_notary: bool) -> SignedTransaction:
        wtx = builder.to_wire_transaction()
        jobs = [(self.keypairs[k], wtx.id) for k in signer_keys]
        if with_notary and self.notary_keypair is not None:
            jobs.append((self.notary_keypair, wtx.id))
        return SignedTransaction.create(wtx, sign_tx_ids(jobs, self.device))

    def issue(self) -> SignedTransaction:
        owner = self.rng.choice(self.parties)
        value = self.rng.randint(1, 1000)
        b = self._builder()
        for v in self._split(value, self.rng.randint(1, 3)):
            b.add_output_state(GenAsset(v, owner), GEN_CONTRACT_ID)
        b.add_command(GenCommand("issue"), owner.owning_key)
        stx = self._sign(b, [owner.owning_key], with_notary=False)
        self._commit(stx, owner)
        return stx

    def move(self, with_notary_sig: bool = True) -> SignedTransaction:
        if not self.unspent:
            return self.issue()
        k = min(len(self.unspent), self.rng.randint(1, 3))
        picked_idx = self.rng.sample(range(len(self.unspent)), k)
        picked = [self.unspent[i] for i in picked_idx]
        for i in sorted(picked_idx, reverse=True):
            del self.unspent[i]
        new_owner = self.rng.choice(self.parties)
        total = sum(sar.state.data.value for sar, _ in picked)
        b = self._builder()
        signer_keys = []
        for sar, owner in picked:
            b.add_input_state(sar)
            if owner.owning_key not in signer_keys:
                signer_keys.append(owner.owning_key)
        for v in self._split(total, self.rng.randint(1, 3)):
            b.add_output_state(GenAsset(v, new_owner), GEN_CONTRACT_ID)
        b.add_command(GenCommand("move"), *signer_keys)
        stx = self._sign(b, signer_keys, with_notary=with_notary_sig)
        self._commit(stx, new_owner)
        return stx

    def _split(self, total: int, n: int) -> list[int]:
        n = max(1, min(n, total))
        cuts = sorted(self.rng.sample(range(1, total), n - 1)) if n > 1 else []
        parts = []
        prev = 0
        for c in cuts + [total]:
            parts.append(c - prev)
            prev = c
        return parts

    def _commit(self, stx: SignedTransaction, owner: Party) -> None:
        self.transactions[stx.id] = stx
        for i, ts in enumerate(stx.tx.outputs):
            self.unspent.append((StateAndRef(ts, StateRef(stx.id, i)), owner))

    # ---------------------------------------------------------- generate
    def generate(self, n: int, issue_fraction: float = 0.3,
                 with_notary_sig: bool = True) -> dict:
        """Generate n transactions; returns {tx_id: SignedTransaction}."""
        for _ in range(n):
            if not self.unspent or self.rng.random() < issue_fraction:
                self.issue()
            else:
                self.move(with_notary_sig=with_notary_sig)
        return dict(self.transactions)
