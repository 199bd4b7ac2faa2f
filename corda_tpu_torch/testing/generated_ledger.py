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
not depend on where).

``GeneratedLedger.stream`` yields the same transactions without keeping
them and with a capped unspent frontier, and ``stream_commit_requests``
yields unsigned notary commit requests (``GenCommitRequest``) for a ledger
of any size, some flagged as deliberate double spends: the bounded-memory
drivers of the reference's scale runs, request for request the
reference's for one seed.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import random

from ..crypto import (
    CURRENT_PLATFORM_VERSION,
    SecureHash,
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
    ``device="cpu"``). ``entropy``: a ``random.Random`` for the keys and
    privacy salts; given one, ``seed`` draws the DAG's shape alone, in the
    reference's order (whose keys and salts are not seeded), so both
    packages build DAGs of one shape."""

    def __init__(self, seed: int = 0, n_parties: int = 3,
                 notary: Party | None = None, notary_keypair=None, device=None,
                 entropy: random.Random | None = None):
        self.device = device
        self.rng = random.Random(seed)
        self._entropy = entropy or self.rng
        self.keypairs = {}
        self.parties = []
        for i in range(n_parties):
            kp = derive_keypair_from_entropy(4, self._entropy.randbytes(32))
            p = Party(CordaX500Name(f"Gen Party {i}", "City", "GB"), kp.public)
            self.keypairs[p.owning_key] = kp
            self.parties.append(p)
        if notary is None:
            nkp = derive_keypair_from_entropy(4, self._entropy.randbytes(32))
            notary = Party(CordaX500Name("Gen Notary", "City", "GB"), nkp.public)
            notary_keypair = nkp
        self.notary = notary
        self.notary_keypair = notary_keypair
        self.unspent: list[tuple[StateAndRef, Party]] = []
        self.transactions: dict = {}

    # ------------------------------------------------------------- steps
    def _builder(self) -> TransactionBuilder:
        b = TransactionBuilder(notary=self.notary)
        b.set_privacy_salt(PrivacySalt(self._entropy.randbytes(32)))
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

    def stream(self, n: int, issue_fraction: float = 0.3,
               with_notary_sig: bool = True, max_unspent: int = 4096):
        """Streamed driver: yields each fully signed transaction without
        keeping it, and caps the unspent frontier (the oldest entries are
        dropped: those states are never spent), so memory stays bounded
        whatever ``n``. Same seed, same stream."""
        for _ in range(n):
            if not self.unspent or self.rng.random() < issue_fraction:
                stx = self.issue()
            else:
                stx = self.move(with_notary_sig=with_notary_sig)
            self.transactions.pop(stx.id, None)
            if len(self.unspent) > max_unspent:
                del self.unspent[: len(self.unspent) - max_unspent]
            yield stx


@dataclasses.dataclass(frozen=True)
class GenCommitRequest:
    """One streamed uniqueness commit request, ``(refs, tx_id, caller)``,
    and whether the generator made it a double spend on purpose (so a scale
    run knows the verdict to expect without tracking state)."""

    refs: tuple
    tx_id: SecureHash
    caller: str
    expect_conflict: bool


def stream_commit_requests(
    seed: int,
    n_states: int,
    *,
    spend_fraction: float = 0.6,
    double_spend_fraction: float = 0.0,
    max_frontier: int = 8192,
    caller: str = "gen-loadtest",
):
    """Seeded stream of notary commit requests that builds a ledger of
    ``n_states`` outputs with no signing, no state blobs and a bounded
    unspent frontier: the shape of a conflict-check scale run (uniqueness
    providers check no signatures; the signed path is
    ``GeneratedLedger.stream``). Tx ids are ``sha256("gen:<seed>:<counter>")``:
    the same seed gives the same stream, bit for bit, as the reference's.
    ``double_spend_fraction`` spends an already consumed ref again under a
    fresh tx id, so the provider must report a conflict; such requests are
    flagged ``expect_conflict`` and consume nothing."""
    rng = random.Random(seed)
    frontier: collections.deque = collections.deque()
    spent_ring: collections.deque = collections.deque(maxlen=1024)
    produced = 0
    counter = 0
    while produced < n_states:
        counter += 1
        tx_id = SecureHash(hashlib.sha256(f"gen:{seed}:{counter}".encode()).digest())
        if (double_spend_fraction > 0 and spent_ring
                and rng.random() < double_spend_fraction):
            ref = spent_ring[rng.randrange(len(spent_ring))]
            yield GenCommitRequest((ref,), tx_id, caller, True)
            continue
        refs: list = []
        if frontier and rng.random() < spend_fraction:
            k = min(len(frontier), rng.randint(1, 3))
            for _ in range(k):
                refs.append(frontier.popleft())
        n_out = rng.randint(1, 3)
        yield GenCommitRequest(tuple(refs), tx_id, caller, False)
        spent_ring.extend(refs)
        for i in range(n_out):
            frontier.append(StateRef(tx_id, i))
            produced += 1
        while len(frontier) > max_frontier:
            # dropped states are never spent: the frontier (and so the
            # generator's memory) stays O(max_frontier)
            frontier.popleft()
