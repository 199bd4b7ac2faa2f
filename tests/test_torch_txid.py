"""The Merkle-id sweep (kernels C and D's caller, corda_tpu_torch/ops/txid.py):
transactions built by the reference are carried across as CBE bytes; the
port's component bytes equal the reference's group by group, and the
port's ``compute_tx_ids(device="cpu")`` and ``dispatch_prime_ids`` equal
the reference's ``compute_tx_ids`` and ``stx.id``. Kernel D's plain sweep
(every level of a cohort's plan in turn) gives the reference's ids on a
cohort with a group of 1,100 components (a tree deeper than the top tree),
one with empty groups and a one-transaction cohort, and the level plan
writes every parent row once.

Every comparison is exact (tolerance zero: these are bytes)."""

import hashlib

import pytest
import torch

from corda_tpu.crypto import derive_keypair_from_entropy
from corda_tpu.finance import CashState
from corda_tpu.finance.contracts import CASH_PROGRAM_ID, Issue, Move
from corda_tpu.ledger import (
    Amount,
    CordaX500Name,
    Issued,
    Party,
    PartyAndReference,
    TimeWindow,
    TransactionBuilder,
)
from corda_tpu.ledger.wire import ComponentGroupType as RefGroup
from corda_tpu.ops.txid import compute_tx_ids as ref_compute_tx_ids
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu_torch import interop
from corda_tpu_torch.ledger import ComponentGroupType
from corda_tpu_torch.ops import txid as port_txid
from corda_tpu_torch.ops.sha256 import (
    digest_words_to_bytes,
    pack_messages,
    sha256_leaves_plain,
    sha256_sweep_plain,
)
from corda_tpu_torch.ops.txid import compute_tx_ids, dispatch_prime_ids, prime_ids


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _party(tag: bytes):
    kp = derive_keypair_from_entropy(4, hashlib.sha256(tag).digest())
    return Party(CordaX500Name(tag.decode(), "London", "GB"), kp.public), kp


@pytest.fixture(scope="module")
def reference_txs():
    """A Cash issue of 6 outputs, 6 moves of it (one with a time window,
    one with two commands), and an issue of 11 outputs (a 16-leaf tree)."""
    alice, akp = _party(b"Alice Corp")
    bob, _ = _party(b"Bob Inc")
    notary, _ = _party(b"Notary Service")
    token = Issued(PartyAndReference(alice, b"\x01"), "GBP")
    b = TransactionBuilder(notary=notary)
    for i in range(6):
        b.add_output_state(CashState(Amount(100 + i, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    issue = b.sign_initial_transaction(akp)
    out = [issue]
    for i in range(6):
        mb = TransactionBuilder(notary=notary)
        mb.add_input_state(issue.tx.out_ref(i))
        mb.add_output_state(CashState(Amount(100 + i, token), bob), CASH_PROGRAM_ID)
        mb.add_command(Move(), alice.owning_key)
        if i == 2:
            mb.set_time_window(TimeWindow(from_time=10**15, until_time=2 * 10**15))
        if i == 3:
            mb.add_command(Move(), bob.owning_key)
        out.append(mb.sign_initial_transaction(akp))
    b = TransactionBuilder(notary=notary)
    for i in range(11):
        b.add_output_state(CashState(Amount(7 * i + 1, token), bob), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    out.append(b.sign_initial_transaction(akp))
    return out


@pytest.fixture(scope="module")
def cohorts(reference_txs):
    """Reference cohorts by name: ``deep``, an issue of 1,100 outputs (an
    output group tree of 2,048 leaves, 11 levels) beside two moves;
    ``empty_groups``, the issue and three moves (no inputs, no time window
    but one, one command group of two); ``single``, one move alone."""
    alice, akp = _party(b"Alice Corp")
    notary, _ = _party(b"Notary Service")
    token = Issued(PartyAndReference(alice, b"\x01"), "GBP")
    b = TransactionBuilder(notary=notary)
    for i in range(1100):
        b.add_output_state(CashState(Amount(1 + i, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    deep = b.sign_initial_transaction(akp)
    return {"deep": [deep, reference_txs[1], reference_txs[3]],
            "empty_groups": reference_txs[:4],
            "single": [reference_txs[2]]}


def _plain_sweep_ids(wtxs) -> list[bytes]:
    """The port's sweep by hand on the CPU: kernel C's plain version over
    the leaves, then kernel D's plain sweep over the whole level plan."""
    leaf_msgs, levels, roots, rows = port_txid._plan(*port_txid._flatten(wtxs))
    pool = torch.zeros((rows, 8), dtype=torch.int32)
    buf, offs, cnts = (torch.from_numpy(a) for a in pack_messages(leaf_msgs))
    pool[: len(leaf_msgs)] = sha256_leaves_plain(buf, offs, cnts)
    sha256_sweep_plain(pool, port_txid.upload_levels(levels, torch.device("cpu")))
    return digest_words_to_bytes(pool[roots].numpy())


@pytest.mark.parametrize("name", ["deep", "empty_groups", "single"])
def test_plain_sweep_matches_reference_ids(cohorts, name):
    ref = cohorts[name]
    want = [i.bytes for i in ref_compute_tx_ids([s.tx for s in ref])]
    assert want == [s.id.bytes for s in ref]
    port = [interop.signed_transaction_from_reference(ref_serialize(s)) for s in ref]
    assert _plain_sweep_ids([s.tx for s in port]) == want
    assert [i.bytes for i in compute_tx_ids([s.tx for s in port], device="cpu")] == want


@pytest.mark.parametrize("name", ["deep", "empty_groups", "single"])
def test_level_plan_writes_every_parent_row_once(cohorts, name):
    """The plan's levels, in order, write consecutive rows from just past
    the zero row to the pool's end, each row once, and every level reads
    only rows below its first."""
    port = [interop.signed_transaction_from_reference(ref_serialize(s)) for s in cohorts[name]]
    leaf_msgs, levels, roots, rows = port_txid._plan(*port_txid._flatten([s.tx for s in port]))
    next_row = len(leaf_msgs) + 1  # the leaves, then the ZERO_HASH row
    for first, left, right in levels:
        assert first == next_row and len(left) == len(right) > 0
        assert max(left + right) < first
        next_row += len(left)
    assert next_row == rows
    assert len(roots) == len(port) and all(r == rows - len(port) + i for i, r in enumerate(roots))
    if name == "deep":  # the 2,048-leaf output tree, then the top tree
        assert len(levels) == 11 + 3


@pytest.fixture
def port_txs(reference_txs):
    """Fresh port copies (cold id caches) of the reference transactions."""
    return [interop.signed_transaction_from_reference(ref_serialize(s))
            for s in reference_txs]


def test_component_bytes_match_per_group(reference_txs, port_txs):
    for ref, port in zip(reference_txs, port_txs):
        for g in ComponentGroupType:
            assert port.tx.component_bytes(g) == ref.tx.component_bytes(RefGroup(int(g)))
        assert port.tx.privacy_salt.salt == ref.tx.privacy_salt.salt


def test_compute_tx_ids_match_reference(reference_txs, port_txs):
    want = [s.id.bytes for s in reference_txs]
    assert [i.bytes for i in compute_tx_ids([s.tx for s in port_txs], device="cpu")] == want
    assert [i.bytes for i in ref_compute_tx_ids([s.tx for s in reference_txs])] == want
    assert [s.id.bytes for s in port_txs] == want  # the host hashlib path


def test_dispatch_prime_ids_primes_cold_caches(reference_txs, port_txs):
    warm = port_txs[0]
    assert warm.id.bytes == reference_txs[0].id.bytes  # primes its cache on the host
    pending = dispatch_prime_ids(port_txs, device="cpu")
    for stx in port_txs[1:]:
        assert "_id" not in stx.tx.__dict__  # nothing primed before collect()
    pending.collect()
    for ref, port in zip(reference_txs, port_txs):
        assert port.tx.__dict__["_id"].bytes == ref.id.bytes
    prime_ids(port_txs, device="cpu")  # every cache warm: nothing to do
    assert dispatch_prime_ids(port_txs, device="cpu")._cold == []


def _composite_case(case: int):
    """A reference composite key (2-of-3, one child a 1-of-2 subtree) and
    a signer set: (encoded key, [(scheme, encoded) of signers])."""
    from corda_tpu.crypto.composite import CompositeKeyBuilder

    keys = [derive_keypair_from_entropy(4, hashlib.sha256(b"ck%d" % i).digest()).public
            for i in range(4)]
    inner = CompositeKeyBuilder().add(keys[2]).add(keys[3]).build(threshold=1)
    outer = CompositeKeyBuilder().add(keys[0]).add(keys[1]).add(inner).build(threshold=2)
    signers = [[], [keys[0]], [keys[0], keys[1]], [keys[0], keys[3]], [keys[2], keys[3]],
               [keys[1], keys[2], keys[3]]][case]
    return outer.to_public_key(), signers


@pytest.mark.parametrize("case", range(6))
def test_composite_key_fulfilment_matches_reference(case):
    """The notary's required-signer check on a composite key carried
    across from the reference: the port's ``is_fulfilled_by`` agrees."""
    from corda_tpu.crypto.composite import is_fulfilled_by as ref_fulfilled
    from corda_tpu_torch.crypto import PublicKey, is_fulfilled_by

    ref_key, ref_signers = _composite_case(case)
    port_key = PublicKey(ref_key.scheme_id, ref_key.encoded)
    port_signers = {PublicKey(k.scheme_id, k.encoded) for k in ref_signers}
    assert is_fulfilled_by(port_key, port_signers) == ref_fulfilled(ref_key, set(ref_signers))
    assert is_fulfilled_by(port_key, port_signers) == (case in (2, 3, 5))
