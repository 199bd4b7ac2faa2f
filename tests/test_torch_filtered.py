"""Filtered transactions (Merkle tear-offs): the port's
``ledger/filtered.py`` and ``crypto/merkle.py::PartialMerkleTree`` against
the reference's. For the same transaction (built in the port, carried
across as CBE bytes) and the same predicate, both packages build the same
``FilteredTransaction`` bytes, and ``verify``, ``components_of`` and
``check_all_components_visible`` give the same outcomes (error class and
message); so do tampered, hidden and malformed tear-offs built in the
port and read by both, and partial Merkle trees over the same leaves."""

import dataclasses

import pytest

import corda_tpu.finance  # noqa: F401  (registers the reference's Cash states)
from corda_tpu.crypto import PartialMerkleTree as RefPartialMerkleTree
from corda_tpu.crypto import merkle_root_host as ref_merkle_root_host
from corda_tpu.ledger import FilteredTransaction as RefFilteredTransaction
from corda_tpu.serialization import deserialize as ref_deserialize
from corda_tpu.serialization import serialize as ref_serialize
from corda_tpu_torch.crypto import (
    MerkleTree,
    MerkleTreeError,
    PartialMerkleTree,
    merkle_root_host,
    sha256,
)
from corda_tpu_torch.ledger import (
    ComponentGroupType,
    FilteredTransaction,
    FilteredTransactionVerificationException,
    TimeWindow,
)
from corda_tpu_torch.serialization import deserialize, serialize
from corda_tpu_torch.testing.service_stream import service_stream

G = ComponentGroupType
PREDICATES = {
    "everything": lambda c, g: True,
    "inputs_and_time_window": lambda c, g: g in (G.INPUTS, G.TIMEWINDOW, G.NOTARY),
    "commands_only": lambda c, g: g == G.COMMANDS,
    "even_outputs": lambda c, g: g == G.OUTPUTS and type(c).__name__ == "TransactionState"
    and c.data.amount.quantity % 2 == 0,
    "attachments_and_signers": lambda c, g: g in (G.ATTACHMENTS, G.SIGNERS),
    "nothing": lambda c, g: False,
}


@pytest.fixture(scope="module")
def wtxs():
    """A dozen wire transactions of the verifier service's stream (plain,
    composite-owned and attached-contract moves), one of them given a time
    window and a second output."""
    st = service_stream(24, seed=11, device="cpu", sphincs=0, bls=1, attachments=2)
    out = [stx.tx for stx in st.stxs[:12]]
    w = out[0]
    first = w.outputs[0]
    more = first.data.amount.quantity + 1
    second = dataclasses.replace(first, data=dataclasses.replace(
        first.data, amount=dataclasses.replace(first.data.amount, quantity=more)))
    out[0] = dataclasses.replace(w, outputs=(first, second),
                                 time_window=TimeWindow(until_time=2_000_000_000_000_000))
    return out


def carried(obj):
    return ref_deserialize(serialize(obj))


def outcome(fn):
    try:
        out = fn()
    except Exception as e:
        return (type(e).__name__, str(e))
    return ("ok", None if out is None else serialize(out) if not isinstance(out, list)
            else [serialize(x) for x in out])


def ref_outcome(fn):
    try:
        out = fn()
    except Exception as e:
        return (type(e).__name__, str(e))
    return ("ok", None if out is None else ref_serialize(out) if not isinstance(out, list)
            else [ref_serialize(x) for x in out])


@pytest.mark.parametrize("name", PREDICATES)
def test_build_verify_and_visibility_match_reference(wtxs, name):
    pred = PREDICATES[name]
    for wtx in wtxs:
        ftx = FilteredTransaction.build(wtx, pred)
        ref_ftx = RefFilteredTransaction.build(carried(wtx), pred)
        assert serialize(ftx) == ref_serialize(ref_ftx)
        assert ftx.id == wtx.id
        assert outcome(ftx.verify) == ref_outcome(ref_ftx.verify) == ("ok", None)
        for g in G:
            assert outcome(lambda: ftx.components_of(g)) == \
                ref_outcome(lambda: ref_ftx.components_of(g))
            assert outcome(lambda: ftx.check_all_components_visible(g)) == \
                ref_outcome(lambda: ref_ftx.check_all_components_visible(int(g)))


def tampered(ftx, kind):
    """A tear-off broken one way, built in the port."""
    groups = list(ftx.filtered_groups)
    fg = groups[0]
    comps = list(fg.components)
    if kind == "component_bytes":
        c = comps[0]
        comps[0] = dataclasses.replace(c, opaque_bytes=c.opaque_bytes[:-1]
                                       + bytes([c.opaque_bytes[-1] ^ 1]))
        groups[0] = dataclasses.replace(fg, components=tuple(comps))
    elif kind == "component_index":
        comps[0] = dataclasses.replace(comps[0], index=comps[0].index + 1)
        groups[0] = dataclasses.replace(fg, components=tuple(comps))
    elif kind == "nonce":
        comps[0] = dataclasses.replace(comps[0], nonce=sha256(b"other nonce"))
        groups[0] = dataclasses.replace(fg, components=tuple(comps))
    elif kind == "group_root":
        roots = list(ftx.group_roots)
        roots[fg.group] = sha256(b"forged root")
        return dataclasses.replace(ftx, group_roots=tuple(roots))
    elif kind == "missing_root":
        return dataclasses.replace(ftx, group_roots=ftx.group_roots[:-1])
    elif kind == "duplicate_group":
        groups.append(fg)
    elif kind == "bad_ordinal":
        groups[0] = dataclasses.replace(fg, group=9)
    elif kind == "reveals_nothing":
        groups[0] = dataclasses.replace(fg, components=())
    elif kind == "wrong_group":
        comps[0] = dataclasses.replace(comps[0], group=fg.group + 1)
        groups[0] = dataclasses.replace(fg, components=tuple(comps))
    elif kind == "extra_proof_leaf":
        pt = fg.partial_tree
        groups[0] = dataclasses.replace(fg, partial_tree=dataclasses.replace(
            pt, included=pt.included + ((pt.leaf_count - 1, sha256(b"x")),)))
    return dataclasses.replace(ftx, filtered_groups=tuple(groups))


TAMPER_KINDS = ["component_bytes", "component_index", "nonce", "group_root", "missing_root",
                "duplicate_group", "bad_ordinal", "reveals_nothing", "wrong_group",
                "extra_proof_leaf"]


@pytest.mark.parametrize("kind", TAMPER_KINDS)
def test_tampered_tear_offs_fail_as_in_reference(wtxs, kind):
    ftx = tampered(FilteredTransaction.build(wtxs[0], PREDICATES["everything"]), kind)
    ref_ftx = carried(ftx)
    got = outcome(ftx.verify)
    assert got == ref_outcome(ref_ftx.verify)
    assert got[0] == "FilteredTransactionVerificationException", got


def test_hidden_components_fail_visibility_as_in_reference(wtxs):
    """A group revealed in part, and a group not revealed at all: verify
    passes, the visibility check raises, in both packages."""
    wtx = wtxs[0]
    partial = FilteredTransaction.build(wtx, PREDICATES["even_outputs"])
    hidden = FilteredTransaction.build(wtx, PREDICATES["commands_only"])
    for ftx, group, what in ((partial, G.OUTPUTS, "partially visible"),
                             (hidden, G.INPUTS, "hidden")):
        ref_ftx = carried(ftx)
        assert outcome(ftx.verify) == ref_outcome(ref_ftx.verify) == ("ok", None)
        got = outcome(lambda: ftx.check_all_components_visible(group))
        assert got == ref_outcome(lambda: ref_ftx.check_all_components_visible(int(group)))
        assert got[0] == "FilteredTransactionVerificationException" and what in got[1]
    with pytest.raises(FilteredTransactionVerificationException):
        hidden.check_all_components_visible(G.INPUTS)


def test_tear_off_round_trips_through_both_packages(wtxs):
    ftx = FilteredTransaction.build(wtxs[1], PREDICATES["inputs_and_time_window"])
    back = deserialize(ref_serialize(carried(ftx)))
    assert back == ftx
    back.verify()


@pytest.mark.parametrize("n,include", [(1, [0]), (2, [1]), (5, [0, 4]), (8, [3, 4, 5]),
                                       (13, list(range(13))), (16, [15])],
                         ids=["one", "two", "five", "eight", "all", "last"])
def test_partial_merkle_trees_match_reference(n, include):
    leaves = [sha256(b"leaf %d" % i) for i in range(n)]
    ref_leaves = [carried(h) for h in leaves]
    tree = MerkleTree.build(leaves)
    pmt = PartialMerkleTree.build(tree, include)
    ref_pmt = RefPartialMerkleTree.build(_ref_tree(ref_leaves), include)
    assert serialize(pmt) == ref_serialize(ref_pmt)
    assert pmt.compute_root() == tree.root == merkle_root_host(leaves)
    assert ref_merkle_root_host(ref_leaves).bytes == tree.root.bytes
    assert pmt.verify(tree.root)


def _ref_tree(ref_leaves):
    from corda_tpu.crypto import MerkleTree as RefMerkleTree

    return RefMerkleTree.build(ref_leaves)


@pytest.mark.parametrize("kind", ["duplicate_index", "out_of_range", "unused_branch",
                                  "exhausted", "not_pow2", "no_leaves", "bad_hash_type"])
def test_malformed_partial_trees_fail_as_in_reference(kind):
    leaves = [sha256(b"leaf %d" % i) for i in range(8)]
    tree = MerkleTree.build(leaves)
    pmt = PartialMerkleTree.build(tree, [2, 5])
    bad = {
        "duplicate_index": lambda: dataclasses.replace(
            pmt, included=pmt.included + ((2, leaves[3]),)),
        "out_of_range": lambda: dataclasses.replace(
            pmt, included=((9, leaves[0]),) + pmt.included[1:]),
        "unused_branch": lambda: dataclasses.replace(
            pmt, branch_hashes=pmt.branch_hashes + (leaves[0],)),
        "exhausted": lambda: dataclasses.replace(pmt, branch_hashes=pmt.branch_hashes[:-1]),
        "not_pow2": lambda: dataclasses.replace(pmt, leaf_count=6),
        "no_leaves": lambda: dataclasses.replace(pmt, included=()),
        "bad_hash_type": lambda: dataclasses.replace(pmt, branch_hashes=(b"x",)),
    }[kind]()
    if kind == "bad_hash_type":  # not encodable: compare in memory
        from corda_tpu.crypto import MerkleTreeError as RefMerkleTreeError

        ref_bad = RefPartialMerkleTree(8, tuple((i, carried(h)) for i, h in pmt.included),
                                       (b"x",))
        with pytest.raises(MerkleTreeError):
            bad.compute_root()
        with pytest.raises(RefMerkleTreeError):
            ref_bad.compute_root()
        return
    ref_bad = carried(bad)
    got = outcome(bad.compute_root)
    want = ref_outcome(ref_bad.compute_root)
    assert got[0] == want[0] == "MerkleTreeError" and got == want
    assert bad.verify(tree.root) is ref_bad.verify(carried(tree.root)) is False
    with pytest.raises(MerkleTreeError):
        PartialMerkleTree.build(tree, [])
    with pytest.raises(MerkleTreeError):
        PartialMerkleTree.build(tree, [8])
