"""Kernels C and D's function, batched SHA-256 and the Merkle pair hash:

- the plain PyTorch versions (the wrappers' CPU route) against hashlib and
  against the reference's ``sha256_batch``/``sha256_pair`` (JAX on the
  CPU), at every padding boundary;
- kernel C's ragged layout (``pack_messages``, the port's one padder)
  against the reference's ``pad_sha256``;
- the kernels' own arithmetic (csrc/sha256.cuh, compiled for the host
  through csrc/host_check.cpp) against hashlib, kernel C's producer and
  consumer formulas run in turn over its lane order (``hc_sha256_leaves``)
  against hashlib and the reference's ``sha256_batch_words``.

Every comparison is exact (tolerance zero: these are bytes)."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from corda_tpu.ops import sha256 as ref_sha
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import sha256 as port_sha

# the padding boundaries: 55 is the longest one-block message, 56 the
# shortest that needs a second block; 119/120 the same for two blocks
BOUNDARIES = [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 1100]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def messages(seed: int, lengths) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


def words(digests: list[bytes]) -> np.ndarray:
    return port_sha.bytes_to_digest_words(digests)


@pytest.mark.parametrize("length", BOUNDARIES)
def test_plain_sha256_matches_hashlib_and_reference(length):
    msgs = messages(length, [length] * 3 + [0, 55, 56])
    got = port_sha.sha256_batch(msgs, device="cpu")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == ref_sha.sha256_batch(msgs)


def test_plain_sha256_ragged_batch_matches_reference():
    msgs = messages(7, BOUNDARIES + [3, 300, 700])
    word_out = port_sha.sha256_batch_words(msgs, device="cpu")
    assert word_out.dtype == torch.int32 and word_out.shape == (len(msgs), 8)
    ref = np.asarray(ref_sha.sha256_batch_words(msgs))
    np.testing.assert_array_equal(word_out.numpy().view(np.uint32), ref)


def test_ragged_layout_matches_reference_padding():
    msgs = messages(11, BOUNDARIES)
    buf, offsets, counts = port_sha.pack_messages(msgs)
    blocks, ref_counts = ref_sha.pad_sha256(msgs)
    np.testing.assert_array_equal(counts, ref_counts)
    assert buf.size == 64 * int(counts.sum())
    for i, (o, c) in enumerate(zip(offsets, counts)):
        mine = buf[64 * o : 64 * (o + c)].reshape(c, 16, 4).astype(np.uint32)
        be = (mine[..., 0] << 24) | (mine[..., 1] << 16) | (mine[..., 2] << 8) | mine[..., 3]
        np.testing.assert_array_equal(be, blocks[i, :c])


def test_plain_pair_matches_hashlib_and_reference():
    left = [hashlib.sha256(b"L%d" % i).digest() for i in range(8)]
    right = [hashlib.sha256(b"R%d" % i).digest() for i in range(8)]
    lw = torch.from_numpy(words(left).view(np.int32))
    rw = torch.from_numpy(words(right).view(np.int32))
    got = port_sha.sha256_pair(lw, rw)
    assert port_sha.digest_words_to_bytes(got.numpy()) == [
        hashlib.sha256(a + b).digest() for a, b in zip(left, right)]
    ref = np.asarray(ref_sha.sha256_pair(words(left), words(right)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_pair_level_reads_the_pool_by_index():
    """One Merkle level in place: parents land in the rows after ``base``,
    each child read by its pool index (as txid's levels chain)."""
    digests = [hashlib.sha256(b"leaf %d" % i).digest() for i in range(6)]
    pool = torch.zeros((9, 8), dtype=torch.int32)
    pool[:6] = torch.from_numpy(words(digests).view(np.int32))
    left = torch.tensor([4, 0, 2], dtype=torch.int32)
    right = torch.tensor([5, 3, 2], dtype=torch.int32)
    port_sha.sha256_merkle_sweep(pool, [(6, left, right)])
    got = port_sha.digest_words_to_bytes(pool[6:].numpy())
    assert got == [hashlib.sha256(digests[a] + digests[b]).digest()
                   for a, b in ((4, 5), (0, 3), (2, 2))]
    assert port_sha.digest_words_to_bytes(pool[:6].numpy()) == digests


def tree_levels(n_leaves: int, base: int):
    """The levels of one Merkle tree over pool rows 0..n_leaves-1 (a power
    of two), parents from row ``base``: (first, left rows, right rows)."""
    row, levels = list(range(n_leaves)), []
    while len(row) > 1:
        m = len(row) // 2
        levels.append((base, row[0::2], row[1::2]))
        row = list(range(base, base + m))
        base += m
    return levels


def hashlib_root(digests: list[bytes]) -> bytes:
    while len(digests) > 1:
        digests = [hashlib.sha256(a + b).digest() for a, b in zip(digests[0::2], digests[1::2])]
    return digests[0]


@pytest.mark.parametrize("n_leaves", [2, 8, 64])
def test_sweep_chains_levels_into_the_root(n_leaves):
    """A whole tree in one sweep: each level reads the parents the level
    before it wrote, and the last row is hashlib's root."""
    digests = [hashlib.sha256(b"leaf %d" % i).digest() for i in range(n_leaves)]
    pool = torch.zeros((2 * n_leaves - 1, 8), dtype=torch.int32)
    pool[:n_leaves] = torch.from_numpy(words(digests).view(np.int32))
    levels = [(first, torch.tensor(left, dtype=torch.int32), torch.tensor(right, dtype=torch.int32))
              for first, left, right in tree_levels(n_leaves, n_leaves)]
    port_sha.sha256_merkle_sweep(pool, levels)
    assert port_sha.digest_words_to_bytes(pool[-1:].numpy())[0] == hashlib_root(digests)
    plain = torch.zeros_like(pool)
    plain[:n_leaves] = pool[:n_leaves]
    port_sha.sha256_sweep_plain(plain, levels)
    assert torch.equal(plain, pool)


def test_wrappers_reject_bad_inputs():
    buf, offs, cnts = (torch.from_numpy(a) for a in port_sha.pack_messages([b"abc"]))
    with pytest.raises(ValueError):
        port_sha.sha256_leaves(buf[:-1], offs, cnts)
    with pytest.raises(ValueError):
        port_sha.sha256_leaves(buf, offs.long(), cnts)
    pool = torch.zeros((4, 8), dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        port_sha.sha256_merkle_sweep(pool, [(3, idx, idx)])  # rows 3..4 outside
    with pytest.raises(ValueError):
        port_sha.sha256_merkle_sweep(pool.long(), [(2, idx, idx)])
    with pytest.raises(ValueError):
        port_sha.sha256_merkle_sweep(pool, [(2, idx, idx[:1])])
    with pytest.raises(ValueError):  # more levels than one launch takes
        port_sha.sha256_merkle_sweep(torch.zeros((200, 8), dtype=torch.int32),
                                     [(2 + 2 * k, idx, idx) for k in range(65)])


# ------------------------------------- the kernels' arithmetic on the host


@pytest.fixture(scope="module")
def hc():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    return _build.host_check()


def test_kernel_c_lane_matches_hashlib(hc):
    msgs = messages(3, BOUNDARIES + [200, 1000])
    buf, offsets, counts = port_sha.pack_messages(msgs)
    for m, o, c in zip(msgs, offsets, counts):
        out = np.zeros(8, np.uint32)
        blk = np.ascontiguousarray(buf[64 * o :])
        hc.hc_sha256_blocks(blk.ctypes.data, int(c), out.ctypes.data)
        assert port_sha.digest_words_to_bytes(out[None])[0] == hashlib.sha256(m).digest()


C_CHUNK = 128  # csrc/sha256.cuh's CT_C_CHUNK: the messages a block of kernel C orders at once


def kernel_grid(n: int, sms: int = 132) -> int:
    """Kernel C's blocks for n messages (csrc/sha256.cuh's ct_c_grid) on a
    card of ``sms`` SMs (an H100 has 132)."""
    return min(-(-n // 64), sms)


def lane_order(hc, counts, grid=None) -> np.ndarray:
    """Kernel C's lane order over ``grid`` blocks, on the host: (n,) int32,
    the chunks' orders end to end."""
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    grid = kernel_grid(len(counts)) if grid is None else grid
    order = np.full(len(counts), -1, np.int32)
    hc.hc_sha256_lane_order(counts.ctypes.data, len(counts), grid, order.ctypes.data)
    return order


def lane_order_plain(counts, grid: int) -> np.ndarray:
    """The lane order's plain version: each block's contiguous range of
    the messages, a chunk of C_CHUNK at a time, by block count, longest
    first, ties in message order (a stable argsort)."""
    n = len(counts)
    per = -(-n // grid) if n else 1
    out = [np.zeros(0, np.int64)]
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        for c0 in range(lo, hi, C_CHUNK):
            seg = np.asarray(counts[c0 : min(hi, c0 + C_CHUNK)], np.int64)
            out.append(c0 + np.argsort(-seg, kind="stable"))
    return np.concatenate(out).astype(np.int32)


def leaves(hc, msgs, order=None):
    """Kernel C's launch on the host: (n, 8) uint32 digests in message order."""
    buf, offsets, counts = port_sha.pack_messages(msgs)
    order = np.ascontiguousarray(lane_order(hc, counts) if order is None else order, np.int32)
    out = np.zeros((len(msgs), 8), np.uint32)
    hc.hc_sha256_leaves(buf.ctypes.data, offsets.ctypes.data, counts.ctypes.data,
                        order.ctypes.data, len(msgs), out.ctypes.data)
    return out


@pytest.mark.parametrize("lo", [0, 256, 512, 768])
def test_kernel_c_split_matches_hashlib_and_reference(hc, lo):
    """The producer's schedule chunks, then the consumer's rounds, over
    messages of every length lo..lo+255 (all of 0..1,000 across the cases,
    so every padding boundary), in kernel C's lane order."""
    msgs = messages(lo, range(lo, min(lo + 256, 1001)))
    got = leaves(hc, msgs)
    assert port_sha.digest_words_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
    np.testing.assert_array_equal(got, np.asarray(ref_sha.sha256_batch_words(msgs)))


def test_kernel_c_split_with_a_long_lane_in_every_warp(hc):
    """A window's shape: every sixth message 13 blocks long, so in message
    order each warp of 32 holds several long lanes. The lane order puts
    each chunk's long ones first and the digests still come back in
    message order."""
    lengths = [(800, 60, 100, 150, 200, 30)[i % 6] for i in range(320)]
    msgs = messages(13, lengths)
    buf, offsets, counts = port_sha.pack_messages(msgs)
    assert counts[0] == 13 and (counts[::6] == 13).all()
    order = lane_order(hc, counts)
    assert kernel_grid(len(msgs)) == 5  # five blocks of 64 messages, a chunk each
    for c0 in range(0, len(msgs), 64):
        chunk = counts[order[c0 : c0 + 64]]
        assert (chunk[: (chunk == 13).sum()] == 13).all() and (np.diff(chunk) <= 0).all()
    got = leaves(hc, msgs)
    assert port_sha.digest_words_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]


@pytest.mark.parametrize("case", ["ties", "one", "random", "reversed"])
def test_lane_order_returns_digests_in_message_order(hc, case):
    """Any permutation of the lanes gives the digests in message order:
    the lane order (ties kept in message order), a batch of one message,
    a random order and a reversed one."""
    lengths = {"ties": [70] * 40 + [5] * 30 + [200] * 3, "one": [130]}.get(
        case, [7 * i % 300 for i in range(70)])
    msgs = messages(17, lengths)
    counts = port_sha.pack_messages(msgs)[2]
    order = lane_order(hc, counts, grid=1)  # at most 128 messages: one chunk
    if case == "ties":
        np.testing.assert_array_equal(order, np.argsort(-counts, kind="stable"))
        assert list(order[:3]) == [70, 71, 72] and list(order[3:43]) == list(range(40))
    elif case == "random":
        order = np.random.default_rng(3).permutation(len(msgs)).astype(np.int32)
    elif case == "reversed":
        order = order[::-1].copy()
    got = leaves(hc, msgs, order)
    assert port_sha.digest_words_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]


LANE_COUNTS = {
    "five": [1, 12, 2, 12, 1],
    "one": [3],
    "none": [],
    "warp_and_one": [(7 * i) % 5 + 1 for i in range(33)],
    "window": [(13, 2, 3, 2, 4, 3)[i % 6] for i in range(12289)],
    "wide": list(np.random.default_rng(5).integers(1, 600, 5000)),
}


@pytest.mark.parametrize("case", sorted(LANE_COUNTS))
def test_lane_order_matches_plain_version(hc, case):
    """Kernel C's lane order (each block's range ordered a chunk at a time
    by ct_c_rank), run on the host, against its plain version over the
    launch's grid, one block and seven: a permutation, longest first
    within each chunk, ties in message order; a batch of five, of one, of
    none, one more than a warp, a notary window's shape, wide counts."""
    counts = np.asarray(LANE_COUNTS[case], np.int32)
    for grid in {kernel_grid(len(counts)), 1, 7}:
        order = lane_order(hc, counts, grid)
        np.testing.assert_array_equal(order, lane_order_plain(counts, grid))
        assert sorted(order.tolist()) == list(range(len(counts)))
    if case == "five":
        assert lane_order(hc, counts).tolist() == [1, 3, 2, 0, 4]
    if case == "window":  # 132 blocks of 94 messages, each a chunk
        per = -(-len(counts) // 132)
        for c0 in range(0, len(counts), per):
            chunk = counts[lane_order(hc, counts)[c0 : c0 + per]]
            assert (chunk[: (chunk == 13).sum()] == 13).all() and (np.diff(chunk) <= 0).all()


def test_kernel_d_lane_matches_hashlib(hc):
    for i in range(8):
        a = hashlib.sha256(b"a%d" % i).digest()
        b = hashlib.sha256(b"b%d" % i).digest()
        la, lb = words([a])[0].copy(), words([b])[0].copy()
        out = np.zeros(8, np.uint32)
        hc.hc_sha256_pair(la.ctypes.data, lb.ctypes.data, out.ctypes.data)
        assert port_sha.digest_words_to_bytes(out[None])[0] == hashlib.sha256(a + b).digest()


@pytest.mark.device
def test_kernels_c_and_d_match_plain_versions_on_the_card():
    """Kernels C and D against their plain versions on the card (skips
    without CUDA; ``python3 chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    msgs = messages(5, BOUNDARIES)
    buf, offs, cnts = (torch.from_numpy(a).cuda() for a in port_sha.pack_messages(msgs))
    got = port_sha.sha256_leaves(buf, offs, cnts)
    assert torch.equal(got.cpu(), port_sha.sha256_leaves_plain(buf, offs, cnts).cpu())
    pool = torch.cat([got, torch.zeros_like(got)])
    idx = torch.arange(len(msgs), dtype=torch.int32, device="cuda")
    port_sha.sha256_merkle_sweep(pool, [(len(msgs), idx, idx.flip(0).contiguous())])
    want = port_sha.sha256_pair_plain(pool, idx, idx.flip(0).contiguous())
    assert torch.equal(pool[len(msgs):].cpu(), want.cpu())


@pytest.mark.device
def test_kernel_c_long_lanes_match_plain_version_on_the_card():
    """Kernel C's warp pairs on a window's shape (a 13-block message every
    sixth) and on one warp of 13-block messages, each block ordering its
    own messages, against its plain version (skips without CUDA;
    ``python3 chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for lengths in ([(800, 60, 100, 150, 200, 30)[i % 6] for i in range(1000)], [800] * 32):
        msgs = messages(23, lengths)
        blocks, offsets, counts = port_sha.upload_messages(msgs, torch.device("cuda"))
        want = port_sha.sha256_leaves_plain(blocks, offsets, counts).cpu()
        assert torch.equal(port_sha.sha256_leaves(blocks, offsets, counts).cpu(), want)


@pytest.mark.device
def test_sweep_matches_plain_version_on_the_card():
    """Kernel D's one launch over a whole tree against its plain version
    (skips without CUDA; ``python3 chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_leaves = 1024
    digests = [hashlib.sha256(b"leaf %d" % i).digest() for i in range(n_leaves)]
    pool = torch.zeros((2 * n_leaves - 1, 8), dtype=torch.int32)
    pool[:n_leaves] = torch.from_numpy(words(digests).view(np.int32))
    levels = [(first, torch.tensor(left, dtype=torch.int32), torch.tensor(right, dtype=torch.int32))
              for first, left, right in tree_levels(n_leaves, n_leaves)]
    on_card = pool.cuda()
    port_sha.sha256_merkle_sweep(on_card, [(f, lt.cuda(), rt.cuda()) for f, lt, rt in levels])
    port_sha.sha256_sweep_plain(pool, levels)
    assert torch.equal(on_card.cpu(), pool)
    assert port_sha.digest_words_to_bytes(pool[-1:].numpy())[0] == hashlib_root(digests)
