"""Kernels C and D's function, batched SHA-256 and the Merkle pair hash:

- the plain PyTorch versions (the wrappers' CPU route) against hashlib and
  against the reference's ``sha256_batch``/``sha256_pair`` (JAX on the
  CPU), at every padding boundary;
- kernel C's ragged layout (``pack_messages``, the port's one padder)
  against the reference's ``pad_sha256``;
- the kernels' own arithmetic (csrc/sha256.cuh, compiled for the host
  through csrc/host_check.cpp) against hashlib.

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
