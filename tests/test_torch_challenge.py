"""Kernel A's function, h = SHA-512(R || A || M) mod L as 4-bit windows:

- the plain PyTorch version against the reference's ``sha512_blocks`` +
  ``challenge_windows`` (JAX on the CPU) and against hashlib, over the
  packing of ``test_packed_fixedlen_prep_differential``;
- the kernels' own arithmetic (csrc/*.cuh, compiled for the host through
  csrc/host_check.cpp) against the reference's field, decompression and
  challenge functions and against the verdicts of both verify paths;
  kernel A's launch (``hc_challenge_staged``: rows staged as one span of
  32-bit words, each row's words assembled from it, the schedule warp's
  chunks, then the rounds warp's) against the byte reads and the
  reference's windows.

Integer code: every comparison is exact (tolerance zero)."""

import ctypes
import hashlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_pallas13 as e13
from corda_tpu.ops.scalar25519 import challenge_windows, digest_words_to_limbs, mod_l
from corda_tpu.ops.sha512 import sha512_blocks
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import ed25519 as port_ed
from corda_tpu_torch.ops import scalar25519 as port_sc
from corda_tpu_torch.ops.ed25519_ladder import build_table, ed25519_verify_ladder
from corda_tpu_torch.ops.sha512 import block_words, sha512_block
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

L = 2**252 + 27742317777372353535851937790883648493
P = 2**255 - 19
B = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_field():
    """The reference's eager field multiply and square, each jitted as one
    XLA op (the same integer program): its exponent chains then run in a
    fraction of a second."""
    mp = pytest.MonkeyPatch()
    mp.setattr(e13, "fe_mul", jax.jit(e13.fe_mul))
    mp.setattr(e13, "fe_sq", jax.jit(e13.fe_sq))
    yield
    mp.undo()


def packed_plane(triples):
    """The fixed-length route's (B, 161) plane, packed by the port."""
    pks, sigs, msgs = map(list, zip(*triples))
    pk_arr, sig_arr, len_ok = port_ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, precheck = port_ed._canonical_precheck(pk_arr, sig_arr, len_ok)
    packed = np.zeros((len(pks), 161), np.uint8)
    port_ed.pack_rows(packed, sig_arr, pk_arr, s_arr, precheck, msgs)
    return packed


def reference_windows(packed):
    pj = jnp.asarray(packed)
    blk = pj[:, :128].astype(jnp.uint32)
    words = (blk[:, 0::4] << 24) | (blk[:, 1::4] << 16) | (blk[:, 2::4] << 8) | blk[:, 3::4]
    digest = sha512_blocks(words[:, None, :])
    return digest, np.asarray(challenge_windows(digest))


def hashlib_windows(triples):
    out = np.zeros((64, len(triples)), np.int32)
    for i, (pk, sig, msg) in enumerate(triples):
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
        out[:, i] = [(h >> (4 * k)) & 0xF for k in range(64)]
    return out


@pytest.mark.parametrize("msg_len", [0, 1, 44, 47])
def test_plain_challenge_matches_reference_and_hashlib(msg_len):
    triples = signed_triples(B, seed=21 + msg_len, msg_len=msg_len)
    packed = packed_plane(triples)
    digest, ref_win = reference_windows(packed)
    pt = torch.from_numpy(packed)
    port_digest = sha512_block(block_words(pt))
    np.testing.assert_array_equal(port_digest.numpy(), np.asarray(digest).astype(np.int64))
    limbs = port_sc.digest_words_to_limbs(port_digest)
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(digest_words_to_limbs(digest)))
    np.testing.assert_array_equal(
        port_sc.mod_l(limbs).numpy(), np.asarray(mod_l(digest_words_to_limbs(digest))))
    win = port_sc.ed25519_challenge(pt)  # the wrapper's CPU route
    assert win.dtype == torch.int32 and win.shape == (64, B)
    np.testing.assert_array_equal(win.numpy(), ref_win)
    np.testing.assert_array_equal(win.numpy(), hashlib_windows(triples))


def test_challenge_wrapper_rejects_bad_planes():
    with pytest.raises(ValueError):
        port_sc.ed25519_challenge(torch.zeros((4, 160), dtype=torch.uint8))
    with pytest.raises(ValueError):
        port_sc.ed25519_challenge(torch.zeros((4, 161), dtype=torch.int32))
    with pytest.raises(ValueError):
        port_sc.ed25519_challenge(torch.zeros((161, 4), dtype=torch.uint8).T)


# ------------------------------------- the kernels' arithmetic on the host


@pytest.fixture(scope="module")
def hc():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    return _build.host_check()


def _buf(b: bytes):
    return ctypes.create_string_buffer(b, len(b))


def _fe(lib, name, *xs):
    out = ctypes.create_string_buffer(32)
    getattr(lib, name)(*[_buf(x.to_bytes(32, "little")) for x in xs], out)
    return int.from_bytes(out.raw, "little")


def field_inputs():
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(B)]
    return xs + [0, 1, P - 1, P, P + 1, (1 << 255) - 1, 19, 2**254]


def test_kernel_field_matches_reference(hc):
    xs = field_inputs()
    ys = xs[1:] + xs[:1]
    n = len(xs)

    def ref(fn, *vals):
        cols = [jnp.asarray(np.stack([e13.int_to_limbs13(v % (1 << 260)) for v in col]).T)
                for col in vals]
        out = np.asarray(fn(*cols))
        return [e13.limbs13_to_int(out[:, i]) % P for i in range(n)]

    assert [_fe(hc, "hc_fe_mul", x, y) for x, y in zip(xs, ys)] == ref(e13.fe_mul, xs, ys)
    assert [_fe(hc, "hc_fe_sq", x) for x in xs] == ref(e13.fe_sq, xs)
    assert [_fe(hc, "hc_fe_inv", x) for x in xs] == ref(e13.fe_inv_chain, xs)
    assert [_fe(hc, "hc_fe_pow_p58", x) for x in xs] == [
        pow(x, (P - 5) // 8, P) for x in xs]


def test_kernel_decompress_matches_reference(hc):
    pks = [pk for pk, _s, _m in signed_triples(4, seed=7)]
    pks += [pk for kind, pk, _s, _m in adversarial_lanes(0)
            if kind in ("off_curve_a", "x0_sign1", "small_order_a_identity",
                        "small_order_a_order8")]
    table = build_table()
    arr = np.frombuffer(b"".join(pks), np.uint8).reshape(len(pks), 32)
    y = arr.copy()
    y[:, 31] &= 0x7F
    sign = (arr[:, 31] >> 7).astype(np.int32)
    b = len(pks)

    def cfull(row):
        return jnp.broadcast_to(jnp.asarray(e13._CONSTS_HOST[row, :20])[:, None], (20, b))

    env = e13.Env(k2=cfull(0), p_limbs=cfull(1), d=cfull(2), d2=cfull(3),
                  sqrt_m1=cfull(4), b_table=())
    (x, _y, _z, _t), ok = e13.decompress(
        env, e13.bytes_to_limb13_t(jnp.asarray(y))[:20], jnp.asarray(sign))
    x_can = np.asarray(e13.fe_canonical(env, x))
    for i, pk in enumerate(pks):
        out = ctypes.create_string_buffer(32)
        got_ok = hc.hc_decompress(_buf(pk), table.ctypes.data, out)
        assert bool(got_ok) == bool(np.asarray(ok)[i]), i
        if got_ok:
            assert int.from_bytes(out.raw, "little") == e13.limbs13_to_int(x_can[:, i])


def test_kernel_challenge_matches_reference(hc):
    for msg_len in (0, 44, 47):
        triples = signed_triples(B, seed=31 + msg_len, msg_len=msg_len)
        packed = packed_plane(triples)
        _digest, ref_win = reference_windows(packed)
        win = np.zeros(64, np.int32)
        for i in range(B):
            hc.hc_challenge(_buf(packed[i].tobytes()), win.ctypes.data)
            np.testing.assert_array_equal(win, ref_win[:, i])


def test_kernel_verify_matches_oracle_and_plain(hc):
    lanes = adversarial_lanes(0)
    triples = [(pk, sig, msg) for _k, pk, sig, msg in lanes] + signed_triples(3, seed=41)
    packed = packed_plane(triples)
    win = port_sc.challenge_windows_plain(torch.from_numpy(packed)).numpy()
    table = build_table()
    want = [ed25519_host.verify(*t) for t in triples]
    got = []
    for i in range(len(triples)):
        lane_win = np.ascontiguousarray(win[:, i])
        got.append(bool(hc.hc_verify(_buf(packed[i].tobytes()), lane_win.ctypes.data,
                                     table.ctypes.data, 8)))
    assert got == want
    plain = ed25519_verify_ladder(
        torch.from_numpy(packed), torch.from_numpy(win), torch.from_numpy(table))
    assert plain.tolist() == want


def staged_span(packed: np.ndarray, row0: int) -> np.ndarray:
    """One block's span of up to 64 rows as kernel A stages it: the rows'
    bytes end to end, read as little-endian 32-bit words."""
    span = np.zeros(64 * 161, np.uint8)
    rows = packed[row0 : row0 + 64].reshape(-1)
    span[: rows.size] = rows
    return span.view("<u4").copy()


@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_kernel_a_staged_words_match_byte_reads(hc, residue):
    """Row r of a span starts at byte 161 r, at byte r mod 4 of an aligned
    word: the sixteen rows of each residue (the block's last row, 63,
    among residue 3's) assembled from the span's words equal the
    big-endian words of their bytes."""
    packed = np.random.default_rng(residue).integers(0, 256, (64, 161), dtype=np.uint8)
    span = staged_span(packed, 0)
    for r in range(residue, 64, 4):
        w = np.zeros(16, np.uint64)
        hc.hc_sha512_row_words(span.ctypes.data, r, w.ctypes.data)
        want = packed[r, :128].copy().view(">u8").astype(np.uint64)
        np.testing.assert_array_equal(w, want, err_msg=f"row {r}")


@pytest.mark.parametrize("b", [1, 37, 64, 101])
def test_kernel_a_staged_launch_matches_reference(hc, b):
    """Kernel A's launch on the host at B = 1 (one row of a partial
    block), 37 (a full warp pair and five rows of the second), 64 (one
    full block) and 101 (a full block and a partial one, its last row row
    36 of the block), against the byte reads and the reference's
    windows."""
    triples = signed_triples(b, seed=50 + b, msg_len={1: 0, 37: 44, 64: 13, 101: 47}[b])
    packed = packed_plane(triples)
    _digest, ref_win = reference_windows(packed)
    win = np.zeros((64, b), np.int32)
    hc.hc_challenge_staged(packed.ctypes.data, b, win.ctypes.data)
    np.testing.assert_array_equal(win, ref_win)
    np.testing.assert_array_equal(win, hashlib_windows(triples))
    for i in range(b):
        lane = np.zeros(64, np.int32)
        hc.hc_challenge(_buf(packed[i].tobytes()), lane.ctypes.data)
        np.testing.assert_array_equal(lane, win[:, i])


@pytest.mark.device
def test_kernel_a_matches_plain_version_on_the_card():
    """Kernel A's staged rows and warp pairs against its plain version at
    B = 1, 32, 37, 101 and 512 (skips without CUDA; ``python3
    chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b in (1, 32, 37, 101, 512):
        packed = torch.from_numpy(
            np.random.default_rng(b).integers(0, 256, (b, 161), dtype=np.uint8)).cuda()
        assert torch.equal(port_sc.ed25519_challenge(packed).cpu(),
                           port_sc.challenge_windows_plain(packed.cpu()))
