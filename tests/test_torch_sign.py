"""Kernel E's function, the fixed-base comb R = [r]B of batched signing:

- the comb table against the reference's ``_comb_consts()`` (every entry
  equal as an integer, carried across by ``interop``);
- the plain PyTorch version (the wrapper's CPU route) and the kernel's own
  arithmetic (csrc/ed25519_comb.cuh through csrc/host_check.cpp: four
  partial sums of 16 windows, one a quad, combined in the kernel's rounds)
  against the reference's ``_scalar_mul_host``, on 0, 1, L - 1, 2^252,
  2^256 - 1, 16^k * j for every window k, scalars whose digits all fall in
  one quad's windows, and random scalars below 2^256;
- ``ed25519_sign_batch(device="cpu")`` byte-equal to the reference's
  ``ed25519_sign_batch`` and to ``ed25519_host.sign``.

Every comparison is exact (tolerance zero: these are bytes)."""

import hashlib
import shutil

import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_sign as ref_sign
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import ed25519_sign as port_sign
from corda_tpu_torch.ops.ed25519_ladder import fe10_to_int

L = ed25519_host.L


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def encode(r: int) -> bytes:
    """The reference's encoding of [r]B."""
    x, y = ref_sign._scalar_mul_host(r) if r else (0, 1)
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def scalar_bytes(rs) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(
        b"".join(r.to_bytes(32, "little") for r in rs), np.uint8).reshape(len(rs), 32).copy())


def edge_scalars(seed: int, n: int) -> list[int]:
    """0, 1, L - 1, 2^252, a top-window scalar, then 16^k * j (the digit j
    alone in window k) for spread k and random j."""
    rng = np.random.default_rng(seed)
    out = [0, 1, L - 1, 2**252, 15 * 16**63]
    while len(out) < n:
        k = int(rng.integers(0, 64))
        out.append(int(rng.integers(1, 16)) * 16**k)
    return out


def test_comb_table_matches_reference_consts():
    ref = ref_sign._comb_consts()
    carried = interop.comb_table_from_reference(ref)
    table = port_sign.build_comb_table()
    np.testing.assert_array_equal(carried.numpy(), table)
    # entry by entry, as integers: the reference's 22 x 12-bit limbs
    for row in (0, 1, 2, 47, 48, 1535, 3071):
        k, rest = divmod(row, 48)
        limbs = ref[8 + 48 * k + rest, :22]
        assert fe10_to_int(table[row]) == sum(int(v) << (12 * i) for i, v in enumerate(limbs))


def test_scalar_windows_match_reference():
    rs = edge_scalars(1, 16)
    np.testing.assert_array_equal(
        port_sign.windows_of_bytes(scalar_bytes(rs)).numpy(),
        ref_sign._windows_of_scalars(rs, len(rs)))


def test_plain_comb_matches_reference_host_math():
    rs = edge_scalars(2, 16)
    got = port_sign.ed25519_comb(scalar_bytes(rs), port_sign.comb_table("cpu"))
    assert [bytes(row) for row in got.numpy()] == [encode(r) for r in rs]


def test_sign_batch_matches_reference_and_oracle():
    seeds = [hashlib.sha256(b"notary key %d" % (i % 3)).digest() for i in range(12)]
    rng = np.random.default_rng(3)
    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 120, 12)]
    got = port_sign.ed25519_sign_batch(seeds, msgs, device="cpu")
    assert got == ref_sign.ed25519_sign_batch(seeds, msgs)
    assert got == [ed25519_host.sign(s, m) for s, m in zip(seeds, msgs)]
    assert all(ed25519_host.verify(ed25519_host.public_from_seed(s), g, m)
               for s, g, m in zip(seeds, got, msgs))


def test_comb_wrapper_rejects_bad_inputs():
    table = port_sign.comb_table("cpu")
    with pytest.raises(ValueError):
        port_sign.ed25519_comb(torch.zeros((4, 31), dtype=torch.uint8), table)
    with pytest.raises(ValueError):
        port_sign.ed25519_comb(torch.zeros((4, 32), dtype=torch.int32), table)
    with pytest.raises(ValueError):
        port_sign.ed25519_comb(torch.zeros((4, 32), dtype=torch.uint8), table[:-1])


# ------------------------------------- the kernel's arithmetic on the host


@pytest.fixture(scope="module")
def hc():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    return _build.host_check()


def test_kernel_e_lane_matches_reference_host_math(hc):
    """Every window k with its largest digit, and random full scalars."""
    table = np.ascontiguousarray(port_sign.build_comb_table())
    rng = np.random.default_rng(4)
    rs = [0, 1, L - 1, 2**252, 2**256 - 1]
    rs += [15 * 16**k for k in range(64)]
    rs += [int.from_bytes(rng.bytes(32), "little") % L for _ in range(8)]
    for r in rs:
        out = np.zeros(32, np.uint8)
        rb = np.frombuffer(r.to_bytes(32, "little"), np.uint8).copy()
        hc.hc_comb(rb.ctypes.data, table.ctypes.data, out.ctypes.data)
        assert out.tobytes() == encode(r % L), r  # B has order L


def hc_encode(hc, table, r: int) -> bytes:
    out = np.zeros(32, np.uint8)
    rb = np.frombuffer(r.to_bytes(32, "little"), np.uint8).copy()
    hc.hc_comb(rb.ctypes.data, table.ctypes.data, out.ctypes.data)
    return out.tobytes()


def test_kernel_e_lane_every_digit_of_every_window(hc):
    """16^k * j for every window k, with j = 1 + k % 15 and j = 15."""
    table = np.ascontiguousarray(port_sign.build_comb_table())
    for k in range(64):
        for j in (1 + k % 15, 15):
            r = j * 16**k
            assert hc_encode(hc, table, r) == encode(r % L), (k, j)


@pytest.mark.parametrize("quad", range(4))
def test_kernel_e_lane_digits_of_one_quad(hc, quad):
    """Scalars whose nonzero digits all fall in windows 16q .. 16q + 15,
    the windows quad q of a signature sums: the other three partial sums
    stay the identity through the combine."""
    table = np.ascontiguousarray(port_sign.build_comb_table())
    rng = np.random.default_rng(10 + quad)
    rs = [(2**64 - 1) << (64 * quad), 1 << (64 * quad), 15 << (64 * quad + 60)]
    rs += [int(rng.integers(1, 2**63)) << (64 * quad) for _ in range(5)]
    for r in rs:
        assert hc_encode(hc, table, r) == encode(r % L), hex(r)


def test_kernel_e_lane_matches_reference_on_random_scalars(hc):
    """64 random scalars below 2^256 (not reduced mod L)."""
    table = np.ascontiguousarray(port_sign.build_comb_table())
    rng = np.random.default_rng(11)
    for _ in range(64):
        r = int.from_bytes(rng.bytes(32), "little")
        assert hc_encode(hc, table, r) == encode(r % L), hex(r)


@pytest.mark.device
def test_kernel_e_matches_plain_version_on_the_card():
    """Kernel E against its plain version on the card (skips without
    CUDA; ``python3 chip_smoke.py`` runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = scalar_bytes(edge_scalars(5, 16) + [(2**64 - 1) << (64 * q) for q in range(4)])
    got = port_sign.ed25519_comb(r.cuda(), port_sign.comb_table(torch.device("cuda", 0)))
    assert torch.equal(got.cpu(), port_sign.ed25519_comb(r, port_sign.comb_table("cpu")))
