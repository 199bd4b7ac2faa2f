"""The radix-4096 verify tier (kernel G, corda_tpu_torch/ops/ed25519_ladder4096.py)
against the reference's radix-4096 functions (corda_tpu/ops/ed25519_pallas.py).

- The plain version limb for limb against the reference's eager functions:
  field ops at random values and at the audited lazy bounds (limb 0 at
  11,262, the others at 8,232), the exponent chains, decompression
  (adversarial y included), point ops, the -A table, the byte repack and
  the constant table.
- Kernel G's own C++ (csrc/fe25519_w8.cuh and csrc/ed25519_ladder.cuh,
  built for the host through csrc/host_check.cpp) against Python ints at
  the field's word extremes, and lane by lane against the oracle.
- Verdicts of plain B and plain G, mask for mask, on every adversarial kind
  for both fixed-base shapes, and equal to the reference's host tier.
- The tier through ``dispatch_signature_rows``, the scheduler and the entry
  twin on ``device="cpu"``.

Integer code: every comparison is exact (tolerance zero). Inputs are made
from seeds with numpy and the port's pure-Python signer."""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_pallas as edp
from corda_tpu.ops.ed25519 import ed25519_verify_batch as ref_verify_batch
from corda_tpu_torch.crypto import PublicKey, ed25519_host
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import ed25519 as port_ed
from corda_tpu_torch.ops import ed25519_ladder as pl13
from corda_tpu_torch.ops import ed25519_ladder4096 as g
from corda_tpu_torch.ops import opcount
from corda_tpu_torch.ops.ed25519 import Ed25519Tier
from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

P = 2**255 - 19
B = 8
TIERS = [Ed25519Tier(), Ed25519Tier(8192, 4), Ed25519Tier(4096, 8), Ed25519Tier(4096, 4)]


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
    XLA op (the same integer program, one dispatch instead of ~90): the
    exponent chains then take a fraction of a second."""
    mp = pytest.MonkeyPatch()
    mp.setattr(edp, "fe_mul", jax.jit(edp.fe_mul))
    mp.setattr(edp, "fe_sq", jax.jit(edp.fe_sq))
    yield
    mp.undo()


def jax_env(b):
    def cfull(row):
        return jnp.broadcast_to(
            jnp.asarray(edp._CONSTS_HOST[row, : edp.LIMBS])[:, None], (edp.LIMBS, b))

    return edp.Env(
        k2=cfull(0), p_limbs=cfull(1), d=cfull(2), d2=cfull(3), sqrt_m1=cfull(4),
        b_table=tuple((cfull(8 + 3 * i), cfull(9 + 3 * i), cfull(10 + 3 * i))
                      for i in range(16)),
    )


@pytest.fixture(scope="module")
def envs():
    return jax_env(B), g.Field12(g.ladder_table("cpu"))


def limbs_of(ints):
    return np.stack([edp.int_to_limbs12(x) for x in ints]).T.astype(np.int32)


def both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.ascontiguousarray(arr))


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def operands():
    rng = np.random.default_rng(12)
    rand = [limbs_of([int.from_bytes(rng.bytes(31), "little") for _ in range(B)])
            for _ in range(2)]
    # the audited A2 bound the point formulas feed a multiply
    lazy = np.full((g.LIMBS, B), 8232, dtype=np.int32)
    lazy[0] = 11262
    return [(rand[0], rand[1]), (lazy, lazy), (rand[0], lazy)]


# ------------------------------------------------ the plain version


def test_constants_match_reference():
    F = g.Field12(g.ladder_table("cpu"))
    np.testing.assert_array_equal(F.k2[:, 0].numpy(), edp._K2)
    np.testing.assert_array_equal(F.p_limbs[:, 0].numpy(), edp._P12)
    for row, col in ((2, F.d), (3, F.d2), (4, F.sqrt_m1)):
        np.testing.assert_array_equal(col[:, 0].numpy(), edp._CONSTS_HOST[row, :22])
    comb = edp._CONSTS_HOST[56:824, :22].reshape(256, 3, 22)
    np.testing.assert_array_equal(F.comb.numpy(), comb)
    # the 16-entry window's table is the comb's prefix
    np.testing.assert_array_equal(
        F.comb[:16].numpy().reshape(48, 22), edp._CONSTS_HOST[8:56, :22])
    table = g.build_table()
    assert table.shape == (771, 8) and table.dtype == np.int32
    assert [g.words_to_int(r) for r in table[3:]] == [
        v for entry in edp._b_comb_host(256) for v in entry]


@pytest.mark.parametrize("case", range(3))
def test_field_ops_limb_for_limb(envs, case):
    jenv, F = envs
    a, b = operands()[case]
    (aj, at), (bj, bt) = both(a), both(b)
    same(edp.fe_mul(aj, bj), g.fe_mul(at, bt))
    same(edp.fe_sq(aj), g.fe_sq(at))
    same(edp.fe_add(aj, bj), g.fe_add(at, bt))
    same(edp.fe_sub(jenv, aj, bj), g.fe_sub(F, at, bt))
    same(edp.fe_carry1(edp.fe_add(aj, bj)), g.fe_carry1(g.fe_add(at, bt)))
    same(edp.fe_neg(jenv, aj), g.fe_neg(F, at))
    same(edp.fe_mul_small(aj, 2), g.fe_mul_small(at, 2))
    same(edp.fe_canonical(jenv, aj), g.fe_canonical(F, at))
    same(edp.fe_is_odd(jenv, aj), g.fe_is_odd(F, at))
    same(edp.fe_eq(jenv, aj, bj), g.fe_eq(F, at, bt))
    vals = [g.limbs12_to_int(c) for c in g.fe_canonical(F, g.fe_mul(at, bt)).numpy().T]
    assert vals == [g.limbs12_to_int(x) * g.limbs12_to_int(y) % P
                    for x, y in zip(a.T, b.T)]


def test_exponent_chains_limb_for_limb(envs):
    jenv, F = envs
    a, _ = operands()[0]
    aj, at = both(a)
    inv = F.inv(at)
    same(edp.fe_inv_chain(aj), inv)
    same(edp.fe_pow_sqrt_chain(aj), F.pow_sqrt(at))
    vals = [g.limbs12_to_int(c) for c in g.fe_canonical(F, inv).numpy().T]
    assert vals == [pow(g.limbs12_to_int(c), P - 2, P) for c in a.T]


def decompress_inputs():
    pks = [pk for pk, _s, _m in signed_triples(4, seed=11)]
    kinds = {k: pk for k, pk, _s, _m in adversarial_lanes(0)
             if k in ("off_curve_a", "x0_sign1", "small_order_a_identity",
                      "small_order_a_order8")}
    pks += list(kinds.values())
    arr = np.frombuffer(b"".join(pks), np.uint8).reshape(B, 32)
    y = arr.copy()
    y[:, 31] &= 0x7F
    return y, (arr[:, 31] >> 7).astype(np.int32)


def test_repack_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    same(edp.bytes_to_limb12_t(jnp.asarray(x))[: edp.LIMBS],
         g.bytes_to_limb12(torch.from_numpy(x)))


def test_decompress_and_points_limb_for_limb(envs):
    jenv, F = envs
    y, sign = decompress_inputs()
    yj = edp.bytes_to_limb12_t(jnp.asarray(y))[: edp.LIMBS]
    yt = g.bytes_to_limb12(torch.from_numpy(y))
    pj, okj = edp.decompress(jenv, yj, jnp.asarray(sign))
    pt, okt = g.decompress(F, yt, torch.from_numpy(sign))
    same(okj, okt)
    assert okt.numpy().tolist() == [True] * 4 + [False, False, True, True]
    for cj, ct in zip(pj, pt):
        same(cj, ct)
    for want_t in (True, False):
        dj = edp.point_double(jenv, pj, want_t=want_t)
        dt = g.point_double(F, pt, want_t=want_t)
        for cj, ct in zip(dj, dt):
            same(cj, ct)
    sj, st = edp.point_add(jenv, dj, pj), g.point_add(F, dt, pt)
    for cj, ct in zip(sj, st):
        same(cj, ct)
    qj = edp._add_q_planes(jenv, dj, edp.to_planes(jenv, pj))
    qt = g.add_q_planes(F, dt, g.to_planes(F, pt))
    for cj, ct in zip(qj, qt):
        same(cj, ct)
    bj = edp._add_b_entry(jenv, dj, jenv.b_table[5])
    entry5 = tuple(F.comb[5][c][:, None].expand(g.LIMBS, B) for c in range(3))
    bt = g.add_b_entry(F, dt, entry5)
    for cj, ct in zip(bj, bt):
        same(cj, ct)
    ej, ej_par = edp.compress_y_parity(jenv, sj)
    et, et_par = g.compress_y_parity(F, st)
    same(ej, et)
    same(ej_par, et_par)


def test_minus_a_table_limb_for_limb(envs):
    jenv, F = envs
    y, sign = decompress_inputs()
    pj, _ = edp.decompress(jenv, edp.bytes_to_limb12_t(jnp.asarray(y))[: edp.LIMBS],
                           jnp.asarray(sign))
    pt, _ = g.decompress(F, g.bytes_to_limb12(torch.from_numpy(y)), torch.from_numpy(sign))
    mj, mt = edp.point_neg(jenv, pj), g.point_neg(F, pt)
    pts = [edp.identity_point(B), mj]
    for k in range(2, 16):
        pts.append(edp.point_double(jenv, pts[k // 2]) if k % 2 == 0
                   else edp.point_add(jenv, pts[k - 1], mj))
    got = g.minus_a_table(F, mt)
    assert len(got) == 16
    for rj, rt in zip([edp.to_planes(jenv, p) for p in pts], got):
        for cj, ct in zip(rj, rt):
            same(cj, ct)


def test_op_count_is_kernel_b_schedule():
    """The comb shape runs kernel B's schedule (the same field multiplies and
    squarings a verify); the 16-entry window adds 32 mixed adds of 7
    multiplies."""
    comb, win4 = g.field_ops_per_verify(8), g.field_ops_per_verify(4)
    for fw, got in ((8, comb), (4, win4)):
        assert {k: got[k] for k in ("mul", "sq")} == opcount.ed25519_field_ops(fw)
    assert (win4["mul"] - comb["mul"], win4["sq"]) == (32 * 7, comb["sq"])
    assert opcount.g_int_ops(4) > opcount.g_int_ops(8) > 0


# --------------------------------------- kernel G's arithmetic on the host


@pytest.fixture(scope="module")
def hc():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    return _build.host_check()


def _gf(lib, op, a, b=0):
    out = ctypes.create_string_buffer(32)
    lib.hc_g_field(op, a.to_bytes(32, "little"), b.to_bytes(32, "little"), out)
    return int.from_bytes(out.raw, "little")


def word_extremes():
    """Canonical values with every word at 0 or 0xFFFFFFFF where p allows,
    and the values next to p, 2^255 - p and the fold's carries."""
    vals = {0, 1, 2, 19, 38, P - 1, P - 2, P - 19, P - 38, (P - 1) // 2, 2**32 - 1,
            2**224, 2**254, 2**255 - 2**32 - 19}
    for k in range(8):
        vals.add((2**32 - 1) << (32 * k) if k < 7 else 0x7FFFFFFF << 224)
        vals.add(P - (1 << (32 * k)))
    rng = np.random.default_rng(8)
    vals |= {int.from_bytes(rng.bytes(32), "little") % P for _ in range(16)}
    return sorted(v for v in vals if v < P)


def test_kernel_field_matches_python_ints(hc):
    xs = word_extremes()
    ys = xs[::-1]
    for x, y in zip(xs, ys):
        assert _gf(hc, 0, x, y) == (x + y) % P
        assert _gf(hc, 1, x, y) == (x - y) % P
        assert _gf(hc, 2, x, y) == x * y % P
        assert _gf(hc, 2, x, x) == _gf(hc, 3, x) == x * x % P
        assert _gf(hc, 4, x) == (-x) % P
    for x in xs[::4]:
        assert _gf(hc, 5, x) == pow(x, P - 2, P)
        assert _gf(hc, 6, x) == pow(x, (P - 5) // 8, P)


def test_kernel_decompress_matches_reference(hc, envs):
    jenv, _F = envs
    y, sign = decompress_inputs()
    (xj, _y, _z, _t), okj = edp.decompress(
        jenv, edp.bytes_to_limb12_t(jnp.asarray(y))[: edp.LIMBS], jnp.asarray(sign))
    x_can = np.asarray(edp.fe_canonical(jenv, xj))
    table = g.build_table()
    for i in range(B):
        pk = (y[i].copy())
        pk[31] |= sign[i] << 7
        out = ctypes.create_string_buffer(32)
        ok = hc.hc_g_decompress(pk.tobytes(), table.ctypes.data, out)
        assert bool(ok) == bool(np.asarray(okj)[i]), i
        if ok:
            assert int.from_bytes(out.raw, "little") == edp.limbs12_to_int(x_can[:, i])


def packed_plane(triples):
    pks, sigs, msgs = map(list, zip(*triples))
    pk_arr, sig_arr, ok = port_ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, pre = port_ed._canonical_precheck(pk_arr, sig_arr, ok)
    plane = np.zeros((len(pks), 161), np.uint8)
    port_ed.pack_rows(plane, sig_arr, pk_arr, s_arr, pre, msgs)
    return plane


@pytest.fixture(scope="module")
def adversarial():
    """Every adversarial kind (44-byte messages) and three valid rows, with
    the oracle's verdicts."""
    lanes = adversarial_lanes(0)
    kinds = [k for k, *_ in lanes] + ["valid"] * 3
    triples = [(pk, s, m) for _k, pk, s, m in lanes] + signed_triples(3, seed=41)
    return kinds, triples, [ed25519_host.verify(*t) for t in triples]


@pytest.mark.parametrize("fixed_win", [8, 4])
def test_kernel_lane_matches_oracle(hc, adversarial, fixed_win):
    _kinds, triples, want = adversarial
    packed = packed_plane(triples)
    win = challenge_windows_plain(torch.from_numpy(packed)).numpy()
    table = g.build_table()
    got = [bool(hc.hc_g_verify(packed[i].tobytes(),
                               np.ascontiguousarray(win[:, i]).ctypes.data,
                               table.ctypes.data, fixed_win))
           for i in range(len(triples))]
    assert got == want


# ------------------------------------------------------ verdicts by tier


@pytest.mark.parametrize("fixed_win", [8, 4])
def test_plain_b_and_g_verdicts_match_reference(adversarial, fixed_win):
    kinds, triples, want = adversarial
    packed = torch.from_numpy(packed_plane(triples))
    win = challenge_windows_plain(packed)
    got_b = pl13.VERIFY_B[fixed_win](packed, win, pl13.ladder_table("cpu"))
    got_g = g.VERIFY_G[fixed_win](packed, win, g.ladder_table("cpu"))
    assert got_g.tolist() == got_b.tolist() == want
    pks, sigs, msgs = map(list, zip(*triples))
    assert got_g.tolist() == ref_verify_batch(pks, sigs, msgs).tolist()
    assert {k for k, v in zip(kinds, got_g.tolist()) if v} == {
        "valid", "small_order_a_identity", "mixed_order_accept"}


@pytest.mark.parametrize("tier", TIERS, ids=lambda t: f"{t.radix}-{t.fixed_win}")
def test_tier_through_dispatch_and_scheduler(adversarial, tier, monkeypatch):
    """The tier reaches its ladder through ``dispatch_signature_rows`` (and
    the host-hash route of ``ed25519_verify_batch``) and through a
    scheduler of that tier; the other ladder is never run."""
    from corda_tpu_torch.serving import DeviceScheduler
    from corda_tpu_torch.verifier import dispatch_signature_rows

    ran = []
    for mod, name in ((pl13, "verify_ladder_plain"), (g, "verify_plain_g")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            ran.append(_n), _r(*a, **k))[1])
    _kinds, triples, want = adversarial
    rows = [(PublicKey(4, pk), s, m) for pk, s, m in triples]
    assert dispatch_signature_rows(rows, device="cpu", tier=tier).collect().tolist() == want
    var = signed_triples(2, seed=5, msg_len=(1, 90))
    pks, sigs, msgs = map(list, zip(*var))
    assert port_ed.ed25519_verify_batch(pks, sigs, msgs, device="cpu", tier=tier).all()
    sched = DeviceScheduler(device="cpu", tier=tier)
    try:
        rr = sched.submit_rows(rows).result(timeout=300)
    finally:
        sched.shutdown()
    assert rr.mask.tolist() == want and rr.n_device == len(rows)
    assert set(ran) == {"verify_ladder_plain" if tier.radix == 8192 else "verify_plain_g"}
    assert len(ran) == 3


def test_shared_schedulers_are_one_a_tier():
    from corda_tpu_torch.serving import device_scheduler, shutdown_scheduler

    try:
        default = device_scheduler("cpu")
        g8 = device_scheduler("cpu", Ed25519Tier(4096, 8))
        assert default.tier == Ed25519Tier() and g8.tier == Ed25519Tier(4096, 8)
        assert g8 is not default
        assert device_scheduler("cpu", Ed25519Tier(4096, 8)) is g8
        assert device_scheduler(tier=Ed25519Tier()) is default
    finally:
        shutdown_scheduler()
    assert default.closed and g8.closed


def test_tier_arguments():
    assert Ed25519Tier() == Ed25519Tier(8192, 8)
    # kernel B's 16-entry window is a tier of its own
    calls = []
    real = pl13.VERIFY_B[4]
    packed = torch.zeros((1, 161), dtype=torch.uint8)
    win = torch.zeros((64, 1), dtype=torch.int32)
    try:
        pl13.VERIFY_B[4] = lambda *a: (calls.append(a), real(*a))[1]
        assert Ed25519Tier(8192, 4).ladder(packed, win).tolist() == [False]
    finally:
        pl13.VERIFY_B[4] = real
    assert len(calls) == 1 and calls[0][2] is pl13.ladder_table("cpu")
    with pytest.raises(ValueError):
        pl13.verify_ladder_plain(packed, win, pl13.ladder_table("cpu"), 6)
    with pytest.raises(ValueError):
        Ed25519Tier(2048)
    with pytest.raises(ValueError):
        Ed25519Tier(4096, 5)
    with pytest.raises(ValueError):
        g.verify_plain_g(torch.zeros((1, 161), dtype=torch.uint8),
                         torch.zeros((64, 1), dtype=torch.int32), g.ladder_table("cpu"), 6)
    with pytest.raises(ValueError):
        g.ed25519_verify_g8(torch.zeros((1, 161), dtype=torch.uint8),
                            torch.zeros((64, 1), dtype=torch.int32),
                            pl13.ladder_table("cpu"))


def test_entry_twin_takes_a_tier():
    from corda_tpu_torch.entry import entry

    fn, (pks, sigs, msgs) = entry(Ed25519Tier(4096, 8))
    assert fn(pks[:4], sigs[:4], msgs[:4], device="cpu").all()
