"""The port's plain ladder (corda_tpu_torch/ops/ed25519_ladder.py) against the
reference's radix-8192 eager functions (corda_tpu/ops/ed25519_pallas13.py),
limb for limb: field ops at random and at the audited extreme limb values,
decompression (adversarial y included), point ops and the -A table.

Integer code: every comparison is exact (tolerance zero). Inputs are made
from seeds with numpy and the port's pure-Python signer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_pallas13 as e13
from corda_tpu_torch.ops import ed25519_ladder as pl13
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

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


def jax_env(b):
    def cfull(row):
        return jnp.broadcast_to(
            jnp.asarray(e13._CONSTS_HOST[row, : e13.LIMBS])[:, None], (e13.LIMBS, b)
        )

    return e13.Env(
        k2=cfull(0), p_limbs=cfull(1), d=cfull(2), d2=cfull(3), sqrt_m1=cfull(4),
        b_table=tuple((cfull(8 + 3 * i), cfull(9 + 3 * i), cfull(10 + 3 * i))
                      for i in range(16)),
    )


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_field():
    """The reference's eager field multiply and square, each jitted as one
    XLA op (the same integer program, one dispatch instead of ~70): the
    exponent chains then take a fraction of a second."""
    mp = pytest.MonkeyPatch()
    mp.setattr(e13, "fe_mul", jax.jit(e13.fe_mul))
    mp.setattr(e13, "fe_sq", jax.jit(e13.fe_sq))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def envs():
    return jax_env(B), pl13.env_from_table(pl13.ladder_table("cpu"))


def limbs_of(ints):
    return np.stack([e13.int_to_limbs13(x) for x in ints]).T.astype(np.int32)


def both(arr):
    return jnp.asarray(arr), torch.from_numpy(np.ascontiguousarray(arr))


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def operands():
    rng = np.random.default_rng(9)
    rand = [limbs_of([int.from_bytes(rng.bytes(31), "little") for _ in range(B)])
            for _ in range(2)]
    # the audited fixpoint bound of the carry discipline: every limb at 10,015
    lazy = np.full((20, B), 10015, dtype=np.int32)
    return [(rand[0], rand[1]), (lazy, lazy), (rand[0], lazy)]


@pytest.mark.parametrize("case", range(3))
def test_field_ops_limb_for_limb(envs, case):
    jenv, tenv = envs
    a, b = operands()[case]
    (aj, at), (bj, bt) = both(a), both(b)
    same(e13.fe_mul(aj, bj), pl13.fe_mul(at, bt))
    same(e13.fe_sq(aj), pl13.fe_sq(at))
    same(e13.fe_add(aj, bj), pl13.fe_add(at, bt))
    same(e13.fe_sub(jenv, aj, bj), pl13.fe_sub(tenv, at, bt))
    same(e13.fe_neg(jenv, aj), pl13.fe_neg(tenv, at))
    same(e13.fe_mul_small(aj, 2), pl13.fe_mul_small(at, 2))
    same(e13.fe_canonical(jenv, aj), pl13.fe_canonical(tenv, at))
    same(e13.fe_is_odd(jenv, aj), pl13.fe_is_odd(tenv, at))


def test_exponent_chains_limb_for_limb(envs):
    jenv, tenv = envs
    a, _ = operands()[0]
    aj, at = both(a)
    inv = pl13.fe_inv_chain(at)
    same(e13.fe_inv_chain(aj), inv)
    same(e13.fe_pow_sqrt_chain(aj), pl13.fe_pow_sqrt_chain(at))
    vals = [pl13.limbs13_to_int(c) for c in pl13.fe_canonical(tenv, inv).numpy().T]
    ints = [pl13.limbs13_to_int(c) for c in a.T]
    assert vals == [pow(x, P - 2, P) for x in ints]


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


def test_decompress_and_points_limb_for_limb(envs):
    jenv, tenv = envs
    y, sign = decompress_inputs()
    yj = e13.bytes_to_limb13_t(jnp.asarray(y))[: e13.LIMBS]
    yt = pl13.bytes_to_limb13(torch.from_numpy(y))
    same(yj, yt)
    pj, okj = e13.decompress(jenv, yj, jnp.asarray(sign))
    pt, okt = pl13.decompress(tenv, yt, torch.from_numpy(sign))
    same(okj, okt)
    assert okt.numpy().tolist() == [True] * 4 + [False, False, True, True]
    for cj, ct in zip(pj, pt):
        same(cj, ct)

    dj, dt = e13.point_double(jenv, pj), pl13.point_double(tenv, pt)
    for cj, ct in zip(dj, dt):
        same(cj, ct)
    dj3, dt3 = e13.point_double(jenv, pj, want_t=False), pl13.point_double(tenv, pt, want_t=False)
    for cj, ct in zip(dj3, dt3):
        same(cj, ct)
    sj, st = e13.point_add(jenv, dj, pj), pl13.point_add(tenv, dt, pt)
    for cj, ct in zip(sj, st):
        same(cj, ct)
    qj = e13._add_q_planes(jenv, dj, e13.to_planes(jenv, pj))
    qt = pl13.add_q_planes(tenv, dt, pl13.to_planes(tenv, pt))
    for cj, ct in zip(qj, qt):
        same(cj, ct)
    bj = e13._add_b_entry(jenv, dj, jenv.b_table[5])
    comb5 = tuple(tenv.comb[5][c][:, None].expand(20, B) for c in range(3))
    bt = pl13.add_b_entry(tenv, dt, comb5)
    for cj, ct in zip(bj, bt):
        same(cj, ct)
    ej, ej_par = e13.compress_y_parity(jenv, sj)
    et, et_par = pl13.compress_y_parity(tenv, st)
    same(ej, et)
    same(ej_par, et_par)


def test_minus_a_table_limb_for_limb(envs):
    jenv, tenv = envs
    y, sign = decompress_inputs()
    pj, _ = e13.decompress(jenv, e13.bytes_to_limb13_t(jnp.asarray(y))[: e13.LIMBS],
                           jnp.asarray(sign))
    pt, _ = pl13.decompress(tenv, pl13.bytes_to_limb13(torch.from_numpy(y)),
                            torch.from_numpy(sign))
    mj, mt = e13.point_neg(jenv, pj), pl13.point_neg(tenv, pt)
    pts = [e13.identity_point(B), mj]
    for k in range(2, 16):
        pts.append(e13.point_double(jenv, pts[k // 2]) if k % 2 == 0
                   else e13.point_add(jenv, pts[k - 1], mj))
    ref = [e13.to_planes(jenv, p) for p in pts]
    got = pl13.minus_a_table(tenv, mt)
    assert len(got) == 16
    for rj, rt in zip(ref, got):
        for cj, ct in zip(rj, rt):
            same(cj, ct)


def test_comb_matches_reference_constants():
    comb = pl13.env_from_table(pl13.ladder_table("cpu")).comb.numpy()
    ref = e13._CONSTS_HOST[56:824, :20].reshape(256, 3, 20)
    np.testing.assert_array_equal(comb, ref)


def test_field_op_count_matches_plain_ladder(monkeypatch):
    """The per-verify multiply/square counts behind kernel B's bound are the
    ones the ladder schedule really performs."""
    counts = {"mul": 0, "sq": 0}
    mul = pl13.fe_mul

    def count_mul(a, b):
        counts["mul"] += 1
        return mul(a, b)

    def count_sq(a):
        counts["sq"] += 1
        return mul(a, a)

    monkeypatch.setattr(pl13, "fe_mul", count_mul)
    monkeypatch.setattr(pl13, "fe_sq", count_sq)
    packed = torch.zeros((1, 161), dtype=torch.uint8)
    h_win = torch.zeros((64, 1), dtype=torch.int32)
    for fixed_win in (8, 4):
        counts.update(mul=0, sq=0)
        pl13.verify_ladder_plain(packed, h_win, pl13.ladder_table("cpu"), fixed_win)
        assert counts == {"mul": pl13.FIELD_MUL_PER_VERIFY[fixed_win],
                          "sq": pl13.FIELD_SQ_PER_VERIFY[fixed_win]}
