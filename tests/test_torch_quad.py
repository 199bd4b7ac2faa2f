"""The four-thread verify ladder of kernels B and G
(corda_tpu_torch/csrc/ed25519_quad.cuh) and the dedicated squarings, through
the kernels' own C++ built for the host (csrc/host_check.cpp), where the
four-element vector type runs the very formulas each quad of threads runs
on the card.

- The four-way doubling, cached (plane-form) add and mixed add against the
  one-thread formulas (csrc/ed25519_ladder.cuh) and against the reference's
  point functions (corda_tpu/ops/ed25519_pallas13.py), coordinate for
  coordinate, over both fields: random points, the identity, P = Q and
  P = -Q, each with a random Z.
- The quad lane's verdicts for B8, B4, G8 and G4 on every adversarial kind,
  against the oracle and the reference's batch verify.
- Both dedicated squarings (ref10's 55 products, the 8-word 36) against
  Python integers and against the field's own multiply.
- ``Ed25519Tier(8192, 4)`` (kernel B's 16-entry window) through the entry
  twin.

Integer code: every comparison is exact (tolerance zero). Inputs are made
from seeds with numpy and the port's pure-Python signer."""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519_pallas13 as e13
from corda_tpu.ops.ed25519 import ed25519_verify_batch as ref_verify_batch
from corda_tpu_torch.crypto import ed25519_host
from corda_tpu_torch.crypto.ed25519_host import BX, BY, D, NEUTRAL, P, point_add, scalar_mul
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import ed25519 as port_ed
from corda_tpu_torch.ops import ed25519_ladder as pl13
from corda_tpu_torch.ops import ed25519_ladder4096 as g
from corda_tpu_torch.ops.ed25519 import Ed25519Tier
from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
from corda_tpu_torch.testing import adversarial_lanes, signed_triples

FIELDS = (10, 8)  # kernel B's ref10 limbs, kernel G's eight words
OPS = ("double", "add_planes", "add_entry")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small integer ops: beside the suite's
    other worker processes a torch thread pool only contends, so these
    tests run torch on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def hc():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build csrc/host_check.cpp")
    return _build.host_check()


def _bytes(vals) -> bytes:
    return b"".join(v.to_bytes(32, "little") for v in vals)


def _ints(raw: bytes) -> list:
    return [int.from_bytes(raw[32 * k: 32 * k + 32], "little") for k in range(len(raw) // 32)]


def _rescaled(pt, z):
    """The extended point pt (Z = 1 or any) with its coordinates times z."""
    return tuple(c * z % P for c in pt)


def _point_cases():
    """(p, q) pairs of extended points, each with a random Z: random
    multiples of B, the identity on either side, P = Q, P = -Q."""
    rng = np.random.default_rng(55)
    base = (BX, BY, 1, BX * BY % P)

    def rand_z():
        return int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1

    def rand_pt():
        return _rescaled(scalar_mul(int(rng.integers(1, 2**20)), base), rand_z())

    def neg(pt):
        x, y, z, t = pt
        return ((-x) % P, y, z, (-t) % P)

    a, b, c = rand_pt(), rand_pt(), rand_pt()
    ident = _rescaled(NEUTRAL, rand_z())
    return [(a, b), (b, c), (ident, a), (a, ident), (a, _rescaled(a, rand_z())),
            (b, neg(_rescaled(b, rand_z()))), (ident, ident)]


def _planes(q):
    """q in plane form (Y - X, Y + X, 2dT, 2Z)."""
    x, y, z, t = q
    return ((y - x) % P, (y + x) % P, 2 * D * t % P, 2 * z % P)


def _entry(q):
    """q affine as (y - x, y + x, 2dxy)."""
    x, y, z, _t = q
    zi = pow(z, P - 2, P)
    ax, ay = x * zi % P, y * zi % P
    return ((ay - ax) % P, (ay + ax) % P, 2 * D * ax % P * ay % P)


def _operand(op, q):
    return () if op == "double" else (_planes(q) if op == "add_planes" else _entry(q))


def _hc_point(lib, field, quad, op, p, qv):
    out = ctypes.create_string_buffer(128)
    lib.hc_point(field, quad, OPS.index(op), _bytes(p), _bytes(qv) if qv else None, out)
    return _ints(out.raw)


def _reference(op, cases):
    """The reference's radix-8192 point functions over the cases, one lane
    each: the resulting coordinates as field elements."""
    n = len(cases)

    def cols(vals):
        return jnp.asarray(np.stack([e13.int_to_limbs13(v) for v in vals]).T.astype(np.int32))

    env = e13.Env(
        k2=jnp.broadcast_to(jnp.asarray(e13._CONSTS_HOST[0, : e13.LIMBS])[:, None], (e13.LIMBS, n)),
        p_limbs=None, d=None,
        d2=jnp.broadcast_to(jnp.asarray(e13._CONSTS_HOST[3, : e13.LIMBS])[:, None], (e13.LIMBS, n)),
        sqrt_m1=None, b_table=None,
    )
    p = tuple(cols([c[0][k] for c in cases]) for k in range(4))
    qv = [_operand(op, q) for _p, q in cases]
    if op == "double":
        r = e13.point_double(env, p)
    elif op == "add_planes":
        r = e13._add_q_planes(env, p, tuple(cols([v[k] for v in qv]) for k in range(4)))
    else:
        r = e13._add_b_entry(env, p, tuple(cols([v[k] for v in qv]) for k in range(3)))
    r = [np.asarray(c) for c in r]
    return [[e13.limbs13_to_int(r[k][:, i]) % P for k in range(4)] for i in range(n)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_quad_formulas_match_one_thread_and_reference(hc, field, op):
    cases = _point_cases()
    want_ref = _reference(op, cases)
    for i, (p, q) in enumerate(cases):
        qv = _operand(op, q)
        quad = _hc_point(hc, field, 1, op, p, qv)
        serial = _hc_point(hc, field, 0, op, p, qv)
        assert quad == serial == want_ref[i], (field, op, i)
        # and the point itself: 2p or p + q over Python ints
        want = point_add(p, p) if op == "double" else point_add(p, q)
        x, y, z, t = quad
        wx, wy, wz, _wt = want
        assert x * wz % P == wx * z % P and y * wz % P == wy * z % P, (field, op, i)
        assert x * y % P == t * z % P, (field, op, i)


# ------------------------------------------------------- quad verdicts


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
    lanes = adversarial_lanes(3)
    triples = [(pk, s, m) for _k, pk, s, m in lanes] + signed_triples(3, seed=43)
    return triples, [ed25519_host.verify(*t) for t in triples]


@pytest.mark.parametrize("radix,fixed_win", [(8192, 8), (8192, 4), (4096, 8), (4096, 4)],
                         ids=["B8", "B4", "G8", "G4"])
def test_quad_lane_verdicts_match_oracle_and_reference(hc, adversarial, radix, fixed_win):
    triples, want = adversarial
    packed = packed_plane(triples)
    win = challenge_windows_plain(torch.from_numpy(packed)).numpy()
    if radix == 8192:
        table, verify = pl13.build_table(), hc.hc_verify
    else:
        table, verify = g.build_table(), hc.hc_g_verify
    got = [bool(verify(packed[i].tobytes(), np.ascontiguousarray(win[:, i]).ctypes.data,
                       table.ctypes.data, fixed_win))
           for i in range(len(triples))]
    assert got == want
    pks, sigs, msgs = map(list, zip(*triples))
    assert got == ref_verify_batch(pks, sigs, msgs).tolist()


# --------------------------------------------------- dedicated squarings


def _limb_extremes():
    """Values whose ref10 limbs (26/25 bits) sit at their extremes after the
    kernel's rounding carries: every limb all ones, every limb at its
    rounding threshold, single limbs at either, and values next to p."""
    vals = {0, 1, 2, 19, P - 1, P - 2, P - 19, (P - 1) // 2, 2**255 - 20, 2**254}
    for i, (off, w) in enumerate(zip(pl13.FE_OFFSETS, pl13.FE_WIDTHS)):
        vals.add(((1 << w) - 1) << off)
        vals.add(1 << (off + w - 1))
        vals.add(P - (1 << off))
    vals.add(sum(((1 << w) - 1) << o for o, w in zip(pl13.FE_OFFSETS, pl13.FE_WIDTHS)) % P)
    vals.add(sum(1 << (o + w - 1) for o, w in zip(pl13.FE_OFFSETS, pl13.FE_WIDTHS)) % P)
    rng = np.random.default_rng(77)
    vals |= {int.from_bytes(rng.bytes(32), "little") % P for _ in range(16)}
    return sorted(v % P for v in vals)


def _word_extremes():
    vals = {0, 1, 2, 19, 38, P - 1, P - 2, P - 19, P - 38, 2**32 - 1, 2**224, 2**254}
    for k in range(8):
        vals.add((2**32 - 1) << (32 * k) if k < 7 else 0x7FFFFFFF << 224)
        vals.add(P - (1 << (32 * k)))
    rng = np.random.default_rng(78)
    vals |= {int.from_bytes(rng.bytes(32), "little") % P for _ in range(16)}
    return sorted(v for v in vals if v < P)


def _call(lib, name, *args):
    out = ctypes.create_string_buffer(32)
    getattr(lib, name)(*args, out)
    return int.from_bytes(out.raw, "little")


@pytest.mark.parametrize("field", FIELDS)
def test_dedicated_squaring_matches_ints_and_multiply(hc, field):
    if field == 10:
        for x in _limb_extremes():
            xb = x.to_bytes(32, "little")
            sq = _call(hc, "hc_fe_sq", xb)
            assert sq == _call(hc, "hc_fe_mul", xb, xb) == x * x % P, x
            # and once more on its own output (the limbs a carry leaves)
            sq2 = _call(hc, "hc_fe_sq", sq.to_bytes(32, "little"))
            assert sq2 == pow(x, 4, P), x
    else:
        zero = (0).to_bytes(32, "little")
        for x in _word_extremes():
            xb = x.to_bytes(32, "little")
            sq = _call(hc, "hc_g_field", 3, xb, zero)
            assert sq == _call(hc, "hc_g_field", 2, xb, xb) == x * x % P, x


# --------------------------------------------------------- the new tier


def test_entry_twin_runs_kernel_b_window(monkeypatch):
    from corda_tpu_torch.entry import entry

    shapes = []
    real = pl13.verify_ladder_plain
    monkeypatch.setattr(pl13, "verify_ladder_plain", lambda *a, **k: (
        shapes.append(a[3] if len(a) > 3 else k.get("fixed_win", 8)), real(*a, **k))[1])
    tier = Ed25519Tier(8192, 4)
    assert tier.radix == 8192 and tier.fixed_win == 4
    fn, (pks, sigs, msgs) = entry(tier)
    assert fn(pks[:4], sigs[:4], msgs[:4], device="cpu").all()
    assert shapes == [4]


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_field():
    """The reference's eager field multiply and square, each jitted as one
    XLA op (the same integer program, one dispatch instead of ~70)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(e13, "fe_mul", jax.jit(e13.fe_mul))
    mp.setattr(e13, "fe_sq", jax.jit(e13.fe_sq))
    yield
    mp.undo()
