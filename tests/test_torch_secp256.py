"""The port's ECDSA verify path (corda_tpu_torch/ops/secp256.py, kernel F's
plain version in ops/secp256_ladder.py and its C++ arithmetic through
csrc/host_check.cpp) against the reference's corda_tpu/ops/secp256.py and
secp256_pallas.py on the CPU: host prep byte for byte, the comb and the
carried-over constants, the field at limb extremes, the complete point
formulas, and verdicts on every adversarial kind.

The reference's ``ecdsa_verify_batch`` compiles XLA's bit-serial ladder on
the CPU (seconds a curve), so each curve makes exactly one such call."""

import ctypes
import random

import numpy as np
import pytest
import torch

from corda_tpu.crypto import schemes as ref_schemes
from corda_tpu.ops import secp256 as ref_sp
from corda_tpu.ops import secp256_pallas as ref_spk
from corda_tpu.ops._blockpack import pow2_at_least as ref_pow2_at_least
from corda_tpu_torch import interop
from corda_tpu_torch.crypto import ecdsa_host
from corda_tpu_torch.ops import _build
from corda_tpu_torch.ops import secp256 as port_sp
from corda_tpu_torch.ops import secp256_ladder as sl
from corda_tpu_torch.testing import ecdsa_adversarial_lanes

CURVES = ["secp256k1", "secp256r1"]
SCHEME = {"secp256k1": 2, "secp256r1": 3}


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
def lanes():
    """Per curve: every adversarial kind, 16 lanes (kinds, pks, sigs, msgs)."""
    out = {}
    for name in CURVES:
        ls = ecdsa_adversarial_lanes(name, seed=11)
        assert len(ls) == 16
        out[name] = tuple(map(list, zip(*ls)))
    return out


def packed_rows(name, pks, sigs, msgs, b):
    packed = np.zeros((b, sl.ECDSA_ROW), np.uint8)
    port_sp.pack_planes(packed, port_sp._prep_byte_planes(name, pks, sigs, msgs, b))
    return packed


@pytest.mark.parametrize("name", CURVES)
def test_prep_byte_planes_match_reference(name, lanes):
    _kinds, pks, sigs, msgs = lanes[name]
    for b in (16, 32):
        mine = port_sp._prep_byte_planes(name, pks, sigs, msgs, b)
        theirs = ref_sp._prep_byte_planes(name, pks, sigs, msgs, b)
        assert len(mine) == len(theirs) == 8
        for plane, a, r in zip(("qx", "qy", "u1", "u2", "ra", "rb", "rb_ok", "pre"),
                               mine, theirs):
            assert a.dtype == r.dtype and np.array_equal(a, r), plane


@pytest.mark.parametrize("name", CURVES)
def test_comb_table_matches_reference(name):
    assert sl.g_comb_host(name) == ref_spk._g_comb_host(name)
    table = sl.build_table(name)
    cv = ref_sp._CURVES[name]
    assert sl.words_to_int(table[sl.ROW_P]) == cv.p
    assert sl.words_to_int(table[sl.ROW_B]) == cv.b % cv.p
    assert sl.words_to_int(table[sl.ROW_B3]) == 3 * cv.b % cv.p
    assert [sl.words_to_int(r) for r in table[sl.ROW_COMB : sl.ROW_COMB + 6]] == [0, 1, 0, cv.gx, cv.gy, 1]


@pytest.mark.parametrize("name,tier,build", [
    ("secp256k1", "k1", lambda: ref_spk._consts_host_k1()),
    ("secp256k1", "4096", lambda: ref_spk._consts_host_4096("secp256k1")),
    ("secp256k1", "256", lambda: ref_spk._consts_host("secp256k1")),
    ("secp256r1", "4096", lambda: ref_spk._consts_host_4096("secp256r1")),
    ("secp256r1", "256", lambda: ref_spk._consts_host("secp256r1")),
])
def test_interop_round_trips_every_tier(name, tier, build):
    consts = build()
    table = interop.ecdsa_table_from_reference(name, consts)
    assert np.array_equal(table.numpy(), sl.build_table(name))
    assert np.array_equal(interop.ecdsa_table_to_reference(name, table, tier), consts)
    with pytest.raises(ValueError):
        interop.ecdsa_table_from_reference(
            "secp256r1" if name == "secp256k1" else "secp256k1", consts)


def field_values(p, rng):
    return [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 2**255 % p, 2**224 % p,
            (2**32 + 977) % p, 2**256 - 1 - p] + [rng.randrange(p) for _ in range(6)]


@pytest.mark.parametrize("name", CURVES)
def test_field_matches_python_ints_at_extremes(name):
    """Kernel F's field (host_check) on canonical extremes, and the plain
    16-limb field on canonical and lazy (|limb| near 2^17) inputs; the b3
    product too, which for secp256k1 is a one-word scaling (its word at
    the extremes as well as 21)."""
    cv = ecdsa_host.CURVES[name]
    p, b3 = cv.p, 3 * cv.b % cv.p
    vals = field_values(p, random.Random(5))
    lib = _build.host_check()
    out = ctypes.create_string_buffer(32)
    for a in vals:
        for b in vals:
            for op, want in ((0, (a + b) % p), (1, (a - b) % p), (2, a * b % p)):
                lib.hc_sp_field(sl.CURVE_IDS[name], op, a.to_bytes(32, "little"),
                                b.to_bytes(32, "little"), out)
                assert int.from_bytes(out.raw, "little") == want, (op, hex(a), hex(b))
        scales = (0, 1, b3, 2**32 - 1) if name == "secp256k1" else (b3,)
        for k in scales:
            lib.hc_sp_field(sl.CURVE_IDS[name], 3, a.to_bytes(32, "little"),
                            k.to_bytes(32, "little"), out)
            assert int.from_bytes(out.raw, "little") == a * k % p, ("mul_b3", hex(a), k)

    table = sl.build_table(name)
    F = sl.TorchField(name, "cpu", sl.words_to_int(table[sl.ROW_B]),
                      sl.words_to_int(table[sl.ROW_B3]))
    lazy = np.full((16, 4), (1 << 17) - 1, dtype=np.int64)
    lazy[:, 1] = -((1 << 17) - 1)
    lazy[::2, 2] = -((1 << 17) - 1)
    lazy[:, 3] = np.arange(16) * 4099 - 30000
    cols = [sl.int_to_limbs16(v) for v in vals]
    a = torch.from_numpy(np.concatenate([np.stack(cols, 1), lazy], 1))
    b = torch.flip(a, [1])
    ints = [sl.limbs16_to_int(a[:, i].numpy()) for i in range(a.shape[1])]
    ints_b = ints[::-1]
    for op, fn in (("mul", lambda x, y: x * y), ("add", lambda x, y: x + y),
                   ("sub", lambda x, y: x - y)):
        got = getattr(F, op)(a, b)
        assert got.abs().max() < 1 << 17
        canon = F.canonical(got)
        assert ((canon >= 0) & (canon < 1 << 16)).all()
        assert [sl.limbs16_to_int(canon[:, i].numpy()) for i in range(a.shape[1])] == \
            [fn(x, y) % p for x, y in zip(ints, ints_b)], op
    got = F.mul_b3(a)
    assert got.abs().max() < 1 << 17
    canon = F.canonical(got)
    assert [sl.limbs16_to_int(canon[:, i].numpy()) for i in range(a.shape[1])] == \
        [b3 * x % p for x in ints]


def _word_extremes(p):
    """Canonical values whose 32-bit words sit at their extremes: each word
    all ones or only its top bit, every word all ones below p, values next
    to p and to the words' boundaries, and random ones."""
    vals = {0, 1, 2, 3, p - 1, p - 2, p - 3, (p - 1) // 2, (p + 1) // 2}
    for k in range(8):
        vals |= {(2**32 - 1) << (32 * k), 1 << (32 * k + 31), 1 << (32 * k),
                 p - (1 << (32 * k)), (2**(32 * k + 32) - 1)}
    rng = random.Random(23)
    vals |= {rng.randrange(p) for _ in range(16)}
    return sorted(v % p for v in vals)


@pytest.mark.parametrize("name", CURVES)
def test_dedicated_squaring_at_word_extremes(name):
    """Kernel F's dedicated squaring (36 products and the doubled cross
    terms, csrc/secp256_field.cuh's ct_sp_sq) equals Python integers and
    the field's own multiply at the word extremes."""
    p = ecdsa_host.CURVES[name].p
    lib = _build.host_check()
    out = ctypes.create_string_buffer(32)
    for a in _word_extremes(p):
        ab = a.to_bytes(32, "little")
        lib.hc_sp_field(sl.CURVE_IDS[name], 4, ab, bytes(32), out)
        assert int.from_bytes(out.raw, "little") == a * a % p, hex(a)
        sq = out.raw
        lib.hc_sp_field(sl.CURVE_IDS[name], 2, ab, ab, out)
        assert out.raw == sq, hex(a)


def to_bytes(pt):
    return b"".join(v.to_bytes(32, "little") for v in pt)


def from_bytes(raw):
    return tuple(int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(3))


def same_point(p, a, b):
    (x1, y1, z1), (x2, y2, z2) = a, b
    return (x1 * z2 - x2 * z1) % p == 0 and (y1 * z2 - y2 * z1) % p == 0 and \
        (z1 % p == 0) == (z2 % p == 0)


@pytest.mark.parametrize("name", CURVES)
def test_point_formulas_match_reference(name):
    """Add and double on the identity, P == Q, P == -Q and random points
    with random Z: the kernel's four-thread formulas (host_check, the
    quad's rounds in turn) and the plain version's equal the reference's
    ``_proj_add_host``, and the kernel's doubling equals the plain
    version's coordinate for coordinate."""
    cv = ref_sp._CURVES[name]
    p = cv.p
    g = (cv.gx, cv.gy, 1)
    two_g = ref_spk._proj_add_host(cv, g, g)
    z = 0x1234567 % p
    pts = [(0, 1, 0), g, (cv.gx, p - cv.gy, 1), two_g,
           (two_g[0] * z % p, two_g[1] * z % p, two_g[2] * z % p)]
    rng = random.Random(17)
    for _ in range(3):
        x, y = ecdsa_host.base_mult(ecdsa_host.CURVES[name], rng.randrange(1, cv.n))
        zr = rng.randrange(1, p)
        pts.append((x * zr % p, y * zr % p, zr))
    table = np.ascontiguousarray(sl.build_table(name))
    lib = _build.host_check()
    F = sl.TorchField(name, "cpu", cv.b % p, 3 * cv.b % p)

    def planes(seq):
        return tuple(torch.from_numpy(np.stack([sl.int_to_limbs16(pt[c]) for pt in seq], 1))
                     for c in range(3))

    def canon_points(seq):
        x, y, zz = (F.canonical(c) for c in seq)
        return [tuple(sl.limbs16_to_int(c[:, i].numpy()) for c in (x, y, zz))
                for i in range(x.shape[1])]

    left = [a for a in pts for _b in pts]
    right = [b for _a in pts for b in pts]
    plain_add = canon_points(sl.point_add(F, planes(left), planes(right)))
    plain_dbl = canon_points(sl.point_double(F, planes(pts)))
    out = ctypes.create_string_buffer(96)
    for k, (a, b) in enumerate(zip(left, right)):
        want = ref_spk._proj_add_host(cv, a, b)
        lib.hc_sp_point(sl.CURVE_IDS[name], to_bytes(a), to_bytes(b), table.ctypes.data, out)
        assert from_bytes(out.raw) == want
        assert plain_add[k] == want
    for k, a in enumerate(pts):
        want = ref_spk._proj_add_host(cv, a, a)
        lib.hc_sp_point(sl.CURVE_IDS[name], to_bytes(a), None, table.ctypes.data, out)
        assert same_point(p, from_bytes(out.raw), want)
        assert same_point(p, plain_dbl[k], want)
        assert from_bytes(out.raw) == plain_dbl[k]
    # P + (-P) and 2 * identity are the identity
    assert same_point(p, plain_add[len(pts) * 1 + 2], (0, 1, 0))
    assert same_point(p, plain_dbl[0], (0, 1, 0))


@pytest.mark.parametrize("name", CURVES)
def test_group_formulas_match_reference_point_functions(name):
    """Kernel F's four-thread add and doubling (host_check) against the
    reference kernel's own ``point_add`` and ``point_double``
    (corda_tpu/ops/secp256_pallas.py :935, :967, run eagerly on its limb
    environment) on random points with random Z, the identity, P == Q and
    P == -Q: every coordinate equal."""
    import jax.numpy as jnp

    cv = ref_sp._CURVES[name]
    p = cv.p
    rng = random.Random(29)
    pts = [(0, 1, 0)]
    for _ in range(5):
        x, y = ecdsa_host.base_mult(ecdsa_host.CURVES[name], rng.randrange(1, cv.n))
        zr = rng.randrange(1, p)
        pts.append((x * zr % p, y * zr % p, zr))
    pts.append(pts[1])
    pts.append((pts[1][0], p - pts[1][1], pts[1][2]))
    left, right = pts[:-1], pts[1:]
    env = ref_spk.Env(jnp.asarray(ref_spk._consts_host(name)), len(left), cv)

    def limbs(seq, c):
        return jnp.asarray(np.stack([ref_sp._int_to_limbs(pt[c]) for pt in seq], 1)
                           .astype(np.int32))

    def ints(coord):
        canon = np.asarray(ref_spk.fe_canonical(env, coord))
        return [ref_sp._limbs_to_int(canon[:, i]) for i in range(canon.shape[1])]

    def ref_points(out):
        return list(zip(*(ints(c) for c in out)))

    want_add = ref_points(ref_spk.point_add(env, tuple(limbs(left, c) for c in range(3)),
                                            tuple(limbs(right, c) for c in range(3))))
    want_dbl = ref_points(ref_spk.point_double(env, tuple(limbs(left, c) for c in range(3))))
    table = np.ascontiguousarray(sl.build_table(name))
    lib = _build.host_check()
    out = ctypes.create_string_buffer(96)
    for k, (a, b) in enumerate(zip(left, right)):
        lib.hc_sp_point(sl.CURVE_IDS[name], to_bytes(a), to_bytes(b), table.ctypes.data, out)
        assert from_bytes(out.raw) == want_add[k], k
        lib.hc_sp_point(sl.CURVE_IDS[name], to_bytes(a), None, table.ctypes.data, out)
        assert from_bytes(out.raw) == want_dbl[k], k


# the lanes of the one reference ladder call a curve (8 lanes: its
# smallest bucket, which tests/test_ops_secp256.py compiles too)
LADDER_KINDS = ("valid", "valid_uncompressed", "second_candidate", "flipped_r_bit",
                "flipped_s_bit", "altered_msg", "wrong_key", "other_curve_key")


@pytest.mark.parametrize("name", CURVES)
def test_verdicts_match_reference(name, lanes):
    """Every kind: the port's batch on the CPU (plain version) and kernel
    F's lane through host_check equal the reference's ``is_valid``; the
    eight kinds that reach the ladder also equal the reference's
    ``ecdsa_verify_batch`` (one call a curve)."""
    kinds, pks, sigs, msgs = lanes[name]
    want = [ref_schemes.is_valid(ref_schemes.PublicKey(SCHEME[name], pk), s, m)
            for pk, s, m in zip(pks, sigs, msgs)]
    assert dict(zip(kinds, want))["second_candidate"]
    sub = [kinds.index(k) for k in LADDER_KINDS]
    ref_mask = ref_sp.ecdsa_verify_batch(name, [pks[i] for i in sub], [sigs[i] for i in sub],
                                         [msgs[i] for i in sub])
    assert ref_mask.tolist() == [want[i] for i in sub]
    got = port_sp.ecdsa_verify_batch(name, pks, sigs, msgs, device="cpu")
    assert got.tolist() == want, [k for k, g, w in zip(kinds, got, want) if g != w]
    packed = packed_rows(name, pks, sigs, msgs, 16)
    table = np.ascontiguousarray(sl.build_table(name))
    lib = _build.host_check()
    hc = [bool(lib.hc_ecdsa_verify(sl.CURVE_IDS[name],
                                   np.ascontiguousarray(packed[i]).ctypes.data,
                                   table.ctypes.data)) for i in range(16)]
    assert hc == want


def test_second_candidate_lane_needs_the_second_candidate():
    """Clearing rb_ok turns the second-candidate lane's accept into a
    reject, in the plain version and in the kernel's lane."""
    name = "secp256r1"
    ls = {k: (pk, s, m) for k, pk, s, m in ecdsa_adversarial_lanes(name, seed=4)}
    pk, sig, msg = ls["second_candidate"]
    packed = packed_rows(name, [pk], [sig], [msg], 8)
    assert packed[0, sl.COL_RB_OK] == 1 and packed[0, sl.COL_PRE] == 1
    table = torch.from_numpy(sl.build_table(name))
    lib = _build.host_check()
    row = packed[:1].copy()
    for rb_ok, want in ((1, True), (0, False)):
        row[0, sl.COL_RB_OK] = rb_ok
        assert sl.verify_plain(name, torch.from_numpy(row), table).tolist() == [want]
        assert bool(lib.hc_ecdsa_verify(1, row.ctypes.data, table.numpy().ctypes.data)) == want


def test_op_count_matches_the_plain_ladder():
    """The bound's field-operation count equals what the plain version
    calls on one lane that runs the whole ladder."""
    name = "secp256k1"
    kp_lanes = ecdsa_adversarial_lanes(name, seed=2)
    pk, sig, msg = next((pk, s, m) for k, pk, s, m in kp_lanes if k == "valid")
    packed = torch.from_numpy(packed_rows(name, [pk], [sig], [msg], 1))
    counts = {"mul": 0, "sq": 0, "add": 0, "mul_b3": 0}
    orig = {k: getattr(sl.TorchField, k)
            for k in ("mul", "sq", "add", "sub", "mul_small", "mul_b3")}

    def counted(kind, fn, n=lambda *a: 1):
        def wrapper(self, *args):
            counts[kind] += n(*args)
            return fn(self, *args)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sl.TorchField, "mul", counted("mul", orig["mul"]))
        mp.setattr(sl.TorchField, "sq", lambda self, a: (
            counts.__setitem__("sq", counts["sq"] + 1), orig["mul"](self, a, a))[1])
        mp.setattr(sl.TorchField, "add", counted("add", orig["add"]))
        mp.setattr(sl.TorchField, "sub", counted("add", orig["sub"]))
        mp.setattr(sl.TorchField, "mul_small", counted(
            "add", orig["mul_small"], lambda _a, k: {2: 1, 3: 2, 4: 2}[k]))
        mp.setattr(sl.TorchField, "mul_b3", counted("mul_b3", orig["mul_b3"]))
        assert sl.verify_plain(name, packed, torch.from_numpy(sl.build_table(name))).tolist() == [True]
    assert counts == sl.field_ops_per_verify(name)
    r1 = sl.field_ops_per_verify("secp256r1")
    assert (r1["mul"], r1["mul_b3"]) == (counts["mul"], counts["mul_b3"])


def test_bucket_rule_and_device_default():
    """Buckets follow the reference's rule (power of two at least max(n,
    min_bucket, 8) off the card); the entry point defaults to the card and
    raises without one; the CPU path launches no kernel."""
    name = "secp256k1"
    kinds, pks, sigs, msgs = map(list, zip(*ecdsa_adversarial_lanes(name, seed=6)))
    before = sl.ecdsa_verify_k1.launches
    for n, min_bucket in ((1, None), (3, None), (9, None), (3, 32), (5, 20)):
        mask = port_sp.ecdsa_verify_dispatch(name, pks[:n], sigs[:n], msgs[:n],
                                             min_bucket=min_bucket, device="cpu")
        assert mask.shape[0] == ref_pow2_at_least(n, max(min_bucket or 0, 8))
        assert not mask[n:].any()
    assert sl.ecdsa_verify_k1.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_sp.ecdsa_verify_dispatch(name, pks[:1], sigs[:1], msgs[:1])
    with pytest.raises(ValueError):
        sl.ecdsa_verify_r1(torch.zeros((8, 193), dtype=torch.uint8),
                           torch.from_numpy(sl.build_table("secp256r1")))
