"""The radix-4096 ed25519 verify tier: kernel G, its constant table and its
plain version.

Counterpart of corda_tpu/ops/ed25519_pallas.py:60-500 (the 22 x 12-bit field,
the points, ``decompress`` :490, ``compress_y_parity`` :509) and of its
kernel (``_make_verify_kernel`` :523, launched by ``verify_pallas_windows``
:666), for both of its fixed-base shapes: the 8-bit comb (``fixed_win=8``,
one mixed add on every even window with the digit s[k] + 16 s[k+1]) and the
16-entry window (``fixed_win=4``, one mixed add every window).

- ``build_table`` / ``ladder_table``: kernel G's constant table, in its
  field representation (eight little-endian 32-bit words): d, 2d, sqrt(-1)
  and the 256-entry comb v*B as (y - x, y + x, 2dxy); the 16-entry window
  reads the comb's first 16 entries, as the reference's table is the comb's
  prefix (``_b_table_host`` :151).
- The plain version runs the reference's 22 x 12-bit int32 schedule op for
  op: lazy adds that do not carry, one carry pass where an A3 sum feeds a
  multiply, the 44-column schoolbook with the split 2^264 = 2 * 4096 + 1536
  fold, ``fe_canonical``'s exact chains. The field's functions keep the
  reference's names and signatures, so they hold limb for limb against its
  eager functions; the point formulas take the field as an object
  (``Field12``), so a counting field gives kernel G's bound from the same
  schedule. Table entries are gathered by index where the TPU selects.
- ``ed25519_verify_g8`` / ``ed25519_verify_g4`` are the wrappers, one a
  fixed-base shape, each with its own launch counter: kernel G
  (csrc/ed25519_verify_g.cu) for CUDA tensors, the plain version for CPU
  tensors. Both read kernel B's inputs: the packed (B, 161) plane and the
  (64, B) windows of h.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..crypto.ed25519_host import D, P, SQRT_M1
from . import _build
from .addchain import pow_p_minus_2, pow_p_minus_5_over_8
from .ed25519_ladder import (
    FIXED_WINS,
    ROW_COMB,
    ROW_D,
    ROW_D2,
    ROW_SQRT_M1,
    TABLE_ROWS,
    b_comb_host,
)
from .scalar25519 import WINDOWS, check_packed
from .secp256_ladder import int_to_words, words_to_int

LIMBS = 22
RADIX = 12
MASK = (1 << RADIX) - 1
# 2^264 = 9728 (mod p) = 2 * 4096 + 1536: a wrap adds 1536 q to limb 0 and
# 2 q to limb 1
WRAP_LO = 1536
WRAP_HI = 2
D2 = (2 * D) % P

# ------------------------------------------------ the constant table


@functools.lru_cache(maxsize=1)
def _table_host() -> np.ndarray:
    rows = [int_to_words(D), int_to_words(D2), int_to_words(SQRT_M1)]
    for entry in b_comb_host(256):
        rows.extend(int_to_words(c) for c in entry)
    table = np.stack(rows)
    table.setflags(write=False)
    return table


def build_table() -> np.ndarray:
    """The (771, 8) int32 constant table of kernel G."""
    return _table_host().copy()


_tables: dict = {}
_tables_lock = threading.Lock()


def ladder_table(device) -> torch.Tensor:
    """Kernel G's constant table on ``device`` (built once per device)."""
    key = str(device)
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            t = torch.from_numpy(build_table()).to(device)
            _tables[key] = t
        return t


# ------------------------------------------ the plain 22 x 12-bit field


def int_to_limbs12(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(LIMBS)], dtype=np.int32)


def limbs12_to_int(limbs) -> int:
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(limbs)))


# 1024 p with every limb >= 14336, above any subtrahend limb under the lazy
# bounds: the all-16380 vector (2^266 - 4 = 38908 mod p) less 38908 =
# 9 * 4096 + 2044 taken from limbs 0 and 1 (the reference's _K2)
K2 = np.full(LIMBS, 16380, dtype=np.int32)
K2[0] -= 2044
K2[1] -= 9
P12 = int_to_limbs12(P)


def _carry_pass(c):
    """One carry pass with the split 2^264 wrap."""
    q = c >> RADIX
    r = c - (q << RADIX)
    top = q[LIMBS - 1 :]
    return r + torch.cat([WRAP_LO * top, q[:1] + WRAP_HI * top, q[1 : LIMBS - 1]], dim=0)


def _carry(c, passes):
    for _ in range(passes):
        c = _carry_pass(c)
    return c


def _fold_cols44(c):
    """(44, B) schoolbook columns -> (22, B) limbs in the M bound: one raw
    carry pass over the 44 columns, then the split fold of columns 22..43
    (column 22 + j at 1536 hi_j on limb j and 2 hi_j on limb j + 1; j = 21
    wraps again, 2 * 2^264 = 4 * 4096 + 3072), then three wrap passes."""
    q = c >> RADIX
    r = c - (q << RADIX)
    c = r + torch.cat([torch.zeros_like(q[:1]), q[:-1]], dim=0)
    lo, hi = c[:LIMBS], c[LIMBS:]
    top = hi[LIMBS - 1 :]
    zero = torch.zeros_like(top)
    t2 = torch.cat([3072 * top, WRAP_HI * hi[: LIMBS - 1]], dim=0)
    four_top = torch.cat([zero, 4 * top, zero.expand(LIMBS - 2, -1)], dim=0)
    return _carry(lo + WRAP_LO * hi + t2 + four_top, 3)


def fe_mul(a, b):
    """Schoolbook into 44 columns (each the sum over i + j = k of a_i b_j,
    laid out by skewing the product matrix), then the fold."""
    prod = a[:, None, :] * b[None, :, :]
    n, lanes = LIMBS, prod.shape[2]
    pad = torch.zeros((n, n + 1, lanes), dtype=prod.dtype, device=prod.device)
    skew = torch.cat([prod, pad], dim=1).reshape(n * (2 * n + 1), lanes)
    cols = skew[: 2 * n * n].reshape(n, 2 * n, lanes).sum(0, dtype=torch.int32)
    return _fold_cols44(cols)


def fe_sq(a):
    """The reference's dedicated squaring sums the same column values."""
    return fe_mul(a, a)


def fe_add(a, b):
    """Lazy: no carry (callers track the bound)."""
    return a + b


def fe_sub(env, a, b):
    return _carry(a - b + env.k2, 2)


def fe_carry1(c):
    """One pass, for an A3 sum that feeds a multiply."""
    return _carry_pass(c)


def fe_neg(env, a):
    return fe_sub(env, torch.zeros_like(a), a)


def fe_mul_small(a, k):
    if k != 2:
        raise ValueError("only x2 is supported")
    return a * 2


def fe_canonical(env, a):
    """Exact reduction: limbs in [0, 4095], value in [0, p)."""
    def exact_carry(c):
        rows = []
        carry = torch.zeros_like(c[0])
        for i in range(LIMBS):
            v = c[i] + carry
            rows.append(v & MASK)
            carry = v >> RADIX
        rows[0] = rows[0] + WRAP_LO * carry
        rows[1] = rows[1] + WRAP_HI * carry
        return torch.stack(rows, dim=0)

    def fold_255(c):
        t = c[LIMBS - 1 :] >> 3
        return torch.cat([c[:1] + 19 * t, c[1 : LIMBS - 1], c[LIMBS - 1 :] & 7], dim=0)

    c = exact_carry(exact_carry(a))
    c = exact_carry(fold_255(c))
    c = exact_carry(fold_255(c))

    def sub_p(v):
        rows = []
        borrow = torch.zeros_like(v[0])
        for i in range(LIMBS):
            d = v[i] - env.p_limbs[i] - borrow
            rows.append(d & MASK)
            borrow = (d < 0).to(v.dtype)
        return torch.where(borrow == 0, torch.stack(rows, dim=0), v)

    return sub_p(sub_p(c))


def fe_eq(env, a, b):
    return (fe_canonical(env, a) == fe_canonical(env, b)).all(dim=0)


def fe_is_odd(env, a):
    return fe_canonical(env, a)[0] & 1


class Field12:
    """The plain field as an object for the point formulas: the functions
    above, with kernel G's constants (from its table, on the table's
    device) as (22, 1) columns that broadcast over lanes and the comb as
    (256, 3, 22)."""

    def __init__(self, table: torch.Tensor):
        vals = [words_to_int(r) for r in table.cpu().numpy()]
        dev = table.device

        def col(x):
            return torch.from_numpy(int_to_limbs12(x)[:, None]).to(dev)

        self.k2 = torch.from_numpy(K2[:, None].copy()).to(dev)
        self.p_limbs = col(P)
        self.d = col(vals[ROW_D])
        self.d2 = col(vals[ROW_D2])
        self.sqrt_m1 = col(vals[ROW_SQRT_M1])
        comb = np.stack([int_to_limbs12(v) for v in vals[ROW_COMB:]]).reshape(256, 3, LIMBS)
        self.comb = torch.from_numpy(comb).to(dev)

    def mul(self, a, b):
        return fe_mul(a, b)

    def sq(self, a):
        return fe_sq(a)

    def add(self, a, b):
        return fe_add(a, b)

    def sub(self, a, b):
        return fe_sub(self, a, b)

    def neg(self, a):
        return fe_neg(self, a)

    def mul2(self, a):
        return fe_mul_small(a, 2)

    def carry1(self, a):
        return fe_carry1(a)

    def eq(self, a, b):
        return fe_eq(self, a, b)

    def is_odd(self, a):
        return fe_is_odd(self, a)

    def canonical(self, a):
        return fe_canonical(self, a)

    def inv(self, a):
        return pow_p_minus_2(a, self.sq, self.mul)

    def pow_sqrt(self, a):
        return pow_p_minus_5_over_8(a, self.sq, self.mul)


# ------------------------------------------------- the plain points
# Extended twisted-Edwards (X : Y : Z : T), the reference's formulas with
# its lazy-bound carries; csrc/ed25519_ladder.cuh spells out the same
# sequence (its field carries or reduces inside every operation).


def _one(lanes, like):
    one = torch.zeros((LIMBS, lanes), dtype=torch.int32, device=like.device)
    one[0] = 1
    return one


def identity_point(lanes, like):
    zero = torch.zeros((LIMBS, lanes), dtype=torch.int32, device=like.device)
    one = _one(lanes, like)
    return (zero, one, one, zero)


def point_double(F, p, want_t: bool = True):
    """dbl-2008-hwcd; never reads T, and skips T3 unless ``want_t``."""
    px, py, pz, _ = p
    a = F.sq(px)
    b = F.sq(py)
    c = F.mul2(F.sq(pz))
    h = F.add(a, b)
    e = F.sub(h, F.sq(F.add(px, py)))
    g = F.sub(a, b)
    f = F.carry1(F.add(c, g))
    t = F.mul(e, h) if want_t else p[3]
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def _add_tail(F, a, bb, c, d):
    e = F.sub(bb, a)
    f = F.sub(d, c)
    g = F.carry1(F.add(d, c))
    h = F.add(bb, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def point_add(F, p, q):
    """Unified add (9 multiplies), both points in (X, Y, Z, T)."""
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = F.mul(F.sub(py, px), F.sub(qy, qx))
    bb = F.mul(F.add(py, px), F.add(qy, qx))
    c = F.mul(F.mul(pt, F.d2), qt)
    d = F.mul2(F.mul(pz, qz))
    return _add_tail(F, a, bb, c, d)


def to_planes(F, p):
    """(X, Y, Z, T) -> (Y - X, Y + X, 2dT, 2Z), for repeated use as an addend."""
    px, py, pz, pt = p
    return (F.sub(py, px), F.add(py, px), F.mul(pt, F.d2), F.mul2(pz))


def add_q_planes(F, p, planes):
    ymx, ypx, t2d, z2 = planes
    px, py, pz, pt = p
    a = F.mul(F.sub(py, px), ymx)
    bb = F.mul(F.add(py, px), ypx)
    return _add_tail(F, a, bb, F.mul(pt, t2d), F.mul(pz, z2))


def add_b_entry(F, p, entry):
    """Mixed add of an affine table entry (y - x, y + x, 2dxy): 7 multiplies."""
    ymx, ypx, t2d = entry
    px, py, pz, pt = p
    a = F.mul(F.sub(py, px), ymx)
    bb = F.mul(F.add(py, px), ypx)
    return _add_tail(F, a, bb, F.mul(pt, t2d), F.mul2(pz))


def point_neg(F, p):
    px, py, pz, pt = p
    return (F.neg(px), py, pz, F.neg(pt))


def decompress(F, y, sign_row):
    """y limbs (< p, checked on the host) + x-parity bit -> (point, ok);
    no square root, or x = 0 with sign 1, reads not ok."""
    one = _one(y.shape[1], y)
    y2 = F.sq(y)
    u = F.sub(y2, one)
    v = F.carry1(F.add(F.mul(F.d, y2), one))
    v3 = F.mul(F.sq(v), v)
    v7 = F.mul(F.sq(v3), v)
    x = F.mul(F.mul(u, v3), F.pow_sqrt(F.mul(u, v7)))
    vx2 = F.mul(v, F.sq(x))
    root_ok = F.eq(vx2, u)
    flip_ok = F.eq(vx2, F.neg(u))
    x = torch.where(flip_ok[None, :], F.mul(x, F.sqrt_m1), x)
    ok = root_ok | flip_ok
    x_is_zero = F.eq(x, torch.zeros_like(x))
    ok = ok & ~(x_is_zero & (sign_row == 1))
    x = torch.where((F.is_odd(x) != sign_row)[None, :], F.neg(x), x)
    return (x, y, one, F.mul(x, y)), ok


def compress_y_parity(F, p):
    """Point -> (canonical y limbs, parity of x)."""
    px, py, pz, _ = p
    zinv = F.inv(pz)
    x = F.canonical(F.mul(px, zinv))
    y = F.canonical(F.mul(py, zinv))
    return y, x[0] & 1


def minus_a_table(F, minus_a):
    """k * (-A), k = 0..15, in plane form: doublings on even k, adds on
    odd k."""
    lanes = minus_a[0].shape[1]
    pts = [identity_point(lanes, minus_a[0]), minus_a]
    for k in range(2, 16):
        if k % 2 == 0:
            pts.append(point_double(F, pts[k // 2]))
        else:
            pts.append(point_add(F, pts[k - 1], minus_a))
    return [to_planes(F, pt) for pt in pts]


def bytes_to_limb12(x_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 -> (22, B) int32 radix-4096 limbs (limb 21 holds
    bits 252..255)."""
    xb = x_bytes.to(torch.int32)
    rows = []
    for k in range(LIMBS):
        if k == LIMBS - 1:
            rows.append(xb[:, 31] >> 4)
        elif k % 2 == 0:
            j = 3 * k // 2
            rows.append(xb[:, j] | ((xb[:, j + 1] & 0xF) << 8))
        else:
            j = (3 * k - 1) // 2
            rows.append((xb[:, j] >> 4) | (xb[:, j + 1] << 4))
    return torch.stack(rows, dim=0)


def cofactored_end(F, acc, r_y, r_sign):
    """The cofactored rule's end, as kernel G runs it: R decompressed, -R
    added in plane form, three doublings -> (8 (acc - R) is the identity,
    R decodes)."""
    r_pt, r_ok = decompress(F, r_y, r_sign)
    acc = add_q_planes(F, acc, to_planes(F, point_neg(F, r_pt)))
    for _ in range(3):
        acc = point_double(F, acc)
    x, y, z, _t = acc
    return F.eq(x, torch.zeros_like(x)) & F.eq(y, z), r_ok


def _ladder(F, packed, h_win, fixed_win: int, cofactored: bool = False):
    lanes = packed.shape[0]
    pk = packed[:, 32:64]
    y_bytes = pk.clone()
    y_bytes[:, 31] &= 0x7F
    sign = (pk[:, 31] >> 7).to(torch.int32)
    r12 = bytes_to_limb12(packed[:, :32])
    s_bytes = packed[:, 128:160].to(torch.int64)
    precheck = packed[:, 160] == 1

    a_pt, a_ok = decompress(F, bytes_to_limb12(y_bytes), sign)
    planes = torch.stack(
        [torch.stack(p, dim=0) for p in minus_a_table(F, point_neg(F, a_pt))], dim=0
    )  # (16, 4, 22, B)
    lane_idx = torch.arange(lanes, device=packed.device)
    acc = identity_point(lanes, packed)
    for w in range(WINDOWS - 1, -1, -1):
        for i in range(4):
            acc = point_double(F, acc, want_t=(i == 3))
        if fixed_win == 8:
            # the comb entry of s's byte w/2 = window w + 16 * window w+1
            if w % 2 == 0:
                entry = F.comb[s_bytes[:, w // 2]].permute(1, 2, 0)
                acc = add_b_entry(F, acc, tuple(entry))
        else:
            digit = (s_bytes[:, w // 2] >> (4 * (w % 2))) & 15
            acc = add_b_entry(F, acc, tuple(F.comb[digit].permute(1, 2, 0)))
        sel = planes[h_win[w].long(), :, :, lane_idx].permute(1, 2, 0)
        acc = add_q_planes(F, acc, tuple(sel))
    r_y = torch.cat([r12[: LIMBS - 1], r12[LIMBS - 1 :] & 7], dim=0)
    r_sign = (r12[LIMBS - 1] >> 3) & 1
    if cofactored:
        ok, r_ok = cofactored_end(F, acc, r_y, r_sign)
        return a_ok & r_ok & ok & precheck
    enc_y, enc_parity = compress_y_parity(F, acc)
    match = (enc_y == r_y).all(dim=0) & (enc_parity == r_sign)
    return a_ok & match & precheck


def verify_plain_g(packed: torch.Tensor, h_win: torch.Tensor, table: torch.Tensor,
                   fixed_win: int = 8, cofactored: bool = False) -> torch.Tensor:
    """Plain version of kernel G: (B, 161) uint8 + (64, B) int32 windows of
    h + G's constant table -> (B,) bool verdicts, with the comb
    (``fixed_win=8``) or the 16-entry window (``fixed_win=4``), and the
    cofactored end of full buckets (``cofactored``) or the encoding
    compare."""
    if fixed_win not in FIXED_WINS:
        raise ValueError(f"fixed_win must be 8 or 4, not {fixed_win}")
    return _ladder(Field12(table), packed, h_win, fixed_win, cofactored)


# ---------------------------------------------- operation count (bounds)


class _CountingField(Field12):
    """The plain field, counting the field operations the ladder performs:
    multiplies, squarings, add-class operations (add, subtract, negate,
    double) and equality tests. Carry passes and canonical forms are the
    TPU limbs' bookkeeping and cost nothing in kernel G's field, whose
    values stay canonical."""

    def __init__(self, table):
        super().__init__(table)
        self.n = {"mul": 0, "sq": 0, "add": 0, "eq": 0}

    def mul(self, a, b):
        self.n["mul"] += 1
        return super().mul(a, b)

    def sq(self, a):
        self.n["sq"] += 1
        return super().sq(a)

    def add(self, a, b):
        self.n["add"] += 1
        return super().add(a, b)

    def sub(self, a, b):
        self.n["add"] += 1
        return super().sub(a, b)

    def neg(self, a):
        self.n["add"] += 1
        return super().neg(a)

    def mul2(self, a):
        self.n["add"] += 1
        return super().mul2(a)

    def eq(self, a, b):
        self.n["eq"] += 1
        return super().eq(a, b)


@functools.lru_cache(maxsize=2)
def field_ops_per_verify(fixed_win: int) -> dict:
    """Field operations of one lane's verify in kernel G's schedule, counted
    by running the plain ladder over one lane with a counting field."""
    F = _CountingField(torch.from_numpy(build_table()))
    _ladder(F, torch.zeros((1, 161), dtype=torch.uint8),
            torch.zeros((WINDOWS, 1), dtype=torch.int32), fixed_win)
    return dict(F.n)


# ---------------------------------------------------------------- wrappers


def check_inputs(packed, h_win, table) -> None:
    check_packed(packed)
    lanes = packed.shape[0]
    if h_win.dtype != torch.int32 or tuple(h_win.shape) != (WINDOWS, lanes) or \
            not h_win.is_contiguous():
        raise ValueError(f"h windows must be contiguous (64, {lanes}) int32")
    if table.dtype != torch.int32 or tuple(table.shape) != (TABLE_ROWS, 8) or \
            not table.is_contiguous():
        raise ValueError(f"table must be contiguous ({TABLE_ROWS}, 8) int32")
    if not (packed.device == h_win.device == table.device):
        raise ValueError("packed, h windows and table must share a device")


def _verify(fixed_win: int, wrapper, packed, h_win, table, cofactored) -> torch.Tensor:
    check_inputs(packed, h_win, table)
    if packed.device.type == "cpu":
        return verify_plain_g(packed, h_win, table, fixed_win, cofactored)
    _build.require_cuda(packed)
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=packed.device)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(packed.device):
        rc = lib.ct_ed25519_verify_g(
            packed.data_ptr(), h_win.data_ptr(), table.data_ptr(), out.data_ptr(), n,
            fixed_win, int(cofactored), _build.stream_of(packed),
        )
    _build.check_launch(rc, wrapper.__name__)
    _build.count_launch(wrapper)
    return out


def ed25519_verify_g8(packed: torch.Tensor, h_win: torch.Tensor,
                      table: torch.Tensor, cofactored: bool = False) -> torch.Tensor:
    """(B,) bool verdicts with the 8-bit comb, under the cofactored rule of
    full buckets when ``cofactored``. Launches kernel G on the current
    stream for CUDA tensors, runs the plain version for CPU tensors."""
    return _verify(8, ed25519_verify_g8, packed, h_win, table, cofactored)


def ed25519_verify_g4(packed: torch.Tensor, h_win: torch.Tensor,
                      table: torch.Tensor, cofactored: bool = False) -> torch.Tensor:
    """(B,) bool verdicts with the 16-entry window; as ``ed25519_verify_g8``."""
    return _verify(4, ed25519_verify_g4, packed, h_win, table, cofactored)


ed25519_verify_g8.launches = 0
ed25519_verify_g4.launches = 0
VERIFY_G = {8: ed25519_verify_g8, 4: ed25519_verify_g4}
