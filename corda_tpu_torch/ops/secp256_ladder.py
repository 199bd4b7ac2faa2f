"""The ECDSA verify ladder: kernel F, its constant table and its plain version.

Counterpart of corda_tpu/ops/secp256_pallas.py: the complete RCB16 point
formulas (``point_add`` :935, ``point_double`` :967), the on-curve check
(:996), the 8-bit G comb (``_g_comb_host`` :98) and the per-block verify
(``_verify_block`` :1028) that ``_make_kernel`` (:1120) runs.

What one lane computes, for the curve of its bucket:

- Q = (qx, qy) must be on the curve;
- the 16-entry table k*Q (7 doublings, 7 additions);
- R = u1*G + u2*Q by an MSB-first walk of 64 four-bit windows: 4
  doublings a window, a Q-table add every window, and on even windows w
  the G comb entry of digit u1[w] + 16*u1[w+1] (byte w/2 of u1);
- accept iff precheck, Z != 0 and (X == r*Z or (rb_ok and X == (r+n)*Z)),
  the projective form of x(R) mod n == r.

The formulas are complete (no exceptional case for the identity, P == Q
or P == -Q); a = 0 folds away for secp256k1 and a = -3 is a small
multiple for secp256r1. The b3 products (3b * v) are one-word scalings
for secp256k1, whose 3b is 21, and full multiplies for secp256r1.

- ``build_table`` / ``ecdsa_table``: kernel F's constant table, (771, 8)
  int32 holding 32-bit words little-endian: p, b, 3b, then the 256 comb
  entries v*G as projective (X, Y, Z), Z = 1 except the identity (0, 1, 0).
- The plain version keeps field elements as 16 signed 16-bit limbs in
  int64, (16, B), reduced lazily: each product's 31 columns fold through
  the curve's 2^(16k) mod p rows (small signed coefficients, derived from
  the prime), then three carry passes wrap the top carry through 2^256 mod
  p. torch's uint32 has no shifts on the CPU, and 32-bit limbs' column sums
  would overflow int64, hence 16-bit limbs.
- ``ecdsa_verify_k1`` / ``ecdsa_verify_r1`` are the wrappers, one launch
  counter each: kernel F (csrc/ecdsa_verify.cu) for CUDA tensors, the
  plain version for CPU tensors.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..crypto.ecdsa_host import CURVES, _batch_affine, _jac_add
from . import _build

CURVE_IDS = {"secp256k1": 0, "secp256r1": 1}

# the packed verify plane, one row of bytes a lane: qx, qy, u1, u2, r,
# r + n (32 bytes each, little-endian), rb_ok, precheck
ECDSA_ROW = 194
COL_QX, COL_QY, COL_U1, COL_U2, COL_RA, COL_RB = 0, 32, 64, 96, 128, 160
COL_RB_OK, COL_PRE = 192, 193
WINDOWS = 64

ROW_P, ROW_B, ROW_B3, ROW_COMB = 0, 1, 2, 3
TABLE_ROWS = 3 + 3 * 256

# ----------------------------------------------------------- the table


@functools.lru_cache(maxsize=2)
def g_comb_host(curve_name: str) -> tuple:
    """Projective rows v*G for v = 0..255: (0, 1, 0), then the affine
    multiples with Z = 1 (successive additions of G, one batched
    inversion)."""
    cv = CURVES[curve_name]
    pts = [(cv.gx, cv.gy, 1)]
    for _ in range(254):
        pts.append(_jac_add(cv, pts[-1], pts[0]))
    return ((0, 1, 0),) + tuple((x, y, 1) for x, y in _batch_affine(cv, pts))


def int_to_words(x: int) -> np.ndarray:
    """x < 2^256 -> 8 little-endian 32-bit words, as int32 bits."""
    return np.frombuffer(x.to_bytes(32, "little"), dtype="<i4").copy()


def words_to_int(words) -> int:
    return int.from_bytes(np.asarray(words, dtype="<i4").tobytes(), "little")


@functools.lru_cache(maxsize=2)
def _table_host(curve_name: str) -> np.ndarray:
    cv = CURVES[curve_name]
    rows = [int_to_words(cv.p), int_to_words(cv.b % cv.p), int_to_words(3 * cv.b % cv.p)]
    for entry in g_comb_host(curve_name):
        rows.extend(int_to_words(c) for c in entry)
    table = np.stack(rows)
    table.setflags(write=False)
    return table


def build_table(curve_name: str) -> np.ndarray:
    """The (771, 8) int32 constant table of kernel F for one curve."""
    return _table_host(curve_name).copy()


_tables: dict = {}
_tables_lock = threading.Lock()


def ecdsa_table(curve_name: str, device) -> torch.Tensor:
    """The curve's constant table on ``device`` (built once per device)."""
    key = (curve_name, str(device))
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            t = torch.from_numpy(build_table(curve_name)).to(device)
            _tables[key] = t
        return t


# ------------------------------------------------ the complete formulas
# Written once over a field object F (mul, sq, add, sub, mul_small,
# mul_a, mul_b3, a_zero, b), so the plain version and the op count share
# them; csrc/ecdsa_ladder.cuh spells out the same sequence.


def point_add(F, p1, p2):
    """RCB16 Algorithm 1 (the reference's ``point_add``)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    t0 = F.mul(x1, x2)
    t1 = F.mul(y1, y2)
    t2 = F.mul(z1, z2)
    t3 = F.sub(F.mul(F.add(x1, y1), F.add(x2, y2)), F.add(t0, t1))
    t4 = F.sub(F.mul(F.add(x1, z1), F.add(x2, z2)), F.add(t0, t2))
    t5 = F.sub(F.mul(F.add(y1, z1), F.add(y2, z2)), F.add(t1, t2))
    z3 = F.mul_b3(t2)
    if not F.a_zero:
        z3 = F.add(z3, F.mul_a(t4))
    x3 = F.sub(t1, z3)
    z3 = F.add(t1, z3)
    y3 = F.mul(x3, z3)
    t1 = F.add(F.add(t0, t0), t0)
    t4 = F.mul_b3(t4)
    if not F.a_zero:
        t2a = F.mul_a(t2)
        t1 = F.add(t1, t2a)
        t4 = F.add(t4, F.mul_a(F.sub(t0, t2a)))
    y3 = F.add(y3, F.mul(t1, t4))
    x3 = F.sub(F.mul(x3, t3), F.mul(t5, t4))
    z3 = F.add(F.mul(t5, z3), F.mul(t3, t1))
    return (x3, y3, z3)


def point_double(F, p):
    """RCB16 Algorithm 3 (the reference's ``point_double``)."""
    x, y, z = p
    t0 = F.sq(x)
    t1 = F.sq(y)
    t2 = F.sq(z)
    t3 = F.mul_small(F.mul(x, y), 2)
    z3 = F.mul_small(F.mul(x, z), 2)
    y3 = F.mul_b3(t2)
    if not F.a_zero:
        y3 = F.add(y3, F.mul_a(z3))
    x3 = F.sub(t1, y3)
    y3 = F.add(t1, y3)
    y3 = F.mul(x3, y3)
    x3 = F.mul(t3, x3)
    z3 = F.mul_b3(z3)
    if F.a_zero:
        t3 = z3
        t0 = F.mul_small(t0, 3)
    else:
        t2a = F.mul_a(t2)
        t3 = F.add(F.mul_a(F.sub(t0, t2a)), z3)
        t0 = F.add(F.mul_small(t0, 3), t2a)
    y3 = F.add(y3, F.mul(t0, t3))
    t2 = F.mul_small(F.mul(y, z), 2)
    x3 = F.sub(x3, F.mul(t2, t3))
    z3 = F.mul_small(F.mul(t2, t1), 4)
    return (x3, y3, z3)


def on_curve_diff(F, x, y):
    """y^2 - (x^3 + a*x + b), zero iff (x, y) is on the curve."""
    rhs = F.add(F.mul(F.sq(x), x), F.b)
    if not F.a_zero:
        rhs = F.add(rhs, F.mul_a(x))
    return F.sub(F.sq(y), rhs)


# ---------------------------------------------- operation count (bounds)


class _CountingField:
    """Counts the field operations of the formulas (values are ignored)."""

    def __init__(self, a_zero: bool):
        self.a_zero = a_zero
        self.b = None
        self.n = {"mul": 0, "sq": 0, "add": 0, "mul_b3": 0}

    def mul(self, _x, _y):
        self.n["mul"] += 1

    def sq(self, _x):
        self.n["sq"] += 1

    def add(self, _x, _y):
        self.n["add"] += 1

    sub = add

    def mul_small(self, _x, k):  # x2 one add, x3 two, x4 two doublings
        self.n["add"] += {2: 1, 3: 2, 4: 2}[k]

    def mul_a(self, _x):  # -3v: v + v + v, then a negation
        self.n["add"] += 3

    def mul_b3(self, _x):
        self.n["mul_b3"] += 1


def field_ops_per_verify(curve_name: str) -> dict:
    """Field multiplies, squarings, b3 products and add-class operations
    of one lane that runs the ladder: the on-curve check, the Q table (7
    doublings, 7 additions), 256 doublings, 64 Q-table and 32 comb
    additions, and both accept compares (two multiplies, two
    subtractions)."""
    F = _CountingField(CURVES[curve_name].a == 0)
    on_curve_diff(F, None, None)
    pt = (None, None, None)
    for _ in range(7 + 256):
        point_double(F, pt)
    for _ in range(7 + 64 + 32):
        point_add(F, pt, pt)
    F.n["mul"] += 2
    F.n["add"] += 2
    return dict(F.n)


# The fewest 32-bit integer operations of one field operation on 8 x
# 32-bit limbs, for kernel F's bound: a product of 32 x 32 -> 64 bits is
# two multiply-adds, so a multiply is 64 products (128) and a squaring 36
# (72) plus doubling the cross terms (16); each then reduces:
# - secp256k1, 2^256 = 2^32 + 977: the high half times 977 (8 products,
#   16), one three-input add a word (8), the top carry's fold (4) and the
#   conditional subtraction of p (8 subtractions, 8 selects) = 44;
# - secp256r1, FIPS 186-4 D.2.3: 52 signed word terms in 64-bit sums
#   (52 three-input adds over 32-bit halves), the carry chain (8), the top
#   carry's fold (8) and the conditional subtraction (16) = 84.
# A b3 product is a multiply for secp256r1, whose 3b is full width; for
# secp256k1, 3b = 21 is one word: 8 products (16), the top word's fold
# through 2^32 + 977 with its carry through the words (8) and the
# conditional subtraction (16) = 40. An add or subtract mod p is 8 adds
# with carry, 8 subtractions with borrow and 8 selects (24).
INT_OPS_PER_MUL = 128
INT_OPS_PER_SQ = 72 + 16
INT_OPS_PER_REDUCE = {"secp256k1": 44, "secp256r1": 84}
INT_OPS_PER_MUL_B3 = {"secp256k1": 40,
                      "secp256r1": INT_OPS_PER_MUL + INT_OPS_PER_REDUCE["secp256r1"]}
INT_OPS_PER_ADD = 24


def int_ops_per_verify(curve_name: str) -> int:
    n = field_ops_per_verify(curve_name)
    red = INT_OPS_PER_REDUCE[curve_name]
    return (n["mul"] * (INT_OPS_PER_MUL + red) + n["sq"] * (INT_OPS_PER_SQ + red)
            + n["mul_b3"] * INT_OPS_PER_MUL_B3[curve_name] + n["add"] * INT_OPS_PER_ADD)


# ------------------------------------------------- the plain 16 x 16 field

LIMBS = 16
RADIX = 16
MASK = (1 << RADIX) - 1


def _signed_digits(v: int, n: int = LIMBS) -> list[int]:
    """v as balanced signed radix-2^16 digits (|digit| <= 2^15)."""
    out = []
    for _ in range(n):
        d = v & MASK
        if d >= 1 << (RADIX - 1):
            d -= 1 << RADIX
        out.append(d)
        v = (v - d) >> RADIX
    assert v == 0
    return out


def int_to_limbs16(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(LIMBS)], dtype=np.int64)


def limbs16_to_int(limbs) -> int:
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(limbs)))


@functools.lru_cache(maxsize=2)
def _fold_constants(curve_name: str):
    """(wrap, fold): the signed digits of 2^256 mod p, and for each column
    k = 16..30 of a product a sparse combination of limbs 0..15 congruent
    to 2^(16k) (the wrap applied until no index reaches 16)."""
    p = CURVES[curve_name].p
    top = {j: d for j, d in enumerate(_signed_digits(2**256 % p)) if d}
    fold = np.zeros((LIMBS - 1, LIMBS), dtype=np.int64)
    for k in range(LIMBS, 2 * LIMBS - 1):
        vec = {k: 1}
        while any(j >= LIMBS for j in vec):
            j = max(vec)
            c = vec.pop(j)
            for tj, td in top.items():
                vec[j - LIMBS + tj] = vec.get(j - LIMBS + tj, 0) + c * td
            vec = {i: c for i, c in vec.items() if c}
        for i, c in vec.items():
            fold[k - LIMBS, i] = c
    wrap = np.zeros(LIMBS, dtype=np.int64)
    for j, d in top.items():
        wrap[j] = d
    return wrap, fold


class TorchField:
    """GF(p) on (16, B) int64 limb planes (lazy: |limb| < 2^17 between
    operations, any value congruent mod p); constants are (16, 1) columns
    that broadcast over lanes."""

    def __init__(self, curve_name: str, device, b: int, b3: int):
        cv = CURVES[curve_name]
        wrap, fold = _fold_constants(curve_name)
        self.a_zero = cv.a == 0
        self.device = torch.device(device)

        def col(x):
            return torch.from_numpy(int_to_limbs16(x)[:, None].copy()).to(device)

        self.wrap = torch.from_numpy(wrap[:, None].copy()).to(device)
        self.fold = torch.from_numpy(fold[:, :, None].copy()).to(device)
        self.p_limbs = col(cv.p)
        self.b = col(b)
        self.b3 = col(b3)
        # a 3b below 32 scales with one carry pass: the top carry is then
        # under 64, and 64 * 977 keeps limb 0 below 2^17 (secp256k1's 21)
        self.b3_small = b3 if b3 < 32 else None

    def _carry_pass(self, c):
        q = c >> RADIX
        r = c & MASK
        return r + torch.cat([torch.zeros_like(q[:1]), q[:-1]], dim=0) + self.wrap * q[-1:]

    def carry(self, c, passes: int = 1):
        for _ in range(passes):
            c = self._carry_pass(c)
        return c

    def mul(self, a, b):
        """Schoolbook into 31 columns (skewing the product matrix), the
        columns 16..30 folded onto 0..15, three carry passes."""
        prod = a[:, None, :] * b[None, :, :]
        n = LIMBS
        lanes = prod.shape[2]
        pad = torch.zeros((n, n + 1, lanes), dtype=prod.dtype, device=prod.device)
        skew = torch.cat([prod, pad], dim=1).reshape(n * (2 * n + 1), lanes)
        cols = skew[: 2 * n * n].reshape(n, 2 * n, lanes).sum(0)
        out = cols[:n] + (self.fold * cols[n : 2 * n - 1, None, :]).sum(0)
        return self.carry(out, 3)

    def sq(self, a):
        return self.mul(a, a)

    def add(self, a, b):
        return self.carry(a + b)

    def sub(self, a, b):
        return self.carry(a - b)

    def mul_small(self, a, k: int):
        return self.carry(a * k)

    def mul_a(self, v):  # a = -3
        return self.carry(v * -3)

    def mul_b3(self, v):
        """3b * v: one scaling where 3b is small (secp256k1's 21)."""
        if self.b3_small is not None:
            return self.carry(v * self.b3_small)
        return self.mul(self.b3, v)

    def canonical(self, a):
        """Exact reduction: limbs in [0, 2^16), value in [0, p)."""
        c = a
        for _ in range(4):
            rows = []
            carry = torch.zeros_like(c[0])
            for i in range(LIMBS):
                v = c[i] + carry
                rows.append(v & MASK)
                carry = v >> RADIX
            c = torch.stack(rows, dim=0) + self.wrap * carry[None, :]
        rows = []
        borrow = torch.zeros_like(c[0])
        for i in range(LIMBS):
            d = c[i] - self.p_limbs[i] - borrow
            rows.append(d & MASK)
            borrow = (d < 0).to(c.dtype)
        return torch.where(borrow[None, :] == 0, torch.stack(rows, dim=0), c)

    def is_zero(self, a):
        return (self.canonical(a) == 0).all(dim=0)


def bytes_to_limbs16(x_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 little-endian -> (16, B) int64 limbs."""
    xb = x_bytes.to(torch.int64)
    return (xb[:, 0::2] + (xb[:, 1::2] << 8)).T.contiguous()


def verify_plain(curve_name: str, packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F: (B, 194) uint8 plane + the curve's table
    -> (B,) bool verdicts."""
    rows = table.cpu().numpy()
    F = TorchField(curve_name, packed.device, words_to_int(rows[ROW_B]),
                   words_to_int(rows[ROW_B3]))
    comb = np.stack([int_to_limbs16(words_to_int(r)) for r in rows[ROW_COMB:]])
    comb = torch.from_numpy(comb.reshape(256, 3, LIMBS)).to(packed.device)
    lanes = packed.shape[0]

    def limbs(col):
        return bytes_to_limbs16(packed[:, col : col + 32])

    qx, qy = limbs(COL_QX), limbs(COL_QY)
    one = torch.zeros_like(qx)
    one[0] = 1
    zero = torch.zeros_like(qx)
    ident = (zero, one, zero)
    q = (qx, qy, one)
    q_ok = F.is_zero(on_curve_diff(F, qx, qy))

    pts = [ident, q]
    for k in range(2, 16):
        pts.append(point_double(F, pts[k // 2]) if k % 2 == 0 else point_add(F, pts[k - 1], q))
    q_table = torch.stack([torch.stack(pt, dim=0) for pt in pts], dim=0)  # (16, 3, 16, B)

    u1 = packed[:, COL_U1 : COL_U1 + 32].to(torch.int64)
    u2 = packed[:, COL_U2 : COL_U2 + 32].to(torch.int64)
    lane_idx = torch.arange(lanes, device=packed.device)
    acc = ident
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = point_double(F, acc)
        if w % 2 == 0:
            entry = comb[u1[:, w // 2]].permute(1, 2, 0)
            acc = point_add(F, acc, tuple(entry))
        digit = (u2[:, w // 2] >> (4 * (w & 1))) & 15
        sel = q_table[digit, :, :, lane_idx].permute(1, 2, 0)
        acc = point_add(F, acc, tuple(sel))

    x, _y, z = acc
    nonzero = ~F.is_zero(z)
    match = F.is_zero(F.sub(x, F.mul(limbs(COL_RA), z)))
    rb_ok = packed[:, COL_RB_OK] == 1
    match |= rb_ok & F.is_zero(F.sub(x, F.mul(limbs(COL_RB), z)))
    return (packed[:, COL_PRE] == 1) & q_ok & nonzero & match


# ---------------------------------------------------------------- wrappers


def check_inputs(packed: torch.Tensor, table: torch.Tensor) -> None:
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[1] != ECDSA_ROW \
            or not packed.is_contiguous():
        raise ValueError(f"packed must be a contiguous (B, {ECDSA_ROW}) uint8 plane")
    if table.dtype != torch.int32 or tuple(table.shape) != (TABLE_ROWS, 8) or \
            not table.is_contiguous():
        raise ValueError(f"table must be contiguous ({TABLE_ROWS}, 8) int32")
    if packed.device != table.device:
        raise ValueError("packed and table must share a device")


def _verify(curve_name: str, wrapper, packed: torch.Tensor,
            table: torch.Tensor) -> torch.Tensor:
    check_inputs(packed, table)
    if packed.device.type == "cpu":
        return verify_plain(curve_name, packed, table)
    _build.require_cuda(packed)
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=packed.device)
    if n == 0:
        return out
    lib = _build.kernels()
    launch = lib.ct_ecdsa_verify_k1 if curve_name == "secp256k1" else lib.ct_ecdsa_verify_r1
    with torch.cuda.device(packed.device):
        rc = launch(packed.data_ptr(), table.data_ptr(), out.data_ptr(), n,
                    _build.stream_of(packed))
    _build.check_launch(rc, wrapper.__name__)
    _build.count_launch(wrapper)
    return out


def ecdsa_verify_k1(packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B,) bool secp256k1 verdicts. Launches kernel F on the current
    stream for CUDA tensors, runs the plain version for CPU tensors."""
    return _verify("secp256k1", ecdsa_verify_k1, packed, table)


def ecdsa_verify_r1(packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B,) bool secp256r1 verdicts; as ``ecdsa_verify_k1``."""
    return _verify("secp256r1", ecdsa_verify_r1, packed, table)


ecdsa_verify_k1.launches = 0
ecdsa_verify_r1.launches = 0
VERIFY = {"secp256k1": ecdsa_verify_k1, "secp256r1": ecdsa_verify_r1}
