"""The ed25519 verify ladder: kernel B, its constant table and its plain version.

Counterpart of corda_tpu/ops/ed25519_pallas13.py:60-461 (field, points,
``decompress`` :359, ``compress_y_parity`` :378, the kernel :388, for both
of its fixed-base shapes: the 8-bit comb, ``fixed_win=8``, one mixed add on
every even window with the digit s[k] + 16 s[k+1], and the 16-entry window,
``fixed_win=4``, one mixed add every window), the comb table of
corda_tpu/ops/ed25519_pallas.py:130 (``_b_comb_host``) and its window
layout (``bytes_to_windows_t`` :626).

- ``build_table`` / ``ladder_table``: the constant table kernel B reads, in
  the kernel's field representation (ref10's ten 26/25-bit limbs): d, 2d,
  sqrt(-1) and the 256-entry comb v*B as (y - x, y + x, 2dxy).
- The plain version runs the reference's 20 x 13-bit int32 limb schedule
  (2^260 = 608 fold, one carry after each add) op for op, so it can be held
  limb for limb against the reference's eager functions; a torch int32
  ``>>`` is arithmetic like jnp's, so the signed carries agree. Table
  entries are gathered by index where the TPU kernel runs a select tree:
  the same values.
- ``ed25519_verify_ladder`` (the comb) and ``ed25519_verify_ladder_w4``
  (the 16-entry window, which reads the comb's first 16 entries) are the
  wrappers, each with its own launch counter, in ``VERIFY_B``: kernel B
  (csrc/ed25519_verify.cu) for CUDA tensors, the plain version for CPU
  tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from ..crypto.ed25519_host import BX, BY, D, P, SQRT_M1
from . import _build
from .addchain import (
    batch_modinv,
    pow_p_minus_2,
    pow_p_minus_5_over_8,
)
from .scalar25519 import WINDOWS, check_packed

LIMBS = 20
RADIX = 13
MASK = (1 << RADIX) - 1
WRAP = 608  # 2^260 mod p
D2 = (2 * D) % P

# ------------------------------------------------ the constant table


def _ext_add_host(p1, p2):
    """Extended-coordinate Edwards add over Python ints."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * D * t1 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


@functools.lru_cache(maxsize=1)
def b_comb_host(n: int = 256) -> tuple:
    """(y - x, y + x, 2d*x*y) mod p for v*B, v = 0..n-1 (v = 0 is the
    identity), normalised with one batched inversion."""
    b_ext = (BX, BY, 1, BX * BY % P)
    pts = [(0, 1, 1, 0)]
    for _ in range(n - 1):
        pts.append(_ext_add_host(pts[-1], b_ext))
    rows = []
    for (px, py, _pz, _pt), zi in zip(pts, batch_modinv([pt[2] for pt in pts], P)):
        x, y = px * zi % P, py * zi % P
        rows.append(((y - x) % P, (y + x) % P, 2 * D * x % P * y % P))
    return tuple(rows)


# kernel B's field: limb i at bit FE_OFFSETS[i], FE_WIDTHS[i] bits wide
FE_WIDTHS = [26 if i % 2 == 0 else 25 for i in range(10)]
FE_OFFSETS = [sum(FE_WIDTHS[:i]) for i in range(10)]

ROW_D, ROW_D2, ROW_SQRT_M1, ROW_COMB = 0, 1, 2, 3
TABLE_ROWS = 3 + 3 * 256


def int_to_fe10(x: int) -> list[int]:
    return [(x >> o) & ((1 << w) - 1) for o, w in zip(FE_OFFSETS, FE_WIDTHS)]


def fe10_to_int(limbs) -> int:
    return sum(int(v) << o for v, o in zip(limbs, FE_OFFSETS))


@functools.lru_cache(maxsize=1)
def _table_host() -> np.ndarray:
    rows = [int_to_fe10(D), int_to_fe10(D2), int_to_fe10(SQRT_M1)]
    for entry in b_comb_host(256):
        rows.extend(int_to_fe10(c) for c in entry)
    table = np.array(rows, dtype=np.int32)
    table.setflags(write=False)
    return table


def build_table() -> np.ndarray:
    """The (771, 10) int32 constant table of kernel B."""
    return _table_host().copy()


_tables: dict = {}
_tables_lock = threading.Lock()


def ladder_table(device) -> torch.Tensor:
    """The constant table on ``device`` (built once per device)."""
    key = str(device)
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            t = torch.from_numpy(build_table()).to(device)
            _tables[key] = t
        return t


# ------------------------------------------ the plain 20 x 13-bit field


def int_to_limbs13(x: int) -> np.ndarray:
    return np.array([(x >> (RADIX * i)) & MASK for i in range(LIMBS)], dtype=np.int32)


def limbs13_to_int(limbs) -> int:
    return sum(int(v) << (RADIX * i) for i, v in enumerate(np.asarray(limbs)))


def _k2_limbs() -> np.ndarray:
    """A multiple of p with every limb in [16384, 24575] (the reference's
    subtraction offset)."""
    base = 2 * 8192
    v = base * ((1 << 260) - 1) // MASK
    fix = (-v) % P
    return (int_to_limbs13(fix).astype(np.int64) + base).astype(np.int32)


K2 = _k2_limbs()
P13 = int_to_limbs13(P)


@dataclasses.dataclass
class Env:
    """Constants as (20, 1) int32 columns that broadcast over lanes, and
    the comb as (256, 3, 20)."""

    k2: torch.Tensor
    p_limbs: torch.Tensor
    d: torch.Tensor
    d2: torch.Tensor
    sqrt_m1: torch.Tensor
    comb: torch.Tensor


def env_from_table(table: torch.Tensor) -> Env:
    """The plain ladder's constants from kernel B's table (any device)."""
    rows = table.cpu().numpy()
    vals = [fe10_to_int(r) for r in rows]

    def col(x):
        return torch.from_numpy(int_to_limbs13(x)[:, None]).to(table.device)

    comb = np.stack([int_to_limbs13(v) for v in vals[ROW_COMB:]]).reshape(256, 3, LIMBS)
    return Env(
        k2=torch.from_numpy(K2[:, None].copy()).to(table.device),
        p_limbs=col(P), d=col(vals[ROW_D]), d2=col(vals[ROW_D2]),
        sqrt_m1=col(vals[ROW_SQRT_M1]),
        comb=torch.from_numpy(comb).to(table.device),
    )


def _carry_pass(c):
    q = c >> RADIX
    r = c - (q << RADIX)
    return r + torch.cat([WRAP * q[LIMBS - 1 :], q[: LIMBS - 1]], dim=0)


def _carry(c, passes):
    for _ in range(passes):
        c = _carry_pass(c)
    return c


def _fold_cols40(c):
    q = c >> RADIX
    r = c - (q << RADIX)
    c = r + torch.cat([torch.zeros_like(q[:1]), q[:-1]], dim=0)
    return _carry(c[:LIMBS] + WRAP * c[LIMBS:], 2)


def fe_mul(a, b):
    """Schoolbook into 40 columns (each column the sum over i + j = k of
    a_i b_j, laid out by skewing the product matrix), then the fold."""
    prod = a[:, None, :] * b[None, :, :]
    n, lanes = LIMBS, prod.shape[2]
    pad = torch.zeros((n, n + 1, lanes), dtype=prod.dtype, device=prod.device)
    skew = torch.cat([prod, pad], dim=1).reshape(n * (2 * n + 1), lanes)
    cols = skew[: 2 * n * n].reshape(n, 2 * n, lanes).sum(0, dtype=torch.int32)
    return _fold_cols40(cols)


def fe_sq(a):
    """The reference's dedicated squaring sums the same column values."""
    return fe_mul(a, a)


def fe_add(a, b):
    return _carry_pass(a + b)


def fe_sub(env, a, b):
    return _carry(a - b + env.k2, 2)


def fe_neg(env, a):
    return fe_sub(env, torch.zeros_like(a), a)


def fe_mul_small(a, k):
    if k != 2:
        raise ValueError("only x2 is supported")
    return _carry_pass(a + a)


def fe_inv_chain(a):
    return pow_p_minus_2(a, fe_sq, fe_mul)


def fe_pow_sqrt_chain(a):
    return pow_p_minus_5_over_8(a, fe_sq, fe_mul)


def fe_canonical(env, a):
    """Exact reduction: limbs in [0, 8191], value in [0, p)."""
    def exact_carry(c):
        rows = []
        carry = torch.zeros_like(c[0])
        for i in range(LIMBS):
            v = c[i] + carry
            rows.append(v & MASK)
            carry = v >> RADIX
        rows[0] = rows[0] + WRAP * carry
        return torch.stack(rows, dim=0)

    def fold_255(c):
        t = c[LIMBS - 1 :] >> 8
        return torch.cat([c[:1] + 19 * t, c[1 : LIMBS - 1], c[LIMBS - 1 :] & 255], dim=0)

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


# ------------------------------------------------- the plain points


def _one(lanes, like):
    one = torch.zeros((LIMBS, lanes), dtype=torch.int32, device=like.device)
    one[0] = 1
    return one


def identity_point(lanes, like):
    zero = torch.zeros((LIMBS, lanes), dtype=torch.int32, device=like.device)
    one = _one(lanes, like)
    return (zero, one, one, zero)


def point_double(env, p, want_t: bool = True):
    px, py, pz, _ = p
    a = fe_sq(px)
    b = fe_sq(py)
    c = fe_mul_small(fe_sq(pz), 2)
    h = fe_add(a, b)
    e = fe_sub(env, h, fe_sq(fe_add(px, py)))
    g = fe_sub(env, a, b)
    f = fe_add(c, g)
    t = fe_mul(e, h) if want_t else p[3]
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), t)


def _add_tail(env, a, bb, c, d):
    e = fe_sub(env, bb, a)
    f = fe_sub(env, d, c)
    g = fe_add(d, c)
    h = fe_add(bb, a)
    return (fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h))


def point_add(env, p, q):
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = fe_mul(fe_sub(env, py, px), fe_sub(env, qy, qx))
    bb = fe_mul(fe_add(py, px), fe_add(qy, qx))
    c = fe_mul(fe_mul(pt, env.d2), qt)
    d = fe_mul_small(fe_mul(pz, qz), 2)
    return _add_tail(env, a, bb, c, d)


def to_planes(env, p):
    px, py, pz, pt = p
    return (fe_sub(env, py, px), fe_add(py, px), fe_mul(pt, env.d2), fe_mul_small(pz, 2))


def add_q_planes(env, p, planes):
    ymx, ypx, t2d, z2 = planes
    px, py, pz, pt = p
    a = fe_mul(fe_sub(env, py, px), ymx)
    bb = fe_mul(fe_add(py, px), ypx)
    return _add_tail(env, a, bb, fe_mul(pt, t2d), fe_mul(pz, z2))


def add_b_entry(env, p, entry):
    ymx, ypx, t2d = entry
    px, py, pz, pt = p
    a = fe_mul(fe_sub(env, py, px), ymx)
    bb = fe_mul(fe_add(py, px), ypx)
    return _add_tail(env, a, bb, fe_mul(pt, t2d), fe_mul_small(pz, 2))


def point_neg(env, p):
    px, py, pz, pt = p
    return (fe_neg(env, px), py, pz, fe_neg(env, pt))


def decompress(env, y, sign_row):
    """y limbs (< p, checked on the host) + x-parity bit -> (point, ok);
    no square root, or x = 0 with sign 1, reads not ok."""
    one = _one(y.shape[1], y)
    y2 = fe_sq(y)
    u = fe_sub(env, y2, one)
    v = fe_add(fe_mul(env.d, y2), one)
    v3 = fe_mul(fe_sq(v), v)
    v7 = fe_mul(fe_sq(v3), v)
    x = fe_mul(fe_mul(u, v3), fe_pow_sqrt_chain(fe_mul(u, v7)))
    vx2 = fe_mul(v, fe_sq(x))
    root_ok = fe_eq(env, vx2, u)
    flip_ok = fe_eq(env, vx2, fe_neg(env, u))
    x = torch.where(flip_ok[None, :], fe_mul(x, env.sqrt_m1), x)
    ok = root_ok | flip_ok
    x_is_zero = fe_eq(env, x, torch.zeros_like(x))
    ok = ok & ~(x_is_zero & (sign_row == 1))
    x = torch.where((fe_is_odd(env, x) != sign_row)[None, :], fe_neg(env, x), x)
    return (x, y, one, fe_mul(x, y)), ok


def compress_y_parity(env, p):
    px, py, pz, _ = p
    zinv = fe_inv_chain(pz)
    x = fe_canonical(env, fe_mul(px, zinv))
    y = fe_canonical(env, fe_mul(py, zinv))
    return y, x[0] & 1


def minus_a_table(env, minus_a):
    """k * (-A), k = 0..15, in plane form: doublings on even k, adds on
    odd k."""
    lanes = minus_a[0].shape[1]
    pts = [identity_point(lanes, minus_a[0]), minus_a]
    for k in range(2, 16):
        if k % 2 == 0:
            pts.append(point_double(env, pts[k // 2]))
        else:
            pts.append(point_add(env, pts[k - 1], minus_a))
    return [to_planes(env, pt) for pt in pts]


def bytes_to_limb13(x_bytes: torch.Tensor) -> torch.Tensor:
    """(B, 32) uint8 -> (20, B) int32 radix-8192 limbs."""
    xb = x_bytes.to(torch.int32)
    rows = []
    for k in range(LIMBS):
        bit = RADIX * k
        j, sh = bit >> 3, bit & 7
        v = xb[:, j] >> sh
        if j + 1 < 32:
            v = v | (xb[:, j + 1] << (8 - sh))
        if sh > 3 and j + 2 < 32:
            v = v | (xb[:, j + 2] << (16 - sh))
        rows.append(v & MASK)
    return torch.stack(rows, dim=0)


FIXED_WINS = (8, 4)


def cofactored_end(env, acc, r_y, r_sign):
    """The cofactored rule's end, as kernel B runs it: R decompressed, -R
    added in plane form, three doublings -> (8 (acc - R) is the identity,
    R decodes)."""
    r_pt, r_ok = decompress(env, r_y, r_sign)
    acc = add_q_planes(env, acc, to_planes(env, point_neg(env, r_pt)))
    for _ in range(3):
        acc = point_double(env, acc)
    x, y, z, _t = acc
    return fe_eq(env, x, torch.zeros_like(x)) & fe_eq(env, y, z), r_ok


def verify_ladder_plain(packed: torch.Tensor, h_win: torch.Tensor,
                        table: torch.Tensor, fixed_win: int = 8,
                        cofactored: bool = False) -> torch.Tensor:
    """Plain version of kernel B: (B, 161) uint8 + (64, B) int32 windows
    of h + the constant table -> (B,) bool verdicts, with the comb
    (``fixed_win=8``) or the 16-entry window (``fixed_win=4``), and the
    cofactored end of full buckets (``cofactored``) or the encoding
    compare."""
    if fixed_win not in FIXED_WINS:
        raise ValueError(f"fixed_win must be 8 or 4, not {fixed_win}")
    env = env_from_table(table)
    lanes = packed.shape[0]
    pk = packed[:, 32:64]
    y_bytes = pk.clone()
    y_bytes[:, 31] &= 0x7F
    sign = (pk[:, 31] >> 7).to(torch.int32)
    r13 = bytes_to_limb13(packed[:, :32])
    s_bytes = packed[:, 128:160].to(torch.int64)
    precheck = packed[:, 160] == 1

    a_pt, a_ok = decompress(env, bytes_to_limb13(y_bytes), sign)
    planes = torch.stack(
        [torch.stack(p, dim=0) for p in minus_a_table(env, point_neg(env, a_pt))], dim=0
    )  # (16, 4, 20, B)
    lane_idx = torch.arange(lanes, device=packed.device)
    acc = identity_point(lanes, packed)
    for w in range(WINDOWS - 1, -1, -1):
        for i in range(4):
            acc = point_double(env, acc, want_t=(i == 3))
        if fixed_win == 8:
            # the comb entry of s's byte w/2 = window w + 16 * window w+1
            if w % 2 == 0:
                entry = env.comb[s_bytes[:, w // 2]].permute(1, 2, 0)
                acc = add_b_entry(env, acc, tuple(entry))
        else:
            digit = (s_bytes[:, w // 2] >> (4 * (w % 2))) & 15
            acc = add_b_entry(env, acc, tuple(env.comb[digit].permute(1, 2, 0)))
        sel = planes[h_win[w].long(), :, :, lane_idx].permute(1, 2, 0)
        acc = add_q_planes(env, acc, tuple(sel))
    r_y = torch.cat([r13[: LIMBS - 1], r13[LIMBS - 1 :] & 255], dim=0)
    r_sign = (r13[LIMBS - 1] >> 8) & 1
    if cofactored:
        ok, r_ok = cofactored_end(env, acc, r_y, r_sign)
        return a_ok & r_ok & ok & precheck
    enc_y, enc_parity = compress_y_parity(env, acc)
    match = (enc_y == r_y).all(dim=0) & (enc_parity == r_sign)
    return a_ok & match & precheck


def check_ladder_inputs(packed, h_win, table) -> None:
    check_packed(packed)
    lanes = packed.shape[0]
    if h_win.dtype != torch.int32 or tuple(h_win.shape) != (WINDOWS, lanes) or \
            not h_win.is_contiguous():
        raise ValueError(f"h windows must be contiguous (64, {lanes}) int32")
    if table.dtype != torch.int32 or tuple(table.shape) != (TABLE_ROWS, 10) or \
            not table.is_contiguous():
        raise ValueError(f"table must be contiguous ({TABLE_ROWS}, 10) int32")
    if not (packed.device == h_win.device == table.device):
        raise ValueError("packed, h windows and table must share a device")


def _verify(fixed_win: int, wrapper, packed, h_win, table, cofactored) -> torch.Tensor:
    check_ladder_inputs(packed, h_win, table)
    if packed.device.type == "cpu":
        return verify_ladder_plain(packed, h_win, table, fixed_win, cofactored)
    _build.require_cuda(packed)
    n = packed.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=packed.device)
    if n == 0:
        return out
    lib = _build.kernels()
    with torch.cuda.device(packed.device):
        rc = lib.ct_ed25519_verify_ladder(
            packed.data_ptr(), h_win.data_ptr(), table.data_ptr(),
            out.data_ptr(), n, fixed_win, int(cofactored), _build.stream_of(packed),
        )
    _build.check_launch(rc, wrapper.__name__)
    _build.count_launch(wrapper)
    return out


def ed25519_verify_ladder(packed: torch.Tensor, h_win: torch.Tensor,
                          table: torch.Tensor, cofactored: bool = False) -> torch.Tensor:
    """(B,) bool verdicts with the 8-bit comb, under the cofactored rule of
    full buckets when ``cofactored``. Launches kernel B on the current
    stream for CUDA tensors, runs the plain version for CPU tensors."""
    return _verify(8, ed25519_verify_ladder, packed, h_win, table, cofactored)


def ed25519_verify_ladder_w4(packed: torch.Tensor, h_win: torch.Tensor,
                             table: torch.Tensor, cofactored: bool = False) -> torch.Tensor:
    """(B,) bool verdicts with the 16-entry window; as
    ``ed25519_verify_ladder``."""
    return _verify(4, ed25519_verify_ladder_w4, packed, h_win, table, cofactored)


ed25519_verify_ladder.launches = 0
ed25519_verify_ladder_w4.launches = 0
VERIFY_B = {8: ed25519_verify_ladder, 4: ed25519_verify_ladder_w4}
