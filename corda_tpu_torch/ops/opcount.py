"""The op model of the port's kernels (counterpart of corda_tpu/ops/opcount.py),
and the H100 data-sheet rates their bounds divide by.

Every operation count the port's bounds use lives here: ``chip_smoke.py``
and the profiler's roofline read them from this module, and no kernel module
keeps a copy. The counts are derived from the live parameters of the port's
kernels (windows, table shapes, the addition chains of ``ops/addchain.py``),
and the field-operation census of kernels G and F is counted by running
their plain versions over one lane with a counting field
(``ed25519_ladder4096.field_ops_per_verify``,
``secp256_ladder.field_ops_per_verify``). ``tests/test_torch_opcount.py``
pins each count to the kernel it describes.

The unit of a bound is the **32-bit integer operation**: a 32 x 32 -> 64-bit
product is two multiply-adds, and an add with carry, a subtraction with
borrow, a select, a funnel shift or a LOP3 is one. The card's peak rate of
them is 64 a clock a SM (CUDA C++ Programming Guide, arithmetic instruction
throughput for compute capability 9.0). A bound is the larger of the bytes
a call must move over 3.35 TB/s (H100 SXM data sheet) and its operations
over that rate.

The reference's API is kept: ``ed25519_config``, ``ecdsa_config``,
``ops_per_verify``, ``rlc_config``, ``rlc_ops_per_batch``,
``rlc_ops_per_verify`` and ``active_models``, with the same keys, except:

- ``macs`` (and ``macs_per_verify``) are dropped: the reference's counts the
  multiply-accumulates of its TPU limb tiers, which the port's kernels do
  not have;
- ``ops``, ``mul_ops`` and ``sq_ops`` are 32-bit integer operations of the
  port's kernel (the reference's are its TPU tier's MACs and carry rows);
- ``radix`` of an ECDSA configuration is 2^32: kernel F's field is eight
  32-bit words.

The ``muls``/``sqs`` census equals the reference's wherever the port's
kernel runs the reference's formulas and chains (ed25519 on both tiers and
both fixed-base shapes). Kernel F's differs; the test says why.
"""

from __future__ import annotations

import functools

# ------------------------------------------------ H100 SXM data-sheet rates

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 64
INT32_OPS_PER_CLOCK_PER_SCHEDULER = INT32_OPS_PER_CLOCK_PER_SM // 4  # four a SM
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0
H100_INT32_OPS_PER_S = INT32_OPS_PER_CLOCK_PER_SM * H100_SMS * H100_MAX_SM_MHZ * 1e6


def bound(bytes_moved, ops, int_rate=H100_INT32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the HBM rate against 32-bit
    integer operations over ``int_rate`` a second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serial_floor_ms(chain_ops: int, mhz: float) -> float:
    """The least time of one warp whose lanes each run a serial chain of
    ``chain_ops`` integer operations: 32 lanes at one scheduler's rate."""
    return chain_ops * 32 / INT32_OPS_PER_CLOCK_PER_SCHEDULER / (mhz * 1e3)


# ----------------------------------------------- kernels C and D: SHA-256

# One compression: a round is 14 (Sigma0 and Sigma1 at three funnel shifts
# and one LOP3 each, ch and maj at one LOP3 each, t1's five terms at two
# IADD3, e and a at one each), a schedule word 10 (sigma0 and sigma1 at two
# funnel shifts, a shift and one LOP3 each, the four-term sum at two IADD3),
# then the 8 adds into the state. A pair's second block is the constant
# padding block, whose schedule folds to constants.
SHA256_ROUND_OPS = 14
SHA256_SCHEDULE_OPS = 10
SHA256_FINAL_OPS = 8
INT_OPS_PER_BLOCK = 64 * SHA256_ROUND_OPS + 48 * SHA256_SCHEDULE_OPS + SHA256_FINAL_OPS
INT_OPS_PER_PAIR = INT_OPS_PER_BLOCK + 64 * SHA256_ROUND_OPS + SHA256_FINAL_OPS
# Kernel C's consumer warp runs only the rounds and the final adds of a
# block; its producer warp the schedule. The longest message's consumer
# chain is kernel C's serial floor.
INT_OPS_ROUNDS_PER_BLOCK = 64 * SHA256_ROUND_OPS + SHA256_FINAL_OPS

# --------------------------------- kernel A: SHA-512, mod L and the windows

# SHA-512 on 64-bit words held as 32-bit pairs: a round's Sigma0/Sigma1 are
# three 64-bit rotates each (two funnel shifts a rotate) and an xor3 on
# each half; ch and maj one LOP3 a half; t1 two 3-term adds (4); e = d + t1
# and a = t1 + Sigma0 + maj.
_SHA512_ROUND_OPS = (
    2 * (3 * 2 + 2)         # Sigma0, Sigma1
    + 2 + 2                 # ch, maj
    + 4                     # t1 = h + Sigma1 + ch + K + w: two 3-term adds
    + 2 + 2                 # e = d + t1, a = t1 + Sigma0 + maj
)                           # = 28
_SHA512_SCHEDULE_OPS = 2 * (2 * 2 + 2 + 2) + 4  # sigma0, sigma1 (two rotates, a
                                                # shift, xor3), four-term add = 20
# Barrett: x * m (16 x 9 limbs) and q * L mod 2^288 over L's five nonzero
# 32-bit limbs (9 + 8 + 7 + 6 + 2 products), each product 32 x 32 -> 64
# bits (two multiply-adds) plus the 64-bit add of its carry
_BARRETT_PRODUCTS = 16 * 9 + 32
CHALLENGE_INT_OPS_PER_LANE = (
    80 * _SHA512_ROUND_OPS + 64 * _SHA512_SCHEDULE_OPS + 8 * 2 + _BARRETT_PRODUCTS * 4
)  # = 4240
# Kernel A's rounds warp: the lane's chain less the schedule, which its
# schedule warp expands; kernel A's serial floor.
CHALLENGE_ROUNDS_WARP_OPS = CHALLENGE_INT_OPS_PER_LANE - 64 * _SHA512_SCHEDULE_OPS  # = 2960

# ------------------------------------------ kernel B: ref10's ten limbs

# The fewest 32-bit integer multiply-adds of one field multiply and one
# squaring in ref10's ten-limb representation: each product of 32 x 32 -> 64
# bits is two multiply-adds. A multiply is 100 products plus its
# premultiplies (g1..g9 by 19, the five odd f limbs by 2); a squaring is the
# 55 products of the upper triangle plus its premultiplies (f5..f9 by 19 or
# 38, f0..f7 by 2), as kernel B's squaring (fe25519.cuh's ct_fe_sq, ref10's
# fe_sq) does.
INT_OPS_PER_FIELD_MUL = 100 * 2 + 9 + 5   # = 214
INT_OPS_PER_FIELD_SQ = 55 * 2 + 5 + 8     # = 123


def ed25519_field_ops(fixed_win: int) -> dict:
    """Field multiplies and squarings of one lane's verify in kernel B's
    schedule (the four-way formulas do the same multiplies and squarings,
    several on a quad's idle lanes): decompress with the sqrt chain and
    T = xy, the 16-entry table (7 doublings, 7 adds, 16 plane conversions),
    256 doublings (T on every fourth), the fixed-base adds of 7 multiplies
    (32 with the comb, 64 with the window) and 64 table adds of 8, then the
    inversion and x, y."""
    from .addchain import INV_CHAIN_OPS, SQRT_CHAIN_OPS
    from .ed25519_ladder import FIXED_WINS
    from .scalar25519 import WINDOWS

    if fixed_win not in FIXED_WINS:
        raise ValueError(f"fixed_win must be one of {FIXED_WINS}")
    fixed_adds = WINDOWS // 2 if fixed_win == 8 else WINDOWS
    mul = (9 + SQRT_CHAIN_OPS[1] + 7 * 4 + 7 * 9 + 16 + 256 * 3 + WINDOWS
           + fixed_adds * 7 + WINDOWS * 8 + INV_CHAIN_OPS[1] + 2)
    sq = 4 + SQRT_CHAIN_OPS[0] + 7 * 4 + 256 * 4 + INV_CHAIN_OPS[0]
    return {"mul": mul, "sq": sq}


def ladder_int_ops(fixed_win: int) -> int:
    """Kernel B: the fewest 32-bit integer operations of one lane's verify
    (its field multiplies and squarings)."""
    n = ed25519_field_ops(fixed_win)
    return n["mul"] * INT_OPS_PER_FIELD_MUL + n["sq"] * INT_OPS_PER_FIELD_SQ


# ------------------------------------ kernels G and F: eight 32-bit words

# A product of 32 x 32 -> 64 bits is two multiply-adds, so a multiply is 64
# products (128) and a squaring 36 (72) plus doubling the cross terms (16).
W8_INT_OPS_PER_MUL = 128
W8_INT_OPS_PER_SQ = 72 + 16
# An add, subtract or negate mod p is 8 adds with carry, 8 subtractions
# with borrow and 8 selects (24); an equality test 8 compares and 8 ors.
W8_INT_OPS_PER_ADD = 24
W8_INT_OPS_PER_EQ = 16
# Kernel G reduces through 2^256 = 38: the high half times 38 (8 products,
# 16), one three-input add a word (8), the fold of the bits from 255 up (4)
# and the conditional subtraction of p (8 subtractions, 8 selects) = 44.
# Kernel G squares as counted here (csrc/fe25519_w8.cuh's ct_25519_sq).
G_INT_OPS_PER_REDUCE = 44


def g_int_ops(fixed_win: int) -> int:
    """Kernel G: 32-bit integer operations of one lane's verify, from the
    census its plain version counts."""
    from .ed25519_ladder4096 import field_ops_per_verify

    n = field_ops_per_verify(fixed_win)
    return (n["mul"] * (W8_INT_OPS_PER_MUL + G_INT_OPS_PER_REDUCE)
            + n["sq"] * (W8_INT_OPS_PER_SQ + G_INT_OPS_PER_REDUCE)
            + n["add"] * W8_INT_OPS_PER_ADD + n["eq"] * W8_INT_OPS_PER_EQ)


# Kernel F's reductions:
# - secp256k1, 2^256 = 2^32 + 977: the high half times 977 (8 products,
#   16), one three-input add a word (8), the top carry's fold (4) and the
#   conditional subtraction of p (8 subtractions, 8 selects) = 44;
# - secp256r1, FIPS 186-4 D.2.3: 52 signed word terms in 64-bit sums
#   (52 three-input adds over 32-bit halves), the carry chain (8), the top
#   carry's fold (8) and the conditional subtraction (16) = 84.
# A b3 product is a multiply for secp256r1, whose 3b is full width; for
# secp256k1, 3b = 21 is one word: 8 products (16), the top word's fold
# through 2^32 + 977 with its carry through the words (8) and the
# conditional subtraction (16) = 40.
F_INT_OPS_PER_REDUCE = {"secp256k1": 44, "secp256r1": 84}
F_INT_OPS_PER_MUL_B3 = {"secp256k1": 40,
                        "secp256r1": W8_INT_OPS_PER_MUL + F_INT_OPS_PER_REDUCE["secp256r1"]}


def ecdsa_int_ops(curve: str) -> int:
    """Kernel F: 32-bit integer operations of one lane's verify on
    ``curve``, from the census its plain version counts."""
    from .secp256_ladder import field_ops_per_verify

    n = field_ops_per_verify(curve)
    red = F_INT_OPS_PER_REDUCE[curve]
    return (n["mul"] * (W8_INT_OPS_PER_MUL + red) + n["sq"] * (W8_INT_OPS_PER_SQ + red)
            + n["mul_b3"] * F_INT_OPS_PER_MUL_B3[curve] + n["add"] * W8_INT_OPS_PER_ADD)


# ---------------------------------------------------- kernel E: the comb

def comb_field_ops() -> dict:
    """Kernel E's field work a lane: 64 mixed adds of 7 multiplies, the
    inversion's chain, x and y."""
    from .addchain import INV_CHAIN_OPS
    from .ed25519_sign import WINDOWS

    return {"mul": WINDOWS * 7 + INV_CHAIN_OPS[1] + 2, "sq": INV_CHAIN_OPS[0]}


def comb_int_ops() -> int:
    """Kernel E: 32-bit integer operations of one lane, its field work on
    ref10's limbs plus the constant-time select, one LOP3 for each of the
    480 table words of every window."""
    from .ed25519_sign import ENTRIES, WINDOWS

    n = comb_field_ops()
    return (n["mul"] * INT_OPS_PER_FIELD_MUL + n["sq"] * INT_OPS_PER_FIELD_SQ
            + WINDOWS * ENTRIES * 3 * 10)


# ------------------------------------------------ kernel H: SPHINCS+

def sphincs_lane_work(signed: list[bytes]) -> tuple[int, int]:
    """(SHA-256 blocks, longest chain of dependent blocks) of one prechecked
    SPHINCS lane, for kernel H's bound and serial floor, from the D digests
    its layers sign: the FORS pk, then each layer's root but the top (the
    plain version's stages). Kernel H runs steps digit .. W - 2 of each
    chain only; the chain is a FORS tree, the FORS pk, then per layer its
    longest chain, the WOTS pk and the auth path."""
    from ..crypto.sphincs import A, D, HT, K, LEN, N, W, _digits
    from .sphincs_batch import _blocks

    assert len(signed) == D
    # each hash is tag || pub_seed || address (20 bytes) || data
    fors_tree = _blocks(8 + 52 + N) + A * _blocks(8 + 52 + 2 * N)  # 2 + 8 x 3
    fors_pk = _blocks(6 + 52 + K * N)  # 9
    step = _blocks(2 + 52 + N)  # 2
    per_layer = _blocks(6 + 52 + LEN * N) + HT * _blocks(4 + 52 + 2 * N)  # 35 + 6 x 3
    steps = [[W - 1 - d for d in _digits(dg)] for dg in signed]
    blocks = K * fors_tree + fors_pk + step * sum(map(sum, steps)) + D * per_layer
    chain = fors_tree + fors_pk + sum(step * max(s) + per_layer for s in steps)
    return blocks, chain


def sphincs_chain_ops(signed: list[bytes], idx: int) -> int:
    """The 32-bit integer operations on one prechecked SPHINCS lane's
    critical chain in kernel H (csrc/sphincs.cuh), for its serial floor,
    from the D digests its layers sign (as ``sphincs_lane_work``) and its
    hypertree index. A round R = 14, a schedule word S = 10 and the final
    adds F = 8, so a block is 1,384 on one thread and its consumer's share
    C = 64R + F = 904 on the warp pair (the producer's schedule runs beside
    it); a hoisted first block starts at round 13 or 14:

        FORS tree   (51R + F + C) + A (51R + F + 2C)        on the pair
        FORS pk     (50R + F) + 8C                          on the pair
        per layer   s (51R + 48S + F + 1,384)               its longest chain, s steps,
                                                            on one thread
                    + (50R + F) + 34C                       the WOTS pk, on the pair
                    + per auth level 2C at an odd position (the first block
                      hoisted whole), (50R + F) + 2C at an even one."""
    from ..crypto.sphincs import A, D, HT, W, _digits

    assert len(signed) == D
    r, s, f, c = (SHA256_ROUND_OPS, SHA256_SCHEDULE_OPS, SHA256_FINAL_OPS,
                  INT_OPS_ROUNDS_PER_BLOCK)
    from13, from14 = (64 - 13) * r + f, (64 - 14) * r + f
    ops = (from13 + c) + A * (from13 + 2 * c) + from14 + 8 * c
    for layer, dg in enumerate(signed):
        steps = W - 1 - min(_digits(dg))
        ops += steps * (from13 + 48 * s + INT_OPS_PER_BLOCK) + from14 + 34 * c
        leaf = (idx >> (HT * layer)) & ((1 << HT) - 1)
        ops += sum(2 * c if (leaf >> lvl) & 1 else from14 + 2 * c for lvl in range(HT))
    return ops


# ------------------------------------- kernels I, J and K: the state store

# One probed slot counts 12 32-bit integer operations: the tag and key
# compares and the slot's index arithmetic.
STATESTORE_INT_OPS_PER_SLOT = 12


def statestore_int_ops(rows: int, max_probe: int) -> int:
    """Kernels I, J and K: 32-bit integer operations of ``rows`` rows, each
    probing its whole window of ``max_probe`` slots."""
    return rows * max_probe * STATESTORE_INT_OPS_PER_SLOT


# ------------------------------------------------- one figure a kernel

def kernel_int_ops() -> dict:
    """The 32-bit integer operations one lane (one row) of each kernel A-H
    does at the main path's shapes: B and G on their default comb, F on
    each curve, C one block, D one pair, H one lane whose every chain runs
    all W - 1 steps (its work depends on the digits: ``sphincs_lane_work``)."""
    from ..crypto.sphincs import D, HT, K, LEN, N, W
    from ..crypto.sphincs import A as FORS_HEIGHT
    from .sphincs_batch import _blocks

    full_h = (K * (_blocks(8 + 52 + N) + FORS_HEIGHT * _blocks(8 + 52 + 2 * N))
              + _blocks(6 + 52 + K * N)
              + D * (LEN * (W - 1) * _blocks(2 + 52 + N) + _blocks(6 + 52 + LEN * N)
                     + HT * _blocks(4 + 52 + 2 * N)))
    return {
        "A": CHALLENGE_INT_OPS_PER_LANE,
        "B": ladder_int_ops(8),
        "C": INT_OPS_PER_BLOCK,
        "D": INT_OPS_PER_PAIR,
        "E": comb_int_ops(),
        "F-k1": ecdsa_int_ops("secp256k1"),
        "F-r1": ecdsa_int_ops("secp256r1"),
        "G": g_int_ops(8),
        "H": full_h * INT_OPS_PER_BLOCK,
    }


# ---------------------------------------------- the profiler's roofline

# bytes a row moves through each kernel: A reads a 128-byte padded block
# and writes 64 windows of 4 bytes; B and G read the 161-byte packed row and
# the windows, write a verdict byte; E reads 64 windows of a byte and
# writes a 64-byte point; F reads its packed row, writes a verdict; C reads
# a block and writes a digest; D reads two digests and writes one.
_A_BYTES = 128 + 64 * 4
_LADDER_BYTES = 161 + 64 * 4 + 1


def _ecdsa_row_bytes() -> int:
    from .secp256_ladder import ECDSA_ROW

    return ECDSA_ROW + 1


@functools.lru_cache(maxsize=1)
def _roofline_rows() -> dict:
    """kernel name -> (bytes, 32-bit integer operations) of one row."""
    ops = kernel_int_ops()
    return {
        # the default tier: A, then B's comb
        "ed25519.verify": (_A_BYTES + _LADDER_BYTES, ops["A"] + ops["B"]),
        "sha512": (_A_BYTES, ops["A"]),
        "ed25519.sign": (64 + 64, ops["E"]),
        # secp256k1, the cheaper curve: an upper bound for either
        "ecdsa.verify": (_ecdsa_row_bytes(), ops["F-k1"]),
        "sha256": (64 + 8 + 32, ops["C"]),
        # a leaf's block, and the pair that lifts it
        "txid": (64 + 8 + 32 + 64 + 32, ops["C"] + ops["D"]),
    }


def roofline_rows_per_sec(kernel: str) -> float | None:
    """The H100 data-sheet bound of ``kernel``'s rows a second: one row's
    bytes over 3.35 TB/s against its operations over 64 a clock a SM x 132
    SMs x 1,980 MHz, the larger time of the two (``bound``'s rule). None
    for a name the model does not cover (the SPHINCS verify, whose work
    depends on the digits; the host loop; the scheduler's whole batch)."""
    row = _roofline_rows().get(kernel)
    if row is None:
        return None
    ms, _by = bound(*row)
    return 1e3 / ms


# --------------------------------------------------------- the reference's API

def _naive_pow_ops(exponent: int) -> tuple[int, int]:
    """(squarings, multiplies) of plain square-and-multiply."""
    return exponent.bit_length() - 1, bin(exponent).count("1") - 1


def ed25519_config(radix: int | None = None, fixed_win: int | None = None,
                   chains: bool = True) -> dict:
    """The default (or pinned) ed25519 tier: ``ops.ed25519.DEFAULT_TIER``
    unless given. ``chains=False`` models square-and-multiply
    exponentiations in place of the addition chains."""
    from .ed25519 import DEFAULT_TIER

    return {"scheme": "ed25519", "radix": radix or DEFAULT_TIER.radix,
            "fixed_win": fixed_win or DEFAULT_TIER.fixed_win, "chains": chains}


def ecdsa_config(curve: str = "secp256k1", radix: int | None = None,
                 fixed_win: int | None = None) -> dict:
    """Kernel F's configuration for one curve: eight 32-bit words (radix
    2^32) and the 256-entry comb (fixed_win 8), its only shape."""
    from .secp256_ladder import CURVE_IDS

    if curve not in CURVE_IDS:
        raise ValueError(curve)
    return {"scheme": "ecdsa", "curve": curve, "radix": radix or 2**32,
            "fixed_win": fixed_win or 8}


def ops_per_verify(cfg: dict) -> dict:
    """Field-op census of one verify under ``cfg``: ``muls``/``sqs`` (field
    multiplies, squarings), ``ops`` (the port's kernel's 32-bit integer
    operations) and ``mul_ops``/``sq_ops`` (a multiply's and a squaring's
    share of them; kernels G and F add their field adds and compares)."""
    if cfg["scheme"] == "ed25519":
        fw = cfg["fixed_win"]
        n = dict(ed25519_field_ops(fw))
        if not cfg["chains"]:
            from .addchain import INV_CHAIN_OPS, SQRT_CHAIN_OPS

            p = 2**255 - 19
            (ss, sm), (is_, im) = _naive_pow_ops((p - 5) // 8), _naive_pow_ops(p - 2)
            n["mul"] += sm + im - SQRT_CHAIN_OPS[1] - INV_CHAIN_OPS[1]
            n["sq"] += ss + is_ - SQRT_CHAIN_OPS[0] - INV_CHAIN_OPS[0]
        if cfg["radix"] == 8192:
            mul_ops, sq_ops = INT_OPS_PER_FIELD_MUL, INT_OPS_PER_FIELD_SQ
            ops = n["mul"] * mul_ops + n["sq"] * sq_ops
        else:
            from .ed25519_ladder4096 import field_ops_per_verify

            mul_ops = W8_INT_OPS_PER_MUL + G_INT_OPS_PER_REDUCE
            sq_ops = W8_INT_OPS_PER_SQ + G_INT_OPS_PER_REDUCE
            g = field_ops_per_verify(fw)
            ops = (n["mul"] * mul_ops + n["sq"] * sq_ops + g["add"] * W8_INT_OPS_PER_ADD
                   + g["eq"] * W8_INT_OPS_PER_EQ)
        return {"muls": n["mul"], "sqs": n["sq"], "ops": ops,
                "mul_ops": mul_ops, "sq_ops": sq_ops}
    from .secp256_ladder import field_ops_per_verify

    curve = cfg["curve"]
    n = field_ops_per_verify(curve)
    red = F_INT_OPS_PER_REDUCE[curve]
    return {"muls": n["mul"] + n["mul_b3"], "sqs": n["sq"], "ops": ecdsa_int_ops(curve),
            "mul_ops": W8_INT_OPS_PER_MUL + red, "sq_ops": W8_INT_OPS_PER_SQ + red}


# The reference's multi-scalar RLC check (corda_tpu/batchverify/rlc.py). The
# port does not run it: its full buckets take the per-signature cofactored
# rule on kernels B and G, whose verdicts equal the check's row by row. The
# model is kept as the reference has it, over the reference's parameters.
MSM_WINDOW_BITS = 4
MSM_TABLE_BUILD = (1, 6)
COMB_ADDS = 32
Z_BITS = 128


def rlc_config(n: int = 64) -> dict:
    """The reference's RLC batch-verify configuration at batch size ``n``."""
    return {"scheme": "ed25519_batch", "n": n, "window_bits": MSM_WINDOW_BITS,
            "table_build": MSM_TABLE_BUILD, "comb_adds": COMB_ADDS, "z_bits": Z_BITS}


def rlc_ops_per_batch(cfg: dict) -> dict:
    """Field-op census (muls/sqs) of one N-row RLC batch check: batched
    strict decompression of 2N points under one Montgomery inversion, then
    the interleaved-Straus MSM with its shared doubling chain, 8-entry
    signed tables, window adds and the B-term comb."""
    from .addchain import INV_CHAIN_OPS, SQRT_CHAIN_OPS

    n, w = cfg["n"], cfg["window_bits"]
    sqrt_s, sqrt_m = SQRT_CHAIN_OPS
    inv_s, inv_m = INV_CHAIN_OPS
    pts = 2 * n
    muls = pts * (2 + 1 + sqrt_m + 1 + 1)
    sqs = pts * (1 + sqrt_s + 1)
    muls += inv_m + 3 * (pts - 1)
    sqs += inv_s
    nw_full = -(-253 // w)
    nw_z = -(-(cfg["z_bits"] + 1) // w)
    dbl_m = dbl_s = 4
    add_m, madd_m = 9, 7
    doubles = (nw_full - 1) * w + 3
    muls += doubles * dbl_m
    sqs += doubles * dbl_s
    tb_dbl, tb_add = cfg["table_build"]
    muls += pts * (tb_dbl * dbl_m + tb_add * add_m)
    sqs += pts * tb_dbl * dbl_s
    nz = (2**w - 1) / 2**w
    muls += int(n * nw_full * nz) * add_m
    muls += int(n * nw_z * nz) * add_m
    muls += cfg["comb_adds"] * madd_m
    return {"muls": muls, "sqs": sqs, "field_ops": muls + sqs}


def rlc_ops_per_verify(cfg: dict | None = None) -> dict:
    """Amortized per-signature cost of the RLC batch check."""
    cfg = cfg or rlc_config()
    batch = rlc_ops_per_batch(cfg)
    n = cfg["n"]
    return {k: batch[k] / n for k in ("muls", "sqs", "field_ops")}


def active_models() -> dict:
    """The per-scheme op models of the default configuration: ed25519 on
    the default tier, ECDSA on secp256k1, and the reference's RLC model
    (model only)."""
    out = {}
    for name, cfg in (("ed25519", ed25519_config()), ("ecdsa", ecdsa_config("secp256k1"))):
        census = ops_per_verify(cfg)
        out[name] = {
            "config": {k: v for k, v in cfg.items() if k != "scheme"},
            "ops_per_verify": census["ops"],
            "field_muls_per_verify": census["muls"] + census["sqs"],
        }
    rcfg = rlc_config()
    amortized = rlc_ops_per_verify(rcfg)["field_ops"]
    floor = out["ed25519"]["field_muls_per_verify"]
    out["ed25519_batch"] = {
        "config": {k: v for k, v in rcfg.items() if k != "scheme"},
        "ops_per_verify": round(amortized, 2),
        "per_sig_field_ops": floor,
        "savings_vs_per_sig": round(floor / amortized, 3),
        "model_only": True,
    }
    return out
