"""Carrying the reference's state across to the port.

The system has no weights: the state its verify kernel is fed with is the
constants matrix of corda_tpu/ops/ed25519_pallas13.py (``_CONSTS_HOST``,
:98-108), an (824, 128) int32 array of radix-8192 limbs:

    row 0 K2, row 1 p, rows 2/3 d and 2d, row 4 sqrt(-1),
    rows 8-55 the 16-entry B table, rows 56-823 the 256-entry comb
    (y - x, y + x, 2d*x*y) of v*B.

``consts_from_reference`` turns that array into kernel B's (771, 10) table
in the port's ten-limb representation, and ``consts_to_reference`` rebuilds
the reference array from a port table. ``shapes_from_reference`` carries
the scheduler's bucket ladder.

The notary slice adds three more:

- ``comb_table_from_reference``: the signing comb's constants
  (corda_tpu/ops/ed25519_sign.py ``_comb_consts``, an (8 + 48 * 64, 128)
  int32 array of 22 x 12-bit limbs) -> kernel E's (3072, 10) table;
- ``signed_transaction_from_reference``: a reference SignedTransaction's
  CBE bytes -> the port's ``SignedTransaction``, whose bytes round-trip
  identically;
- ``uniqueness_from_reference``: the committed map of a reference
  ``InMemoryUniquenessProvider`` -> a port provider holding the same
  consumed set.

The mixed-scheme slice adds ``ecdsa_table_from_reference`` and its
inverse ``ecdsa_table_to_reference``: the reference's ECDSA constants
matrix (corda_tpu/ops/secp256_pallas.py, an (824, 128) int32 array in one
of three field tiers) <-> kernel F's (771, 8) table for one curve:

    row 0 the tier's subtraction offset, rows 1/2 its fold and canonical
    offsets (where the tier has them), row 3 p, rows 4-6 a, b and 3b,
    rows 8-55 the 16-entry G table, rows 56-823 the 256-entry comb v*G
    as projective (X, Y, Z);

the tiers are ``"k1"`` (``_consts_host_k1`` :578, 22 x 12-bit limbs),
``"4096"`` (``_consts_host_4096`` :894, 22 x 12-bit) and ``"256"``
(``_consts_host`` :129, 32 x 8-bit).

SPHINCS and RSA (schemes 5 and 1) carry nothing across: their keys and
signatures are the reference's bytes as they are (the same entropy gives
the same SPHINCS key, and RSA keys are DER in both packages), and kernel H
has no constant tables, so this module has no function for them.

The caller passes the reference's arrays and objects in; this module
never imports them.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.ed25519_ladder import (
    K2,
    LIMBS,
    P13,
    ROW_COMB,
    ROW_D,
    ROW_D2,
    ROW_SQRT_M1,
    TABLE_ROWS,
    fe10_to_int,
    int_to_fe10,
    int_to_limbs13,
    limbs13_to_int,
)
from .notary.uniqueness import ConsumedStateDetails, InMemoryUniquenessProvider
from .ops.ed25519_sign import COMB_ROWS, ENTRIES, WINDOWS
from .ops import secp256_ladder as sl
from .crypto.ecdsa_host import CURVES
from .crypto import SecureHash
from .ledger import SignedTransaction
from .serialization import deserialize, serialize
from .serving.shapes import ShapeTable

REF_ROWS = 824
_REF_D, _REF_D2, _REF_SQRT_M1, _REF_BTABLE, _REF_COMB = 2, 3, 4, 8, 56


def consts_from_reference(consts: np.ndarray, device=None) -> torch.Tensor:
    """The reference's (824, 128) radix-8192 constants -> kernel B's
    (771, 10) int32 table on ``device`` (CPU when None)."""
    consts = np.asarray(consts)
    if consts.shape != (REF_ROWS, 128):
        raise ValueError(f"expected the (824, 128) reference matrix, got {consts.shape}")
    vals = [limbs13_to_int(row[:LIMBS]) for row in consts]
    # the B table is the comb's prefix; the port keeps only the comb
    if vals[_REF_BTABLE:_REF_COMB] != vals[_REF_COMB:_REF_COMB + 48]:
        raise ValueError("reference B table is not the comb's prefix")
    table = np.zeros((TABLE_ROWS, 10), dtype=np.int32)
    table[ROW_D] = int_to_fe10(vals[_REF_D])
    table[ROW_D2] = int_to_fe10(vals[_REF_D2])
    table[ROW_SQRT_M1] = int_to_fe10(vals[_REF_SQRT_M1])
    for k in range(3 * 256):
        table[ROW_COMB + k] = int_to_fe10(vals[_REF_COMB + k])
    return torch.from_numpy(table).to(device or "cpu")


def consts_to_reference(table: torch.Tensor) -> np.ndarray:
    """Kernel B's table -> the reference's (824, 128) radix-8192 matrix."""
    rows = table.cpu().numpy()
    out = np.zeros((REF_ROWS, 128), dtype=np.int32)
    out[0, :LIMBS] = K2
    out[1, :LIMBS] = P13
    out[_REF_D, :LIMBS] = int_to_limbs13(fe10_to_int(rows[ROW_D]))
    out[_REF_D2, :LIMBS] = int_to_limbs13(fe10_to_int(rows[ROW_D2]))
    out[_REF_SQRT_M1, :LIMBS] = int_to_limbs13(fe10_to_int(rows[ROW_SQRT_M1]))
    for k in range(3 * 256):
        limbs = int_to_limbs13(fe10_to_int(rows[ROW_COMB + k]))
        out[_REF_COMB + k, :LIMBS] = limbs
        if k < 48:
            out[_REF_BTABLE + k, :LIMBS] = limbs
    return out


def shapes_from_reference(data: dict) -> ShapeTable:
    """The reference's shapes.json content -> the port's ShapeTable: the
    same bucket ladder, with the port's own provenance (the reference's
    capture describes another device)."""
    return ShapeTable({
        "buckets": list(data["buckets"]),
        "source": "the reference's bucket ladder; not yet measured on the H100",
        "device": "not yet measured on the H100",
    })


REF_COMB_LIMBS = 22   # the reference's radix-4096 limbs (22 x 12 bits)
_REF_COMB_BASE = 8    # rows 0..7: K2, p and padding


def comb_table_from_reference(consts: np.ndarray, device=None) -> torch.Tensor:
    """The reference's (3080, 128) radix-4096 comb constants -> kernel E's
    (3072, 10) int32 table on ``device`` (CPU when None)."""
    consts = np.asarray(consts)
    if consts.shape != (_REF_COMB_BASE + 48 * WINDOWS, 128):
        raise ValueError(f"expected the (3080, 128) reference comb, got {consts.shape}")
    table = np.zeros((COMB_ROWS, 10), dtype=np.int32)
    for k in range(WINDOWS):
        for row in range(3 * ENTRIES):
            limbs = consts[_REF_COMB_BASE + 48 * k + row, :REF_COMB_LIMBS]
            value = sum(int(v) << (12 * i) for i, v in enumerate(limbs))
            table[3 * ENTRIES * k + row] = int_to_fe10(value)
    return torch.from_numpy(table).to(device or "cpu")


def signed_transaction_from_reference(raw: bytes) -> SignedTransaction:
    """A reference SignedTransaction's CBE bytes -> the port's, checked to
    serialize back to the same bytes."""
    stx = deserialize(raw)
    if not isinstance(stx, SignedTransaction):
        raise TypeError(f"expected a SignedTransaction, got {type(stx).__name__}")
    if serialize(stx) != raw:
        raise ValueError("the port's encoding of the transaction differs from the reference's")
    return stx


def uniqueness_from_reference(committed: dict) -> InMemoryUniquenessProvider:
    """A reference InMemoryUniquenessProvider's committed map (state key
    bytes -> consumption details) -> a port provider with the same
    consumed set."""
    provider = InMemoryUniquenessProvider()
    for key, d in committed.items():
        provider._map[bytes(key)] = ConsumedStateDetails(
            SecureHash(bytes(d.consuming_tx.bytes)), int(d.input_index),
            str(d.requesting_party_name),
        )
    return provider


# tier -> (bits a limb, limbs, {row: base of that row's positive multiple of p})
ECDSA_TIERS = {
    "k1": (12, 22, {0: 8192}),
    "4096": (12, 22, {0: 1 << 14, 2: 1 << 14}),
    "256": (8, 32, {0: 2600, 1: 1 << 29, 2: 1 << 13}),
}
_REF_P, _REF_A, _REF_B, _REF_B3 = 3, 4, 5, 6
_REF_G_TABLE, _REF_G_COMB = 8, 56


def _tier_limbs(x: int, bits: int, n: int) -> list[int]:
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(n)]


def _tier_value(row, bits: int, n: int) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(row[:n]))


def _pos_multiple(p: int, base: int, bits: int, n: int) -> list[int]:
    """The tier's multiple of p with every limb in [base, base + 2^bits)."""
    v = base * ((1 << (bits * n)) - 1) // ((1 << bits) - 1)
    return [limb + base for limb in _tier_limbs((-v) % p, bits, n)]


def ecdsa_table_from_reference(curve_name: str, consts: np.ndarray,
                               device=None) -> torch.Tensor:
    """The reference's (824, 128) ECDSA constants of any tier -> kernel F's
    (771, 8) int32 table for ``curve_name`` on ``device`` (CPU when None).
    The tier is read off the matrix: the radix under which comb entry 1
    decodes to G."""
    consts = np.asarray(consts)
    if consts.shape != (REF_ROWS, 128):
        raise ValueError(f"expected the (824, 128) reference matrix, got {consts.shape}")
    cv = CURVES[curve_name]
    g_row = consts[_REF_G_COMB + 3]
    radix = next((r for r in ((12, 22), (8, 32)) if _tier_value(g_row, *r) == cv.gx), None)
    if radix is None:
        raise ValueError(f"comb entry 1 of the matrix is not {curve_name}'s G in any tier")
    vals = [_tier_value(row, *radix) for row in consts]
    if vals[_REF_P] != cv.p:
        raise ValueError(f"the matrix's p is not {curve_name}'s")
    if vals[_REF_G_TABLE:_REF_G_COMB] != vals[_REF_G_COMB:_REF_G_COMB + 48]:
        raise ValueError("reference G table is not the comb's prefix")
    table = np.zeros((sl.TABLE_ROWS, 8), dtype=np.int32)
    table[sl.ROW_P] = sl.int_to_words(vals[_REF_P])
    table[sl.ROW_B] = sl.int_to_words(vals[_REF_B])
    table[sl.ROW_B3] = sl.int_to_words(vals[_REF_B3])
    for k in range(3 * 256):
        table[sl.ROW_COMB + k] = sl.int_to_words(vals[_REF_G_COMB + k])
    return torch.from_numpy(table).to(device or "cpu")


def ecdsa_table_to_reference(curve_name: str, table: torch.Tensor, tier: str) -> np.ndarray:
    """Kernel F's table -> the reference's (824, 128) matrix of ``tier``
    ("k1", "4096" or "256"), the tier's offsets rebuilt from p."""
    bits, n, offsets = ECDSA_TIERS[tier]
    cv = CURVES[curve_name]
    rows = table.cpu().numpy()
    p = sl.words_to_int(rows[sl.ROW_P])
    out = np.zeros((REF_ROWS, 128), dtype=np.int32)
    for row, base in offsets.items():
        out[row, :n] = _pos_multiple(p, base, bits, n)
    out[_REF_P, :n] = _tier_limbs(p, bits, n)
    if tier != "k1":
        out[_REF_A, :n] = _tier_limbs(cv.a % p, bits, n)
    out[_REF_B, :n] = _tier_limbs(sl.words_to_int(rows[sl.ROW_B]), bits, n)
    out[_REF_B3, :n] = _tier_limbs(sl.words_to_int(rows[sl.ROW_B3]), bits, n)
    for k in range(3 * 256):
        limbs = _tier_limbs(sl.words_to_int(rows[sl.ROW_COMB + k]), bits, n)
        out[_REF_G_COMB + k, :n] = limbs
        if k < 48:
            out[_REF_G_TABLE + k, :n] = limbs
    return out
