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
the scheduler's bucket ladder. The caller passes the reference's arrays in;
this module never imports them.
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
