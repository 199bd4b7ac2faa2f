"""Pad buckets for the device scheduler (counterpart of corda_tpu/serving/shapes.py).

The scheduler pads each device batch to one of a few bucket sizes so the
staging pool and the kernels see a small set of shapes. The ladder is data:
``shapes.json`` beside this module, which must be present.
"""

from __future__ import annotations

import functools
import json
import os

_SHAPES_PATH = os.path.join(os.path.dirname(__file__), "shapes.json")


class ShapeTable:
    """``bucket_for(n, floor)`` returns the smallest configured bucket >= n
    and >= ``floor`` (None beyond the ladder: the kernels then pad to their
    own power of two)."""

    def __init__(self, data: dict):
        self.buckets: list[int] = sorted(int(b) for b in data["buckets"])
        self.data = dict(data)

    def bucket_for(self, n_rows: int, floor: int | None = None) -> int | None:
        want = max(n_rows, floor or 0)
        return next((b for b in self.buckets if b >= want), None)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]


@functools.cache
def shape_table() -> ShapeTable:
    """The checked-in table, read once per process."""
    with open(_SHAPES_PATH) as f:
        return ShapeTable(json.load(f))
