"""Pad buckets for the device scheduler (counterpart of corda_tpu/serving/shapes.py).

The scheduler pads each device batch to one of a few bucket sizes so the
staging pool and the kernels see a small set of shapes. The ladder is data:
``shapes.json`` beside this module (the reference's ladder, not yet
measured on the H100).

Override precedence, as in the reference: ``CORDA_TPU_SERVING_SHAPES`` (the
path of a JSON file with a ``buckets`` list) > the checked-in
``shapes.json`` > ``DEFAULT_SHAPES``. A missing or corrupt file falls
through to the next; nothing raises.
"""

from __future__ import annotations

import json
import os
import threading

# the reference's built-in default: the same power-of-two ladder
DEFAULT_SHAPES: dict = {
    "source": "built-in default",
    "buckets": [128, 256, 512, 1024, 2048, 4096, 8192],
}

_SHAPES_PATH = os.path.join(os.path.dirname(__file__), "shapes.json")


class ShapeTable:
    """``bucket_for(n, floor)`` returns the smallest configured bucket >= n
    and >= ``floor`` (None beyond the ladder: the kernels then pad to their
    own power of two)."""

    def __init__(self, data: dict):
        buckets = data.get("buckets") or DEFAULT_SHAPES["buckets"]
        self.buckets: list[int] = sorted(
            int(b) for b in buckets if int(b) > 0
        ) or list(DEFAULT_SHAPES["buckets"])
        self.source: str = str(data.get("source", "unknown"))
        self.data = dict(data)

    def bucket_for(self, n_rows: int, floor: int | None = None) -> int | None:
        want = max(n_rows, floor or 0)
        return next((b for b in self.buckets if b >= want), None)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(data, dict) and data.get("buckets"):
        return data
    return None


def load_shape_table() -> ShapeTable:
    """Resolve the table by the precedence above. Never raises: a corrupt
    or missing file yields the next source, last the built-in default."""
    override = os.environ.get("CORDA_TPU_SERVING_SHAPES", "").strip()
    for path in ([override] if override else []) + [_SHAPES_PATH]:
        data = _read_json(path)
        if data is not None:
            data.setdefault("source", path)
            return ShapeTable(data)
    return ShapeTable(dict(DEFAULT_SHAPES))


_cached: ShapeTable | None = None
_cache_lock = threading.Lock()


def shape_table() -> ShapeTable:
    """The process's table, resolved once."""
    global _cached
    if _cached is None:
        with _cache_lock:
            if _cached is None:
                _cached = load_shape_table()
    return _cached
