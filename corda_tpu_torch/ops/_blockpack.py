"""Pad buckets, digest words and the asynchronous device-result seam.

Counterpart of corda_tpu/ops/_blockpack.py. The JAX handles
(``is_ready``, ``copy_to_host_async``) become CUDA events: a dispatched
result is copied into pinned host memory with a non-blocking copy, and an
event recorded after the copy says when the host may read it.
"""

from __future__ import annotations

import numpy as np
import torch

# Threads per block of the verify kernels (csrc/*.cu launch 128-thread
# blocks); the smallest pad bucket on the card.
KERNEL_BLOCK_LANES = 128


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_floor(min_bucket: int | None, on_cuda: bool) -> int:
    """Pad-bucket floor: a caller-pinned ``min_bucket`` rounded up to a
    power of two, never below the kernels' lanes per block on the card."""
    if on_cuda:
        return pow2_at_least(min_bucket or 0, KERNEL_BLOCK_LANES)
    return pow2_at_least(min_bucket or 0, 8)


class HostCopy:
    """A device result on its way to host memory: the pinned destination
    and the event recorded after the copy (``None`` for a CPU result,
    which is already there)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def record_event(device: torch.device) -> torch.cuda.Event:
    """An event recorded on ``device``'s current stream, the stream its
    copies and kernels run on (the calling thread's current device may be
    another card)."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def start_host_copy(result: torch.Tensor) -> HostCopy:
    """Start the device-to-host copy of ``result`` on its device's current
    stream so it overlaps later host work; returns the handle to poll."""
    if result.device.type != "cuda":
        return HostCopy(result, None)
    host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    with torch.cuda.device(result.device):
        host.copy_(result, non_blocking=True)
    return HostCopy(host, record_event(result.device))


def result_ready(handle) -> bool:
    """Non-blocking readiness probe: ``torch.cuda.Event.query()`` of the
    handle's event. A handle without an event (host memory, unknown types)
    reads as ready, so collectors degrade to a blocking FIFO collect."""
    event = handle if isinstance(handle, torch.cuda.Event) else getattr(
        handle, "event", None
    )
    if event is None:
        return True
    return bool(event.query())


# ----------------------------------------------- digest words to bytes
# (kernel C pads through ops/sha256.py's pack_messages: one ragged launch,
# so the reference's pad_md_blocks and power-of-two bucket_batch have no use)


def words_to_bytes(digest: np.ndarray, digest_bytes: int) -> list[bytes]:
    """(B, digest_bytes // 4) big-endian 32-bit words (uint32, or int32
    holding the same bits) -> per-row byte strings."""
    be = np.ascontiguousarray(digest).view(np.uint32).astype(">u4").tobytes()
    return [be[i * digest_bytes : (i + 1) * digest_bytes] for i in range(len(digest))]
