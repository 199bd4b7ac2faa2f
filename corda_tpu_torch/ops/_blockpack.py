"""Pad buckets, digest words, pinned staging and the asynchronous
device-result seam.

Counterpart of corda_tpu/ops/_blockpack.py. The JAX handles
(``is_ready``, ``copy_to_host_async``) become CUDA events: a dispatched
result is copied into pinned host memory with a non-blocking copy, and an
event recorded after the copy says when the host may read it.

``staged_dispatch`` is the upload side shared by the verify paths: each
batch is packed into one pinned host plane taken from a pool keyed by
(device, path, bucket) and uploaded in one copy; a plane is handed out
again only after the CUDA event recorded behind the dispatch that read it
has completed.
"""

from __future__ import annotations

import threading

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

    def ready(self) -> bool:
        """Whether ``wait()`` would return at once: the copy's event has
        completed (a CPU result always has)."""
        return self.event is None or bool(self.event.query())

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


# ---------------------------------------------------- pinned staging pool

IN_USE = object()
_staging_lock = threading.Lock()
_staging: dict = {}   # (device, key) -> [[pinned tensor, last event], ...]
_STAGING_SLOTS = 4    # per key: more than the scheduler's pipeline depth (3)


def transfer_done(handle) -> bool:
    """Strict readiness for staging reuse: only a handle whose ``query()``
    says done frees the buffer; an unknown or raising handle reads as not
    done, since "done" licenses the host to overwrite memory the card may
    still be copying."""
    query = getattr(handle, "query", None)
    if query is None:
        return False
    try:
        return bool(query())
    except RuntimeError:
        return False


def acquire_staging(device: torch.device, key, shape: tuple):
    """A zeroed uint8 host plane of ``shape`` and its pool slot (None for a
    CPU dispatch, or when the key's pool is full and a throwaway buffer is
    handed out)."""
    if device.type != "cuda":
        return torch.zeros(shape, dtype=torch.uint8), None
    reuse = None
    with _staging_lock:
        slots = _staging.setdefault((str(device), key), [])
        for slot in slots:
            last = slot[1]
            if last is None or (last is not IN_USE and transfer_done(last)):
                slot[1] = IN_USE
                reuse = slot
                break
        else:
            if len(slots) < _STAGING_SLOTS:
                reuse = [torch.zeros(shape, dtype=torch.uint8, pin_memory=True), IN_USE]
                slots.append(reuse)
                return reuse[0], reuse
    if reuse is None:
        return torch.zeros(shape, dtype=torch.uint8, pin_memory=True), None
    reuse[0].zero_()  # outside the lock: the slot is ours once tagged
    return reuse[0], reuse


def retire_staging(slot, event) -> None:
    """Return a staging buffer to the pool, free again once ``event``
    (recorded after the dispatch that read it) completes."""
    if slot is not None:
        with _staging_lock:
            slot[1] = event


def staged_dispatch(device: torch.device, key, shape: tuple, fill, launch):
    """Pack a batch into a pooled host plane (``fill(plane_numpy)``),
    upload it in one non-blocking copy and enqueue ``launch(plane)`` behind
    it; returns what ``launch`` returns. On the CPU the plane is used in
    place."""
    on_cuda = device.type == "cuda"
    host, slot = acquire_staging(device, key, shape)
    event = None
    try:
        fill(host.numpy())
        plane = host.to(device, non_blocking=True) if on_cuda else host
        out = launch(plane)
        if on_cuda:
            event = record_event(device)
    except BaseException:
        if on_cuda and slot is not None:
            # the copy may still be reading the buffer: free it only behind
            # an event; if none can be recorded, the slot stays retired
            try:
                event = record_event(device)
            except RuntimeError:
                event = IN_USE
        retire_staging(slot, event)
        raise
    retire_staging(slot, event)
    return out


# ----------------------------------------------- digest words to bytes
# (kernel C pads through ops/sha256.py's pack_messages: one ragged launch,
# so the reference's pad_md_blocks and power-of-two bucket_batch have no use)


def words_to_bytes(digest: np.ndarray, digest_bytes: int) -> list[bytes]:
    """(B, digest_bytes // 4) big-endian 32-bit words (uint32, or int32
    holding the same bits) -> per-row byte strings."""
    be = np.ascontiguousarray(digest).view(np.uint32).astype(">u4").tobytes()
    return [be[i * digest_bytes : (i + 1) * digest_bytes] for i in range(len(digest))]
