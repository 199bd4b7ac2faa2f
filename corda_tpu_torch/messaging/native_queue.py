"""ctypes binding for the C++ durable queue engine (counterpart of
corda_tpu/messaging/native_queue.py, over the port's own copy of its source,
``corda_tpu_torch/native/queue_engine.cpp``).

``NativeQueueBroker`` is interface-compatible with
:class:`corda_tpu_torch.messaging.queue.DurableQueueBroker` (publish / consume /
ack / nack / close, same Message type), so ``BrokerMessagingClient`` and
the flow engine run unchanged on top of it. The native engine holds queue
state in memory with an append-only journal for crash recovery — the
single-process throughput tier (the sqlite broker remains the
cross-process shared-fabric option).

The shared library builds on first use with g++ into ``build/native/`` at
the repository root (its name carries a hash of the source and flags, so a
changed source rebuilds); environments without a toolchain raise
``NativeEngineUnavailable`` so callers can fall back to the sqlite broker.
It is a host broker choice and has nothing to do with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from .queue import Message, QueueClosedError

_SRC = Path(__file__).resolve().parents[1] / "native" / "queue_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_build_lock = threading.Lock()
_lib = None


class NativeEngineUnavailable(RuntimeError):
    pass


def _build() -> Path:
    """Compile the engine into ``BUILD_DIR`` unless this source's library is
    there already; a temporary file and an atomic rename keep a concurrent
    process from loading a half-written library."""
    if not _SRC.exists():
        raise NativeEngineUnavailable(f"missing source {_SRC}")
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeEngineUnavailable("no host C++ compiler found")
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    target = BUILD_DIR / f"libqueue_engine_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_so = Path(tmp) / target.name
            subprocess.run([cxx, *_FLAGS, "-o", str(tmp_so), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_so, target)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeEngineUnavailable(
            f"cannot build native engine {_SRC.name}: {e} {detail.decode(errors='replace')}"
        ) from e
    return target


def _load():
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except OSError as e:
            raise NativeEngineUnavailable(str(e)) from e
        lib.ctq_open.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                 ctypes.c_int]
        lib.ctq_open.restype = ctypes.c_int64
        lib.ctq_publish.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.ctq_publish.restype = ctypes.c_int
        lib.ctq_consume.argtypes = [
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.ctq_consume.restype = ctypes.POINTER(ctypes.c_char)
        lib.ctq_ack.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.ctq_ack.restype = ctypes.c_int
        lib.ctq_nack.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.ctq_nack.restype = ctypes.c_int
        lib.ctq_depth.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.ctq_depth.restype = ctypes.c_int64
        lib.ctq_queues.argtypes = [ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_uint32)]
        lib.ctq_queues.restype = ctypes.POINTER(ctypes.c_char)
        lib.ctq_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.ctq_free.restype = None
        lib.ctq_close.argtypes = [ctypes.c_int64]
        lib.ctq_close.restype = None
        _lib = lib
        return lib


def native_engine_available() -> bool:
    try:
        _load()
        return True
    except NativeEngineUnavailable:
        return False


class NativeQueueBroker:
    """Drop-in replacement for DurableQueueBroker backed by the C++
    engine."""

    def __init__(self, path: str = ":memory:", visibility_s: float = 30.0,
                 fsync_each: bool = False):
        self._lib = _load()
        self._handle = self._lib.ctq_open(
            path.encode(), float(visibility_s), 1 if fsync_each else 0
        )
        if not self._handle:
            raise NativeEngineUnavailable(f"engine rejected journal {path!r}")
        self._closed = False

    # ----------------------------------------------------------- publish
    def publish(self, queue: str, payload: bytes, *,
                msg_id: str | None = None, sender: str = "",
                reply_to: str = "") -> str:
        if self._closed:
            raise QueueClosedError("broker closed")
        msg_id = msg_id or Message.fresh_id()
        ok = self._lib.ctq_publish(
            self._handle, queue.encode(), msg_id.encode(), sender.encode(),
            reply_to.encode(), payload, len(payload),
        )
        if not ok:
            raise QueueClosedError("broker closed")
        return msg_id

    # ----------------------------------------------------------- consume
    def consume(self, queue: str, timeout: float | None = None) -> Message | None:
        if self._closed:
            raise QueueClosedError("broker closed")
        out_len = ctypes.c_uint32(0)
        ptr = self._lib.ctq_consume(
            self._handle, queue.encode(),
            -1.0 if timeout is None else float(timeout),
            ctypes.byref(out_len),
        )
        if not ptr:
            if self._closed:
                raise QueueClosedError("broker closed")
            return None
        try:
            raw = ctypes.string_at(ptr, out_len.value)
        finally:
            self._lib.ctq_free(ptr)
        pos = 0

        def take():
            nonlocal pos
            n = int.from_bytes(raw[pos:pos + 4], "little")
            pos += 4
            chunk = raw[pos:pos + n]
            pos += n
            return chunk

        msg_id = take().decode()
        sender = take().decode()
        reply_to = take().decode()
        redelivered = raw[pos] == 1
        pos += 1
        enqueued_us = int.from_bytes(raw[pos:pos + 8], "little")
        pos += 8
        payload = take()
        return Message(
            queue=queue, payload=payload, msg_id=msg_id, sender=sender,
            reply_to=reply_to, enqueued_at=enqueued_us / 1e6,
            redelivered=redelivered,
        )

    # --------------------------------------------------------------- ack
    def ack(self, msg_id: str) -> None:
        self._lib.ctq_ack(self._handle, msg_id.encode())

    def nack(self, msg_id: str) -> None:
        self._lib.ctq_nack(self._handle, msg_id.encode())

    def depth(self, queue: str) -> int:
        return self._lib.ctq_depth(self._handle, queue.encode())

    queue_depth = depth  # legacy alias

    def queues(self) -> list[str]:
        out_len = ctypes.c_uint32(0)
        ptr = self._lib.ctq_queues(self._handle, ctypes.byref(out_len))
        if not ptr:
            return []
        try:
            raw = ctypes.string_at(ptr, out_len.value)
        finally:
            self._lib.ctq_free(ptr)
        return sorted(raw.decode().split("\n")) if raw else []

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.ctq_close(self._handle)


def make_broker(path: str = ":memory:", visibility_s: float = 30.0,
                prefer_native: bool = True, shared: bool | None = None):
    """Best engine for the job. The native C++ engine keeps queue state in
    process memory (journal for crash recovery) — it must NOT back a file
    shared between processes, so file paths default to the sqlite broker
    (cross-process safe) unless ``shared=False`` asserts single-process
    ownership."""
    single_process = path == ":memory:" or shared is False
    if prefer_native and single_process:
        try:
            return NativeQueueBroker(path, visibility_s)
        except NativeEngineUnavailable:
            pass
    from .queue import DurableQueueBroker

    return DurableQueueBroker(path, visibility_s)
