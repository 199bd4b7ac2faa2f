"""Portable-C ed25519 verify on the host: the measured CPU anchor
(counterpart of corda_tpu/ops/host_ref.py).

The reference's CPU path verifies one ``Signature.verify`` per signature
through the pure-Java i2p EdDSA engine; with no JVM here, BASELINE.md
anchors device throughput to ``native/ed25519_portable.cpp`` instead, a
pure-software scalar engine (radix-2^25.5 field arithmetic, schoolbook
multiplication, a joint bit ladder, no SIMD) compiled -O2. This module binds
the port's copy of it (``corda_tpu_torch/native/ed25519_portable.cpp``),
built on first use with g++ into ``build/native/`` by
``native_build.build_and_load``.

It is a host C loop to time the card against, not a kernel and not a
fallback: no device path calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading
from pathlib import Path

import numpy as np

from ..native_build import NativeBuildError, build_and_load

_SRC = Path(__file__).resolve().parents[1] / "native" / "ed25519_portable.cpp"
_load_lock = threading.Lock()
_lib = None

L = 2**252 + 27742317777372353535851937790883648493

PortableEngineUnavailable = NativeBuildError


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = build_and_load(_SRC)
        lib.ed25519_verify_core.restype = ctypes.c_int
        lib.ed25519_verify_core.argtypes = [ctypes.c_char_p] * 4
        lib.ed25519_verify_loop.restype = ctypes.c_int
        lib.ed25519_verify_loop.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ]
        _lib = lib
        return lib


def _challenge(r: bytes, pk: bytes, msg: bytes) -> bytes:
    h = int.from_bytes(hashlib.sha512(r + pk + msg).digest(), "little") % L
    return h.to_bytes(32, "little")


def verify_one(pk: bytes, sig: bytes, msg: bytes) -> bool:
    """Full RFC 8032 verify through the portable engine (host-side length
    and s < L prechecks, as the JVM wrapper performs before its engine)."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    if int.from_bytes(sig[32:], "little") >= L:
        return False
    lib = _load()
    return bool(lib.ed25519_verify_core(pk, sig[:32], sig[32:], _challenge(sig[:32], pk, msg)))


def verify_loop(pubkeys: list, sigs: list, msgs: list) -> np.ndarray:
    """Sequential one-at-a-time verify over the batch, the timing shape of
    the reference's per-signature loop. Returns the (N,) validity mask."""
    from ..observability.profiler import KERNEL_HOST_REF, active_profiler

    prof = active_profiler()
    if prof is not None and pubkeys:
        # a host loop: no padding, and the result is already there, so the
        # wall clock is the execute time
        return prof.profile(
            KERNEL_HOST_REF, lambda: _verify_loop(pubkeys, sigs, msgs),
            rows=len(pubkeys), bucket=len(pubkeys),
            bytes_in=sum(len(x) for seq in (pubkeys, sigs, msgs) for x in seq),
            bytes_out=len(pubkeys),
        )
    return _verify_loop(pubkeys, sigs, msgs)


def _verify_loop(pubkeys: list, sigs: list, msgs: list) -> np.ndarray:
    n = len(pubkeys)
    pre = np.ones(n, dtype=bool)
    pk_cat, r_cat, s_cat, h_cat = [], [], [], []
    for i in range(n):
        pk, sig, msg = pubkeys[i], sigs[i], msgs[i]
        if len(pk) != 32 or len(sig) != 64 or int.from_bytes(sig[32:], "little") >= L:
            pre[i] = False
            pk_cat.append(b"\0" * 32)
            r_cat.append(b"\0" * 32)
            s_cat.append(b"\0" * 32)
            h_cat.append(b"\0" * 32)
            continue
        pk_cat.append(pk)
        r_cat.append(sig[:32])
        s_cat.append(sig[32:])
        h_cat.append(_challenge(sig[:32], pk, msg))
    lib = _load()
    buf = ctypes.create_string_buffer(n)
    lib.ed25519_verify_loop(b"".join(pk_cat), b"".join(r_cat), b"".join(s_cat),
                            b"".join(h_cat), n, buf)
    return (np.frombuffer(buf.raw, dtype=np.uint8) == 1) & pre
