"""Shared build-on-first-use loader for the port's native (C++) host engines
(counterpart of corda_tpu/native_build.py).

One implementation of the compile-cache-load dance, used by every
ctypes-bound host engine (``messaging/native_queue.py``, ``ops/host_ref.py``):
the library is built with g++ into ``build/native/`` at the repository root
under a name that carries a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is loaded as it is; a temporary file
and an atomic rename keep a concurrent process from loading a half-written
library. These engines run on the host; none of them is a kernel.
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

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
FLAGS = ("-O2", "-std=c++17")


class NativeBuildError(RuntimeError):
    pass


_lock = threading.Lock()


def library_path(src: str | Path, flags: tuple[str, ...] = FLAGS) -> Path:
    """Where ``src`` built with ``flags`` lives: ``build/native/lib<stem>_<hash>.so``."""
    src = Path(src)
    shared = (*flags, "-shared", "-fPIC")
    h = hashlib.sha256(" ".join(shared).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_and_load(src: str | Path, *, flags: tuple[str, ...] = FLAGS,
                   timeout: int = 120) -> ctypes.CDLL:
    """Compile ``src`` into ``build/native/`` unless its library is there
    already, and dlopen it."""
    src = Path(src)
    with _lock:
        if not src.exists():
            raise NativeBuildError(f"missing source {src}")
        target = library_path(src, flags)
        if not target.exists():
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise NativeBuildError("no host C++ compiler found")
            try:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                    tmp_so = Path(tmp) / target.name
                    subprocess.run([cxx, *flags, "-shared", "-fPIC", "-o", str(tmp_so),
                                    str(src)], check=True, capture_output=True,
                                   timeout=timeout)
                    os.replace(tmp_so, target)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                raise NativeBuildError(
                    f"cannot build native engine {src.name}: {e} "
                    f"{detail.decode(errors='replace')}"
                ) from e
        try:
            return ctypes.CDLL(str(target))
        except OSError as e:
            raise NativeBuildError(str(e)) from e
