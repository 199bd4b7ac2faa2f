"""Builds and binds the CUDA kernels in csrc/ (plain C ABI, loaded with ctypes).

``kernels()`` compiles every ``csrc/*.cu`` with nvcc for sm_90a at first use,
one nvcc process per source started together, links them into one shared
library under ``build/kernels/`` at the repository root, and loads it. The
library's name carries a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. ``host_check()`` builds
csrc/host_check.cpp, the kernels' shared arithmetic compiled for the host,
with the system C++ compiler.

Helpers for the wrappers: ``stream_of`` (PyTorch's current stream as a
pointer), ``check_launch`` (raise on a nonzero cudaError_t) and
``count_launch`` (each wrapper's launch counter).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_host_lib = None
_launch_lock = threading.Lock()

# what the last kernels() build did: seconds spent and nvcc's ptxas report
build_info: dict = {}


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(paths):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}"
        )
    return proc.stderr


def _build_cuda(target: Path) -> None:
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        # one nvcc per source, all started together
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for s, o in zip(sources, objs)
        ]
        logs = []
        failed = []
        for s, p in zip(sources, procs):
            _out, err = p.communicate()
            logs.append(err)
            if p.returncode != 0:
                failed.append(f"{s.name}:\n{err[-4000:]}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / target.name
        _run([nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)])
        os.replace(tmp_so, target)
    target.with_suffix(".ptxas.txt").write_text("".join(logs))


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))
        target = BUILD_DIR / f"libcorda_kernels_{_digest(sources, NVCC_FLAGS)}.so"
        t0 = time.perf_counter()
        built = not target.exists()
        if built:
            _build_cuda(target)
        build_info.update(
            seconds=time.perf_counter() - t0, built=built, path=str(target),
            ptxas=target.with_suffix(".ptxas.txt").read_text()
            if target.with_suffix(".ptxas.txt").exists() else "",
        )
        lib = ctypes.CDLL(str(target))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ct_ed25519_challenge.argtypes = [p, p, i, p]
        lib.ct_ed25519_challenge.restype = i
        lib.ct_ed25519_verify_ladder.argtypes = [p, p, p, p, i, i, i, p]
        lib.ct_ed25519_verify_ladder.restype = i
        lib.ct_ed25519_verify_g.argtypes = [p, p, p, p, i, i, i, p]
        lib.ct_ed25519_verify_g.restype = i
        for name in ("ct_ed25519_verify_ladder_smem_bytes", "ct_ed25519_verify_g_smem_bytes",
                     "ct_ecdsa_verify_smem_bytes", "ct_ed25519_challenge_smem_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.ct_fe_chain_probe.argtypes = [p, p, i, i, p]
        lib.ct_fe_chain_probe.restype = i
        lib.ct_comb_chain_probe.argtypes = [p, p, i, p]
        lib.ct_comb_chain_probe.restype = i
        lib.ct_sha256_leaves.argtypes = [p, p, p, p, i, p]
        lib.ct_sha256_leaves.restype = i
        lib.ct_sha256_merkle_sweep.argtypes = [p, p, p, p, p, i, p]
        lib.ct_sha256_merkle_sweep.restype = i
        lib.ct_ed25519_comb.argtypes = [p, p, p, i, p]
        lib.ct_ed25519_comb.restype = i
        for name in ("ct_ecdsa_verify_k1", "ct_ecdsa_verify_r1"):
            getattr(lib, name).argtypes = [p, p, p, i, p]
            getattr(lib, name).restype = i
        lib.ct_sphincs_verify.argtypes = [p, p, p, p, p, i, p]
        lib.ct_sphincs_verify.restype = i
        lib.ct_sphincs_smem_bytes.argtypes = []
        lib.ct_sphincs_smem_bytes.restype = i
        lib.ct_statestore_probe.argtypes = [p, p, i, i, i, i, p, i, p, p]
        lib.ct_statestore_probe.restype = i
        lib.ct_statestore_commit.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p, i, i, p, p, p]
        lib.ct_statestore_commit.restype = i
        lib.ct_statestore_remove.argtypes = [p, p, p, i, i, i, i, p, p, i, p, p]
        lib.ct_statestore_remove.restype = i
        lib.ct_statestore_chase.argtypes = [p, i, p, p]
        lib.ct_statestore_chase.restype = i
        lib.ct_error_string.argtypes = [i]
        lib.ct_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def host_check() -> ctypes.CDLL:
    """csrc/host_check.cpp built with the host C++ compiler (for tests)."""
    global _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = [CSRC / "host_check.cpp", *CSRC.glob("*.cuh")]
        target = BUILD_DIR / f"libhost_check_{_digest(sources, HOST_FLAGS)}.so"
        if not target.exists():
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_so = Path(tmp) / target.name
                _run([cxx, *HOST_FLAGS, "-I", str(CSRC),
                      str(CSRC / "host_check.cpp"), "-o", str(tmp_so)])
                os.replace(tmp_so, target)
        lib = ctypes.CDLL(str(target))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hc_fe_mul.argtypes = [p, p, p]
        lib.hc_fe_mul.restype = None
        for name in ("hc_fe_sq", "hc_fe_inv", "hc_fe_pow_p58", "hc_challenge"):
            getattr(lib, name).argtypes = [p, p]
            getattr(lib, name).restype = None
        lib.hc_decompress.argtypes = [p, p, p]
        lib.hc_decompress.restype = i
        lib.hc_verify.argtypes = [p, p, p, i]
        lib.hc_verify.restype = i
        lib.hc_point.argtypes = [i, i, i, p, p, p]
        lib.hc_point.restype = None
        lib.hc_sha256_blocks.argtypes = [p, i, p]
        lib.hc_sha256_blocks.restype = None
        lib.hc_sha256_leaves.argtypes = [p, p, p, p, i, p]
        lib.hc_sha256_leaves.restype = None
        lib.hc_sha256_lane_order.argtypes = [p, i, i, p]
        lib.hc_sha256_lane_order.restype = None
        lib.hc_challenge_staged.argtypes = [p, i, p]
        lib.hc_challenge_staged.restype = None
        lib.hc_sha512_row_words.argtypes = [p, i, p]
        lib.hc_sha512_row_words.restype = None
        for name in ("hc_sha256_pair", "hc_comb"):
            getattr(lib, name).argtypes = [p, p, p]
            getattr(lib, name).restype = None
        lib.hc_sp_field.argtypes = [i, i, p, p, p]
        lib.hc_sp_field.restype = None
        lib.hc_sp_point.argtypes = [i, p, p, p, p]
        lib.hc_sp_point.restype = None
        lib.hc_ecdsa_verify.argtypes = [i, p, p]
        lib.hc_ecdsa_verify.restype = i
        lib.hc_g_field.argtypes = [i, p, p, p]
        lib.hc_g_field.restype = None
        lib.hc_g_decompress.argtypes = [p, p, p]
        lib.hc_g_decompress.restype = i
        lib.hc_g_verify.argtypes = [p, p, p, i]
        lib.hc_g_verify.restype = i
        for name in ("hc_verify_rule", "hc_g_verify_rule"):
            getattr(lib, name).argtypes = [p, p, p, i, i]
            getattr(lib, name).restype = i
        lib.hc_sphincs_verify.argtypes = [p, p, p, p, i, p, p]
        lib.hc_sphincs_verify.restype = None
        lib.hc_sphincs_layer.argtypes = [p, ctypes.c_int64, i, p, p]
        lib.hc_sphincs_layer.restype = None
        lib.hc_sp_message.argtypes = [i, p, p, p, i, p]
        lib.hc_sp_message.restype = None
        lib.hc_ss_probe.argtypes = [p, p, i, i, i, i, p, i, p]
        lib.hc_ss_probe.restype = None
        lib.hc_ss_commit.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p, p, i, i, p]
        lib.hc_ss_commit.restype = None
        lib.hc_ss_remove.argtypes = [p, p, p, i, i, i, i, p, p, i, p]
        lib.hc_ss_remove.restype = None
        _host_lib = lib
        return lib


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {t.device}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib.ct_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{name} launch failed: cudaError {rc} {msg}")


def count_launch(wrapper) -> None:
    with _launch_lock:
        wrapper.launches += 1
