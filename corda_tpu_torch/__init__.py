"""PyTorch/CUDA port of corda_tpu's batched signature-verification path.

The JAX package ``corda_tpu`` stays the reference; this package is its
counterpart for an NVIDIA H100, with hand-written CUDA kernels in
``csrc/`` and plain PyTorch versions of the same functions beside them.
Module names mirror the reference so each counterpart is easy to find.

Every entry point runs on the card unless the caller passes
``device="cpu"`` (``device.py``). This package imports neither ``jax`` nor
anything of ``corda_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
