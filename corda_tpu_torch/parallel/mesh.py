"""The device mesh and the distributed verification steps (counterpart of
corda_tpu/parallel/mesh.py).

The reference shards a batch over its TPU mesh with ``shard_map``: each
device verifies its shard, the spent-state rows are all-gathered and the
accept count psum'd. Here a mesh is a list of CUDA ordinals, and each step
runs the port's own enqueue path once an ordinal, on that ordinal's
device: kernel A then the tier's ladder (kernel B or G) for ed25519,
kernel F for ECDSA, kernel H for SPHINCS. The collectives become torch
ops: the all-gather is a ``torch.cat`` of the shards onto each ordinal, the
psum a sum of the per-shard counts.

The mesh's ed25519 rule is the reference's: ``ed25519_verify_core``, the
per-signature rule without the cofactor, so B and G launch without their
cofactored end. Full buckets never reach the mesh: the dispatch sends them
to the cofactored rule first.

Ordinals. ``device_for_ordinal`` is the one translation point from an
ordinal to a ``torch.device``; every other module reads ordinals through
it. The visible ordinals are the CUDA devices, unless a list of logical
devices was set (``set_logical_devices``): the tests run eight logical
ordinals on the CPU (``torch.device("cpu", i)``), as the reference's tests
run eight virtual XLA devices, and ``chip_smoke.py`` runs two logical
ordinals on one card. A logical mesh on one card measures no collective
across cards.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops._blockpack import bucket_floor, pow2_at_least, start_host_copy

# ------------------------------------------------------------ ordinals

_logical_devices: list[torch.device] | None = None


def set_logical_devices(devices) -> None:
    """Substitute a list of logical devices for the CUDA devices (ordinal i
    is ``devices[i]``); None restores the CUDA devices. The service mesh's
    verifier is rebuilt on the next use."""
    global _logical_devices, _mesh_verifier_singleton
    _logical_devices = None if devices is None else [torch.device(d) for d in devices]
    _mesh_verifier_singleton = None


def visible_devices() -> list[torch.device]:
    """One device an ordinal: the logical list when set, else the CUDA
    devices (none without a card)."""
    if _logical_devices is not None:
        return list(_logical_devices)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def device_for_ordinal(ordinal: int) -> torch.device:
    """The device of ``ordinal``. Raises ``KeyError`` for an unknown
    ordinal, which callers treat as a dead device."""
    devs = visible_devices()
    o = int(ordinal)
    if not 0 <= o < len(devs):
        raise KeyError(f"no visible device with ordinal {ordinal}")
    return devs[o]


class Mesh:
    """An ordered list of ordinals and their devices (the reference's one
    ``batch`` axis)."""

    __slots__ = ("ordinals", "devices")

    def __init__(self, ordinals: list[int]):
        self.ordinals = [int(o) for o in ordinals]
        self.devices = [device_for_ordinal(o) for o in self.ordinals]

    @property
    def n_devices(self) -> int:
        return len(self.ordinals)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The first ``n_devices`` visible ordinals (all of them when None)."""
    n_vis = len(visible_devices())
    n = n_devices or n_vis
    if n > n_vis or n < 1:
        raise ValueError(f"requested {n} devices, have {n_vis}")
    return Mesh(list(range(n)))


def shard_bounds(mesh: Mesh, b: int) -> list[tuple[int, int]]:
    """The contiguous lane range of each ordinal for a batch of ``b`` lanes
    (``b`` must divide evenly, as ``shard_map`` requires)."""
    if b % mesh.n_devices:
        raise ValueError(f"batch of {b} lanes does not divide over {mesh.n_devices} devices")
    s = b // mesh.n_devices
    return [(k * s, (k + 1) * s) for k in range(mesh.n_devices)]


def _on_shards(mesh: Mesh, n: int, b: int, enqueue) -> list[torch.Tensor]:
    """``enqueue(lo, hi, device, lanes)`` for each shard holding real rows
    (rows lo..hi of the batch); a shard of padding alone is all False, as
    the reference's padded lanes (their precheck fails). Returns each
    shard's (lanes,) bool mask on its device."""
    out = []
    for (lo, hi), dev in zip(shard_bounds(mesh, b), mesh.devices):
        lanes = hi - lo
        real = min(hi, n) - lo
        if real > 0:
            out.append(enqueue(lo, lo + real, dev, lanes)[:lanes])
        else:
            out.append(torch.zeros(lanes, dtype=torch.bool, device=dev))
    return out


def _gather(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def distributed_verify_step(mesh: Mesh, with_spent: bool = True, tier=None):
    """The sharded ed25519 step for ``mesh``: ``step(pubkeys, signatures,
    messages, b[, spent])`` over a batch padded to ``b`` lanes.

    Each ordinal runs ``_verify_prep_enqueue`` on its shard (kernel A, then
    the ladder of ``tier``, without the cofactored end). With ``with_spent``
    (the notary-commit shape) ``spent`` is the (b, 8) int32 host array of
    the rows each signature's transaction consumes; it is uploaded a shard
    an ordinal and all-gathered (``torch.cat`` onto each ordinal), and the
    accept count is psum'd. Returns (mask, spent_all, total), the mask and
    ``spent_all`` on the first ordinal's device, ``total`` a device scalar
    there; ``spent_all_by_ordinal`` of the step holds each ordinal's copy of
    the last gather. Without ``with_spent`` the step returns the mask alone:
    no collective."""
    from ..ops.ed25519 import DEFAULT_TIER, _verify_prep_enqueue

    tier = tier or DEFAULT_TIER
    dev0 = mesh.devices[0]

    def shards(pubkeys, signatures, messages, b):
        return _on_shards(mesh, len(pubkeys), b, lambda lo, hi, dev, lanes: _verify_prep_enqueue(
            pubkeys[lo:hi], signatures[lo:hi], messages[lo:hi], device=dev,
            min_bucket=lanes, tier=tier, cofactored=False))

    if not with_spent:
        def step_mask(pubkeys, signatures, messages, b):
            return _gather(shards(pubkeys, signatures, messages, b), dev0)

        return step_mask

    def step(pubkeys, signatures, messages, b, spent):
        parts = shards(pubkeys, signatures, messages, b)
        spent_parts = [torch.from_numpy(np.ascontiguousarray(spent[lo:hi])).to(dev)
                       for (lo, hi), dev in zip(shard_bounds(mesh, b), mesh.devices)]
        # the all-gather: every ordinal holds the whole consumed-set delta
        step.spent_all_by_ordinal = [_gather(spent_parts, dev) for dev in mesh.devices]
        # the psum: each shard's accept count, summed onto each ordinal
        counts = [p.sum(dtype=torch.int32) for p in parts]
        total = torch.stack([c.to(dev0) for c in counts]).sum(dtype=torch.int32)
        return _gather(parts, dev0), step.spent_all_by_ordinal[0], total

    step.spent_all_by_ordinal = []
    return step


def distributed_ecdsa_step(mesh: Mesh, curve_name: str):
    """The sharded ECDSA step for ``mesh``: ``step(pubkeys, signatures,
    messages, b)`` runs ``ecdsa_verify_dispatch`` (kernel F) a shard on each
    ordinal and returns the (b,) bool mask on the first ordinal's device.
    Verdicts only: the spent-row gather rides the ed25519 step."""
    from ..ops.secp256 import ecdsa_verify_dispatch

    def step(pubkeys, signatures, messages, b):
        return _gather(_on_shards(
            mesh, len(pubkeys), b,
            lambda lo, hi, dev, lanes: ecdsa_verify_dispatch(
                curve_name, pubkeys[lo:hi], signatures[lo:hi], messages[lo:hi],
                min_bucket=lanes, device=dev)), mesh.devices[0])

    return step


class _AllEvents:
    """The CUDA events of several host copies as one handle."""

    __slots__ = ("_events",)

    def __init__(self, events):
        self._events = events

    def query(self) -> bool:
        return all(e.query() for e in self._events)

    def synchronize(self) -> None:
        for e in self._events:
            e.synchronize()


class _ChunkedCopy:
    """The host copies of a ``ChunkedMask``'s parts, read as one mask."""

    __slots__ = ("_parts", "_n", "event")

    def __init__(self, parts, n: int):
        self._parts = [(lo, hi, start_host_copy(m)) for lo, hi, m in parts]
        self._n = n
        events = [h.event for _lo, _hi, h in self._parts if h.event is not None]
        self.event = _AllEvents(events) if events else None

    def ready(self) -> bool:
        return all(h.ready() for _lo, _hi, h in self._parts)

    def wait(self) -> np.ndarray:
        out = np.zeros(self._n, dtype=bool)
        for lo, hi, h in self._parts:
            out[lo:hi] = h.wait()[: hi - lo]
        return out


class ChunkedMask:
    """A verdict mask assembled from per-ordinal chunk dispatches (the
    SPHINCS fan-out): ``parts`` are (lo, hi, device mask). ``np.asarray``
    gives the (n,) mask; ``host_copy()`` starts every part's copy."""

    __slots__ = ("_parts", "_n")

    def __init__(self, parts: list, n: int):
        self._parts = parts
        self._n = n

    @property
    def shape(self) -> tuple[int]:
        return (self._n,)

    @property
    def parts(self) -> list:
        return list(self._parts)

    def host_copy(self) -> _ChunkedCopy:
        return _ChunkedCopy(self._parts, self._n)

    def __array__(self, dtype=None, copy=None):
        out = self.host_copy().wait()
        return out if dtype is None else out.astype(dtype)


# ------------------------------------------------------------ service tier

_service_mesh_enabled: bool | None = None


def enable_service_mesh(on: bool | None = True) -> None:
    """Force the service-tier mesh routing on or off (None: back to the
    rule of ``service_mesh_active``)."""
    global _service_mesh_enabled, _mesh_verifier_singleton
    _service_mesh_enabled = on
    _mesh_verifier_singleton = None


def mesh_switch(forced: bool | None, env: str, device=None) -> bool:
    """The one rule behind the mesh's switches (the service tier's
    ``CORDA_TPU_SERVICE_MESH``, the scheduler's ``CORDA_TPU_MESH``):
    ``forced`` when not None, else the environment variable ``env`` (1,
    true, on, yes / 0, false, off, no), else on exactly when more than one
    CUDA device is visible and ``device``, where given, is a CUDA device."""
    if forced is not None:
        return bool(forced)
    word = os.environ.get(env, "").strip().lower()
    if word in ("1", "true", "on", "yes"):
        return True
    if word in ("0", "false", "off", "no"):
        return False
    if device is not None and torch.device(device).type != "cuda":
        return False
    return torch.cuda.is_available() and torch.cuda.device_count() > 1


def service_mesh_active() -> bool:
    """Route service signature batches through the mesh (``mesh_switch``
    over ``enable_service_mesh`` and ``CORDA_TPU_SERVICE_MESH``). One card
    keeps the plain dispatch."""
    return mesh_switch(_service_mesh_enabled, "CORDA_TPU_SERVICE_MESH")


_mesh_verifier_singleton = None


def service_mesh_verifier() -> "MeshVerifier":
    global _mesh_verifier_singleton
    if _mesh_verifier_singleton is None:
        _mesh_verifier_singleton = MeshVerifier()
    return _mesh_verifier_singleton


class MeshVerifier:
    """Data-parallel signature verification over the mesh: one batch is
    split over every ordinal, each verifies its shard, and the consumed
    input-state rows are all-gathered so every ordinal (and the host) holds
    the batch's whole spent-set delta for a notary commit."""

    def __init__(self, mesh: Mesh | None = None, tier=None):
        self.mesh = mesh or make_mesh()
        self.n_devices = self.mesh.n_devices
        self.tier = tier
        self._step_mask = distributed_verify_step(self.mesh, with_spent=False, tier=tier)
        self._step_spent = distributed_verify_step(self.mesh, with_spent=True, tier=tier)
        self._ecdsa_steps: dict[str, object] = {}

    def _on_cuda(self) -> bool:
        return self.mesh.devices[0].type == "cuda"

    def _bucket(self, n: int, min_bucket: int | None) -> int:
        return pow2_at_least(max(n, 1), max(min_bucket or 0, 8 * self.n_devices))

    def _ordinals(self) -> list[int]:
        return list(self.mesh.ordinals)

    def _record_shard(self, rows: int, padded_lanes: int) -> None:
        """Per-ordinal devicemon attribution of one sharded dispatch, after
        the enqueue (a failing dispatch never inflates the counts)."""
        from ..observability.devicemon import active_devicemon

        mon = active_devicemon()
        if mon is not None:
            mon.record_sharded_dispatch(self._ordinals(), rows=rows, padded_lanes=padded_lanes)

    def dispatch_rows(self, pubkeys: list[bytes], signatures: list[bytes],
                      messages: list[bytes], min_bucket: int | None = None,
                      spent_hashes=None):
        """Enqueue the sharded ed25519 step without waiting: returns (mask,
        spent_all, total) device values; slice the mask ``[:len(pubkeys)]``
        after the copy back. ``spent_hashes``: optional (N, 8) int32 rows,
        all-gathered; without them the mask-only step runs (no collective)
        and spent_all and total are None."""
        n = len(pubkeys)
        b = self._bucket(n, min_bucket)
        if spent_hashes is None:
            result = self._step_mask(pubkeys, signatures, messages, b), None, None
            self._record_shard(n, b)
            return result
        spent = np.zeros((b, 8), np.int32)
        spent[:n] = spent_hashes
        result = self._step_spent(pubkeys, signatures, messages, b, spent)
        self._record_shard(n, b)
        return result

    @property
    def spent_all_by_ordinal(self) -> list[torch.Tensor]:
        """Each ordinal's copy of the last all-gathered spent rows."""
        return self._step_spent.spent_all_by_ordinal

    def dispatch_ecdsa_rows(self, curve_name: str, pubkeys: list[bytes],
                            signatures: list[bytes], messages: list[bytes],
                            min_bucket: int | None = None) -> torch.Tensor:
        """Shard an ECDSA bucket over the mesh (kernel F on each ordinal):
        returns the bucket-padded (B,) bool mask. Each shard is at least the
        kernels' floor wide (128 lanes on the card, 8 on the CPU)."""
        n = len(pubkeys)
        per_dev = bucket_floor(None, self._on_cuda())
        b = pow2_at_least(max(n, 1), max(min_bucket or 0, per_dev * self.n_devices))
        step = self._ecdsa_steps.get(curve_name)
        if step is None:
            step = self._ecdsa_steps[curve_name] = distributed_ecdsa_step(self.mesh, curve_name)
        result = step(pubkeys, signatures, messages, b)
        self._record_shard(n, b)
        return result

    def dispatch_sphincs_rows(self, pubkeys: list[bytes], signatures: list[bytes],
                              messages: list[bytes], min_bucket: int | None = None) -> ChunkedMask:
        """Fan a SPHINCS bucket out over the ordinals by contiguous lane
        chunks, one ``sphincs_verify_dispatch`` (kernel H) an ordinal, with
        the reference's chunking: at least 4 lanes a chunk, a fixed chunk of
        ceil(n / n_chunks) (the last one short)."""
        from ..observability.devicemon import active_devicemon
        from ..ops.sphincs_batch import sphincs_verify_dispatch

        n = len(pubkeys)
        n_chunks = max(1, min(self.n_devices, (n + 3) // 4))
        step = -(-n // n_chunks)
        bounds = [(c * step, min(n, (c + 1) * step)) for c in range(n_chunks)]
        mon = active_devicemon()
        parts: list = []
        for ordinal, dev, (lo, hi) in zip(self.mesh.ordinals, self.mesh.devices, bounds):
            if hi <= lo:
                continue
            parts.append((lo, hi, sphincs_verify_dispatch(
                pubkeys[lo:hi], signatures[lo:hi], messages[lo:hi],
                min_bucket=min_bucket, device=dev)))
            if mon is not None:
                # after the enqueue; lanes report as rows, as the reference's
                mon.record_dispatch(ordinal, rows=hi - lo, padded_lanes=hi - lo,
                                    track_inflight=False)
        return ChunkedMask(parts, n)
