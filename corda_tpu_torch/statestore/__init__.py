"""The device-resident state store (counterpart of corda_tpu/statestore).

The authoritative "is this state consumed?" set, moved from a host dict
into the card's memory: ``DeviceShardedTable`` is the open-addressing
table (kernels I, J and K of ``ops/statestore.py``),
``DeviceShardedUniquenessProvider`` the notary backend that conflict-checks
and commits a whole window in one device round trip, ``DeviceVaultIndex``
the vault's unconsumed-ref membership and owner-bucket index. A
``durability.DurableStore`` is the recovery tier beneath the provider.

Gated, as in the reference: ``CORDA_TPU_STATESTORE=1`` (or
``configure_statestore`` in process). While it is off nothing costs
anything: importing this package allocates no tensor, builds no kernel
and registers no metric; ``statestore_section()`` reports
``{"enabled": False}``. The table geometry defaults to
``CORDA_TPU_STATESTORE_SLOTS`` (4,096) slots and a probe window of
``CORDA_TPU_STATESTORE_PROBE`` (32) slots. The table is one shard on one
card, or one shard an ordinal of a ``parallel.mesh.Mesh`` given to it (the
reference's sharding over its mesh). A uniqueness provider registers the
mega-batch screen (``set_mega_screen``): the serving scheduler probes a
fused mega-batch's all-gathered consumed rows through it on the card
(kernel I) and harvests the count at settle.
"""

from __future__ import annotations

import itertools
import os
import weakref

_env_checked = False
_enabled = False
_slots_per_shard: int | None = None
_max_probe: int | None = None

# the live tables of this process, in the order they were built (only
# enabled owners build tables, so this stays empty, and the section
# {"enabled": False}, while the gate is off). Weak: the registry never keeps
# a table's tensors on the card after its owner has gone.
_TABLES: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_table_ids = itertools.count()

# the uniqueness provider's mega-batch screen (None until one registers)
_mega_screen = None


def set_mega_screen(fn) -> None:
    """Register (or clear, with None) the mega-batch screen."""
    global _mega_screen
    _mega_screen = fn


def active_mega_screen():
    return _mega_screen


def statestore_enabled() -> bool:
    """The ``CORDA_TPU_STATESTORE`` gate, read once."""
    global _env_checked, _enabled
    if not _env_checked:
        _enabled = os.environ.get(
            "CORDA_TPU_STATESTORE", ""
        ).strip().lower() in ("1", "true", "yes", "on")
        _env_checked = True
    return _enabled


def configure_statestore(enabled: bool | None = None,
                         slots_per_shard: int | None = None,
                         max_probe: int | None = None) -> None:
    """In-process override of the gate and the table geometry (tests,
    embedders). Tables already built keep theirs."""
    global _env_checked, _enabled, _slots_per_shard, _max_probe
    if enabled is not None:
        _enabled = bool(enabled)
        _env_checked = True
    if slots_per_shard is not None:
        _slots_per_shard = int(slots_per_shard)
    if max_probe is not None:
        _max_probe = int(max_probe)


def default_slots_per_shard() -> int:
    if _slots_per_shard is not None:
        return _slots_per_shard
    return int(os.environ.get("CORDA_TPU_STATESTORE_SLOTS", "4096"))


def default_max_probe() -> int:
    if _max_probe is not None:
        return _max_probe
    return int(os.environ.get("CORDA_TPU_STATESTORE_PROBE", "32"))


def _register_table(table) -> int:
    key = next(_table_ids)
    _TABLES[key] = table
    return key


def _unregister_table(key: int) -> None:
    _TABLES.pop(key, None)


def statestore_section() -> dict:
    """Monitoring section: ``{"enabled": False}`` while no table is live."""
    tables = list(_TABLES.values())
    if not tables:
        return {"enabled": False}
    from ..node.monitoring import node_metrics

    return {
        "enabled": True,
        "tables": [t.stats() for t in tables],
        "metrics": node_metrics().section("statestore."),
    }


def maybe_vault_index(device=None):
    """A fresh ``DeviceVaultIndex`` on ``device`` (the card unless
    ``device="cpu"``) when the gate is on, else None: the vault's hook at
    construction."""
    if not statestore_enabled():
        return None
    from .vault_index import DeviceVaultIndex

    return DeviceVaultIndex(device=device)


def __getattr__(name: str):
    # lazy re-exports: importing the package while the gate is off pulls in
    # no table code
    if name in ("DeviceShardedTable", "DeviceTableLostError", "TOMBSTONE",
                "key_rows", "payload_rows"):
        from . import table as _t

        return getattr(_t, name)
    if name in ("DeviceShardedUniquenessProvider", "StateStoreSpillError"):
        from . import provider as _p

        return getattr(_p, name)
    if name == "DeviceVaultIndex":
        from .vault_index import DeviceVaultIndex

        return DeviceVaultIndex
    raise AttributeError(name)


__all__ = [
    "active_mega_screen",
    "set_mega_screen",
    "DeviceShardedTable",
    "DeviceShardedUniquenessProvider",
    "DeviceTableLostError",
    "DeviceVaultIndex",
    "StateStoreSpillError",
    "TOMBSTONE",
    "configure_statestore",
    "default_max_probe",
    "default_slots_per_shard",
    "key_rows",
    "maybe_vault_index",
    "payload_rows",
    "statestore_enabled",
    "statestore_section",
]
