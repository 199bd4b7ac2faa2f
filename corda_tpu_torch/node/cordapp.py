"""CorDapp discovery and loading (the port's copy of
corda_tpu/node/cordapp.py, import root changed).

Capability parity with the reference's CordappLoader
(node/.../internal/cordapp/CordappLoader.kt:41-63 — scan the node's
``plugins`` directory for JARs, classpath-scan each for contracts,
initiated flows, RPC-startable flows, schemas and services, and record a
``Cordapp`` manifest per JAR). A JAR here is a Python module or package
dropped in the node's ``cordapps`` directory (or named in config):
importing it registers its pieces, and the loader DIFFS the platform
registries around each import to attribute what the app provides —
jar-scanning re-designed around Python's import system instead of
bytecode scanning.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import logging
import sys
from pathlib import Path

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Cordapp:
    """What one app module provides (reference: Cordapp.kt — the manifest
    CordappProviderImpl serves)."""

    name: str
    module: str
    contracts: tuple[str, ...]        # registered contract identifiers
    initiated_flows: tuple[str, ...]  # initiating-flow names with responders
    flow_classes: tuple[str, ...]     # FlowLogic classes defined by the app
    serializable_types: tuple[str, ...]


# app-provided node services: (services-hub attribute name, class).
# Populated at cordapp import time by @CordaService; instantiated per node
# by install_corda_services (reference: @CordaService classes found by the
# cordapp scan and built in AbstractNode.installCordaServices).
_CORDA_SERVICES: list[tuple[str, type]] = []


def CordaService(attr_name: str):
    """Register the decorated class as a node service: every node that
    loads the defining cordapp instantiates it at boot as
    ``services.<attr_name>`` with ``cls(services, party, keypair)``
    (reference: @CordaService + AbstractNode.installCordaServices — the
    oracle-in-a-node pattern, NodeInterestRates.kt:79)."""

    def deco(cls):
        # idempotent AND current: importlib.reload re-runs the decorator
        # with a new class under the SAME module path — that REPLACES
        # the entry so nodes booted after a reload instantiate the
        # reloaded class, not the stale one. The same source file
        # imported under TWO package paths keeps one entry per path
        # (each node's loaded_modules filter must match its own path);
        # install_corda_services recognizes such same-source duplicates
        # at install time instead of mislabelling them collisions.
        for i, (a, c) in enumerate(_CORDA_SERVICES):
            if (
                a == attr_name
                and c.__qualname__ == cls.__qualname__
                and c.__module__ == cls.__module__
            ):
                _CORDA_SERVICES[i] = (attr_name, cls)
                break
        else:
            _CORDA_SERVICES.append((attr_name, cls))
        cls._corda_service_attr = attr_name
        return cls

    return deco


def _same_service_source(a, b) -> bool:
    """Two registry classes that are really one service: same qualname
    and same defining source file (the two-package-path import shape)."""
    if a.__qualname__ != b.__qualname__:
        return False
    import inspect

    try:
        return inspect.getfile(a) == inspect.getfile(b)
    except Exception:
        return False


def install_corda_services(services, party, keypair,
                           loaded_modules=None) -> list[str]:
    """Instantiate registered cordapp services onto a node's ServiceHub.
    ``loaded_modules`` restricts installation to services whose defining
    module is among THIS node's loaded cordapps — the registry is
    process-global, and in multi-node processes (mocknet, tests) a node
    that never loaded the defining app must not acquire its services
    (e.g. an oracle signing under the wrong node's identity). One broken
    service must not stop the boot (mirrors the loader's skip-on-error
    policy)."""
    installed = []
    for attr, cls in _CORDA_SERVICES:
        if loaded_modules is not None and not any(
            cls.__module__ == m or cls.__module__.startswith(m + ".")
            for m in loaded_modules
        ):
            # defined by a cordapp this node did not load (package match
            # includes submodules: myapp/oracle.py belongs to app "myapp")
            continue
        if hasattr(services, attr):
            existing = getattr(services, attr)
            if _same_service_source(type(existing), cls):
                # the same service registered under two import paths —
                # already installed on this hub; benign, not a collision
                continue
            # never let an app shadow a core hub service ("vault_service",
            # "metrics", …) — the node would run with a cordapp object
            # where the vault should be and fail far from the cause
            logger.error(
                "refusing to install corda service %r from %s: the name "
                "collides with an existing ServiceHub attribute",
                attr, cls.__module__,
            )
            continue
        try:
            setattr(services, attr, cls(services, party, keypair))
            installed.append(attr)
        except Exception:
            logger.exception("failed to install corda service %r", attr)
    return installed


def _registry_snapshot():
    from corda_tpu_torch.flows.api import _RESPONDERS
    from corda_tpu_torch.ledger.states import _CONTRACT_REGISTRY
    from corda_tpu_torch.serialization.cbe import _REGISTRY

    return (
        set(_CONTRACT_REGISTRY),
        set(_RESPONDERS),
        set(_REGISTRY),
    )


def _flow_classes_of(module) -> tuple[str, ...]:
    import inspect

    from corda_tpu_torch.flows.api import FlowLogic

    out = []
    for name, obj in inspect.getmembers(module, inspect.isclass):
        if (issubclass(obj, FlowLogic) and obj is not FlowLogic
                and obj.__module__ == module.__name__):
            out.append(f"{obj.__module__}.{name}")
    return tuple(sorted(out))


class CordappLoader:
    """Loads apps and records a manifest per app (reference:
    CordappLoader.createDefault + CordappProviderImpl)."""

    def __init__(self):
        self.cordapps: list[Cordapp] = []

    def load_package(self, package: str) -> Cordapp:
        """Import one app package/module and attribute its registrations."""
        before = _registry_snapshot()
        module = importlib.import_module(package)
        after = _registry_snapshot()
        app = Cordapp(
            name=package.rpartition(".")[2] or package,
            module=package,
            contracts=tuple(sorted(after[0] - before[0])),
            initiated_flows=tuple(sorted(after[1] - before[1])),
            flow_classes=_flow_classes_of(module),
            serializable_types=tuple(sorted(after[2] - before[2])),
        )
        self.cordapps.append(app)
        return app

    def load_directory(self, directory: str | Path) -> list[Cordapp]:
        """Scan a ``cordapps`` directory (the reference's ``plugins`` dir
        scan, CordappLoader.getCordappsInDirectory): every ``*.py`` file
        and every package (directory with ``__init__.py``) is an app."""
        directory = Path(directory)
        if not directory.is_dir():
            return []
        loaded = []
        entries = sorted(directory.iterdir(), key=lambda p: p.name)
        if str(directory) not in sys.path:
            sys.path.insert(0, str(directory))
        for entry in entries:
            name = None
            if entry.suffix == ".py" and not entry.name.startswith("_"):
                name = entry.stem
            elif entry.is_dir() and (entry / "__init__.py").exists():
                name = entry.name
            if name is None:
                continue
            try:
                loaded.append(self.load_package(name))
            except Exception:
                # one broken app must not stop the node boot; mirrors the
                # reference logging and skipping unscannable jars
                logger.exception("failed to load cordapp %r", name)
        return loaded

    # ------------------------------------------------------ provider face
    def contract_attachment_id(self, contract_name: str):
        """The app 'attachment' backing a contract (reference:
        CordappProviderImpl.getContractAttachmentID)."""
        from corda_tpu_torch.ledger.states import contract_code_hash

        for app in self.cordapps:
            if contract_name in app.contracts:
                return contract_code_hash(contract_name)
        return None

    def cordapp_for_contract(self, contract_name: str) -> Cordapp | None:
        for app in self.cordapps:
            if contract_name in app.contracts:
                return app
        return None
