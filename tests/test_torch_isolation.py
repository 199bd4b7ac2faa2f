"""The port imports neither JAX nor anything of the reference package, nor
the ``cryptography`` package the card's machine may lack: a subprocess
imports every module of corda_tpu_torch and chip_smoke.py with
``jax``/``jaxlib``, ``corda_tpu``/``corda_tpu.*`` and ``cryptography``
blocked (and not ``corda_tpu_torch``), and an AST scan finds no such import
in any port file."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "corda_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "corda_tpu", "cryptography")

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import corda_tpu_torch
names = ["chip_smoke"]
for mod in pkgutil.walk_packages(corda_tpu_torch.__path__, "corda_tpu_torch."):
    names.append(mod.name)
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
for probe in ("jax", "corda_tpu.ops", "cryptography"):
    try:
        importlib.import_module(probe)
    except ImportError:
        pass
    else:
        raise AssertionError(f"the blocker let {probe} through")
for new in ("corda_tpu_torch.notary.service", "corda_tpu_torch.notary.uniqueness",
            "corda_tpu_torch.ops.sha256", "corda_tpu_torch.ops.txid",
            "corda_tpu_torch.ops.ed25519_sign", "corda_tpu_torch.ledger.wire",
            "corda_tpu_torch.serialization.cbe", "corda_tpu_torch.finance.contracts",
            "corda_tpu_torch.crypto.ecdsa_host", "corda_tpu_torch.ops.secp256",
            "corda_tpu_torch.ops.secp256_ladder", "corda_tpu_torch.ops.ed25519_ladder4096",
            "corda_tpu_torch.ledger.ledger_tx", "corda_tpu_torch.compare_sass",
            "corda_tpu_torch.parallel", "corda_tpu_torch.parallel.wavefront",
            "corda_tpu_torch.testing", "corda_tpu_torch.testing.generated_ledger",
            "corda_tpu_torch.crypto.rsa", "corda_tpu_torch.crypto.sphincs",
            "corda_tpu_torch.ops.sphincs_batch", "corda_tpu_torch.batchverify.bls",
            "corda_tpu_torch.batchverify.qc", "corda_tpu_torch.ledger.attachment_code",
            "corda_tpu_torch.ledger.filtered", "corda_tpu_torch.verifier.service",
            "corda_tpu_torch.testing.service_stream", "corda_tpu_torch.notary.raft",
            "corda_tpu_torch.notary.raft_storage", "corda_tpu_torch.notary.bft",
            "corda_tpu_torch.faultinject.chaos", "corda_tpu_torch.samples",
            "corda_tpu_torch.samples.notary_demo", "corda_tpu_torch.samples.trader_demo",
            "corda_tpu_torch.verifier.worker", "corda_tpu_torch.durability",
            "corda_tpu_torch.durability.wal", "corda_tpu_torch.durability.snapshot",
            "corda_tpu_torch.durability.store", "corda_tpu_torch.messaging.netstats",
            "corda_tpu_torch.messaging.native_queue", "corda_tpu_torch.observability.lockwatch",
            "corda_tpu_torch.observability.contention", "corda_tpu_torch.observability.flowprof",
            "corda_tpu_torch.observability.cluster", "corda_tpu_torch.observability.devicemon",
            "corda_tpu_torch.observability.timeseries", "corda_tpu_torch.observability.sampler",
            "corda_tpu_torch.observability.causal", "corda_tpu_torch.observability.slo",
            "corda_tpu_torch.observability.exposition", "corda_tpu_torch.tools.loadharness"):
    assert new in names, new
print("imported", len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("imported"), proc.stdout


def _imported_roots(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module)
    return roots


def test_no_port_file_names_jax_or_the_reference():
    assert len(PORT_FILES) > 10
    for path in PORT_FILES:
        for name in _imported_roots(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "corda_tpu", "cryptography"), (path, name)
