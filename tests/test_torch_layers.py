"""The host observability layers of both packages together: the shared
helpers every ``test_torch_*`` file of these layers imports, the hooks
through a real payment, and the hygiene of the process-global state.

- ``LAYERS`` holds each package's layer modules; ``layers_off`` turns every
  layer of both packages off with ``reset=True``, uninstalls contention and
  lockwatch, stops the timeline, SLO and sampler threads, and removes the
  ``slo.*``/``device.*`` registry names a test added (the reference's own
  ``test_devicemon.py::TestOffByDefault`` reads those families). The
  ``clean_layers`` fixture runs it after every test of the files that
  import it.
- Hooks: a ``CashPaymentFlow`` over both packages' mock networks (the
  port's on ``device="cpu"``) with every layer on: it pays as with the
  layers off, books the same flow classes and phase names, each class's
  phases summing to its wall within 5%, and ``monitoring_snapshot()`` has
  the reference's keys, ``profiler`` and ``resilience`` included; the overload
  governor suspects a partitioned edge through ``sync_net_events``.
- Off by default, in fresh subprocesses: a real flow with every layer off
  adds no registry name of a layer, no thread and no lock patch, and the
  hooks hand back their shared no-op objects; ``CORDA_TPU_CONTENTION=1``
  times the engine's SMM monitor as ``engine.smm``.
- Hygiene: a subprocess turns every layer of both packages on, runs a
  payment on each, runs ``layers_off`` and then the reference's
  ``TestOffByDefault`` checks, which must pass."""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest
import torch


def _modules(root: str) -> types.SimpleNamespace:
    """The layer modules of package ``root`` (by ``importlib``: a package
    attribute such as ``observability.contention`` names a function)."""
    mods = {
        "netstats": "messaging.netstats", "flowprof": "observability.flowprof",
        "contention": "observability.contention", "lockwatch": "observability.lockwatch",
        "cluster": "observability.cluster", "slo": "observability.slo",
        "timeseries": "observability.timeseries", "sampler": "observability.sampler",
        "causal": "observability.causal", "devicemon": "observability.devicemon",
        "exposition": "observability.exposition", "monitoring": "node.monitoring",
        "overload": "flows.overload", "engine": "flows.engine", "wal": "durability.wal",
        "native_queue": "messaging.native_queue", "queue": "messaging.queue",
    }
    return types.SimpleNamespace(
        name="ref" if root == "corda_tpu" else "port", root=root,
        **{k: importlib.import_module(f"{root}.{v}") for k, v in mods.items()})


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAYERS = {"ref": _modules("corda_tpu"), "port": _modules("corda_tpu_torch")}

# the families the reference's devicemon test reads from the registry
_LEAKY = ("slo.", "device.")


def registry_names() -> dict:
    return {k: set(L.monitoring.node_metrics().snapshot()) for k, L in LAYERS.items()}


def layers_off(before: dict | None = None) -> None:
    """Every layer of both packages off and reset, contention and lockwatch
    uninstalled, no monitor thread left; with ``before`` (from
    ``registry_names``), the ``slo.*``/``device.*`` names added since are
    removed from each package's process registry."""
    for L in LAYERS.values():
        L.contention.uninstall()
        L.lockwatch.uninstall()
        L.lockwatch.reset()
        L.contention.configure_contention(enabled=False, reset=True)
        L.netstats.configure_netstats(enabled=False, reset=True)
        L.flowprof.configure_flowprof(enabled=False, reset=True)
        L.cluster.configure_cluster(enabled=False, reset=True)
        L.timeseries.configure_timeline(enabled=False, reset=True)
        L.sampler.configure_sampler(enabled=False, reset=True)
        L.slo.configure_slo(enabled=False, reset=True, objectives=(),
                            breach_handler=L.slo.SLOMonitor.DEFAULT_HANDLER)
        L.devicemon.configure_devicemon(enabled=False, reset=True, watchdog=False)
        L.causal.configure_causal(reset=True)
        L.flowprof.set_phase_listener(None)
        L.overload.configure_overload(enabled=False, reset=True)
        if before is not None:
            reg = L.monitoring.node_metrics()
            with reg._lock:
                for name in list(reg._metrics):
                    if name.startswith(_LEAKY) and name not in before[L.name]:
                        del reg._metrics[name]


def drop_sections(prefixes=("flowprof.",)) -> None:
    """Remove every registry name under ``prefixes`` from both packages'
    process registries, so a test reads sections only it filled (the
    reference's own tests fill its ``flowprof.*`` timers in the same
    worker)."""
    for L in LAYERS.values():
        reg = L.monitoring.node_metrics()
        with reg._lock:
            for name in list(reg._metrics):
                if name.startswith(prefixes):
                    del reg._metrics[name]


@pytest.fixture(autouse=True)
def clean_layers():
    before = registry_names()
    layers_off()
    drop_sections()
    yield
    layers_off(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class FakeClock:
    """The reference tests' injected clock (``tests/test_observatory.py``)."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def strip_times(obj, keys=("t", "t_send", "t_recv", "ts", "time", "pid")):
    """``obj`` with every wall-clock field named in ``keys`` removed."""
    if isinstance(obj, dict):
        return {k: strip_times(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [strip_times(v, keys) for v in obj]
    return obj


def short_class(path: str) -> str:
    """``package.module:Qualname`` without its package root."""
    return path.split(".", 1)[1] if path.startswith("corda_tpu") else path


def all_layers_on(L) -> None:
    """Every host layer of package ``L`` on, contention installed."""
    L.netstats.configure_netstats(enabled=True, reset=True)
    L.flowprof.configure_flowprof(enabled=True, reset=True)
    L.contention.configure_contention(enabled=True, reset=True)
    L.contention.install()
    L.cluster.configure_cluster(enabled=True, reset=True)
    L.slo.configure_slo(enabled=True, reset=True, breach_handler=None)
    L.timeseries.configure_timeline(enabled=True, reset=True, thread=False)
    L.devicemon.configure_devicemon(enabled=True, reset=True)


# ------------------------------------------------------------ the hooks

def _payment(pkg: str, layers_on: bool) -> dict:
    """Issue 500 and pay 120 over a three-node mock network; with
    ``layers_on`` every layer is on while it runs. Returns what came out."""
    L = LAYERS[pkg]
    if pkg == "ref":
        from corda_tpu.finance import CashIssueFlow, CashPaymentFlow, CashState
        from corda_tpu.testing import MockNetworkNodes
        mk = MockNetworkNodes
    else:
        import corda_tpu_torch.testing.mocknet as port_mocknet
        from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow, CashState

        def mk():
            return port_mocknet.MockNetworkNodes(device="cpu")
    if layers_on:
        all_layers_on(L)
    with mk() as net:
        alice = net.create_node("HookAlice")
        bob = net.create_node("HookBob")
        notary = net.create_notary_node("HookNotary")
        alice.run_flow(CashIssueFlow(500, "GBP", b"\x05", notary.party), timeout=300)
        handle = alice.smm.start_flow(CashPaymentFlow(120, "GBP", bob.party))
        stx = handle.result.result(timeout=300)
        deadline = time.monotonic() + 60
        bob_cash = []
        while time.monotonic() < deadline:
            bob_cash = [sr.state.data.amount.quantity
                        for sr in bob.services.vault_service.unconsumed_states(CashState)]
            if bob_cash:
                break
            time.sleep(0.05)
        alice_cash = sorted(sr.state.data.amount.quantity
                            for sr in alice.services.vault_service.unconsumed_states(CashState))
        out = {"outputs": sorted(s.data.amount.quantity for s in stx.tx.outputs),
               "bob": sorted(bob_cash), "alice": alice_cash, "sigs": len(stx.sigs)}
        if layers_on:
            # responders may still be closing after the initiator's result
            prev, deadline = None, time.monotonic() + 30
            while time.monotonic() < deadline:
                cur = L.flowprof.flowprof_section()
                if cur == prev:
                    break
                prev = cur
                time.sleep(0.1)
            out["flowprof"] = L.flowprof.flowprof_section()
            out["snapshot"] = L.monitoring.monitoring_snapshot()
            out["metrics_text"] = L.exposition.metrics_text()
    return out


@pytest.fixture(scope="module")
def payments():
    import corda_tpu_torch.testing.mocknet as port_mocknet

    grace = port_mocknet.MOCK_PARKING_GRACE_S
    port_mocknet.MOCK_PARKING_GRACE_S = 30.0
    out = {}
    try:
        for pkg in ("ref", "port"):
            for on in (False, True):
                before = registry_names()
                try:
                    out[pkg, on] = _payment(pkg, on)
                finally:
                    layers_off(before)
    finally:
        port_mocknet.MOCK_PARKING_GRACE_S = grace
        from corda_tpu.serving import shutdown_scheduler as ref_shutdown
        from corda_tpu_torch.serving import shutdown_scheduler

        ref_shutdown()
        shutdown_scheduler()
    return out


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_payment_answers_equal_with_layers_on_and_off(payments, pkg):
    off, on = payments[pkg, False], payments[pkg, True]
    keys = ("outputs", "bob", "alice", "sigs")
    assert {k: on[k] for k in keys} == {k: off[k] for k in keys}
    assert on["outputs"] == [120, 380] and on["bob"] == [120]


def test_payment_same_answers_in_both_packages(payments):
    keys = ("outputs", "bob", "alice", "sigs")
    assert ({k: payments["port", True][k] for k in keys}
            == {k: payments["ref", True][k] for k in keys})


def test_flowprof_books_the_same_classes_and_phases(payments):
    ref, port = payments["ref", True]["flowprof"], payments["port", True]["flowprof"]
    assert ref["enabled"] and port["enabled"]
    rc = {short_class(c): agg for c, agg in ref["classes"].items()}
    pc = {short_class(c): agg for c, agg in port["classes"].items()}
    assert sorted(pc) == sorted(rc)
    assert any(c.endswith("CashPaymentFlow") for c in pc)
    for cls in rc:
        assert sorted(pc[cls]["phases"]) == sorted(rc[cls]["phases"])
        assert pc[cls]["flows"] == rc[cls]["flows"], cls


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_flowprof_phases_sum_to_the_wall(payments, pkg):
    section = payments[pkg, True]["flowprof"]
    for cls, agg in section["classes"].items():
        total = sum(agg["phases"].values())
        assert abs(total - agg["wall_s"]) <= 0.05 * agg["wall_s"], (cls, total, agg["wall_s"])
    pay = next(agg for c, agg in section["classes"].items() if c.endswith("CashPaymentFlow"))
    assert pay["phases"]["notary_rtt"] > 0
    assert pay["phases"]["message_transit"] > 0


def test_monitoring_snapshot_keys_are_the_references(payments):
    ref = set(payments["ref", True]["snapshot"])
    port = set(payments["port", True]["snapshot"])
    assert port == ref
    assert {"profiler", "resilience"} <= port


@pytest.mark.parametrize("section", ["net", "flowprof", "contention", "cluster", "slo",
                                     "devices", "timeline"])
def test_sections_of_layers_on_read_enabled(payments, section):
    for pkg in ("ref", "port"):
        snap = payments[pkg, True]["snapshot"][section]
        assert snap.get("enabled") is True, (pkg, section, snap)
        off = LAYERS[pkg].monitoring.monitoring_snapshot()[section]
        assert off == {"enabled": False}, (pkg, section, off)


def test_net_and_cluster_saw_the_payments_edges(payments):
    edges = {}
    for pkg in ("ref", "port"):
        snap = payments[pkg, True]["snapshot"]
        edges[pkg] = {tuple(n.split(",")[0] for n in e.split("->"))
                      for e in snap["net"]["edges"]}
        assert {("O=HookAlice", "O=HookNotary"), ("O=HookNotary", "O=HookAlice"),
                ("O=HookAlice", "O=HookBob")} <= edges[pkg], pkg
        assert snap["cluster"]["hops"] > 0, pkg
        assert snap["contention"]["sites"], pkg
    assert edges["port"] == edges["ref"]


def test_metrics_text_parses_with_the_same_families(payments):
    fams = {}
    for pkg in ("ref", "port"):
        text = payments[pkg, True]["metrics_text"]
        parsed = LAYERS[pkg].exposition.parse_prometheus(text)
        # the monitors' own labeled families (registry families depend on
        # what else this process ran)
        fams[pkg] = {n for n in parsed["__types__"]
                     if n.startswith(("cordatpu_net_edge_", "cordatpu_contention_site",
                                      "cordatpu_contention_wait_edge"))}
    assert fams["port"] == fams["ref"]
    assert any(n.startswith("cordatpu_net_edge_") for n in fams["port"])


def _partition_suspects(pkg: str) -> tuple:
    """A fault-plan partition through the in-memory transport with netstats
    and the governor on: the governor's suspected edges after
    ``sync_net_events``, and after the heal."""
    L = LAYERS[pkg]
    fi = importlib.import_module(f"{L.root}.faultinject")
    network = importlib.import_module(f"{L.root}.messaging.network")
    plan = fi.FaultPlan(seed=7, partitions=(
        fi.Partition(0, 3, frozenset({"n1"}), frozenset({"n2"})),))
    net = network.InMemoryMessagingNetwork(fault_injector=fi.FaultInjector(plan))
    n1 = net.create_node("n1")
    n2 = net.create_node("n2")
    n2.add_handler("t", lambda m: None)
    clock = FakeClock()
    L.netstats.configure_netstats(enabled=True, reset=True, partition_deadline_s=0.05)
    gov = L.overload.configure_overload(enabled=True, reset=True)
    gov._clock = clock
    n1.send("n2", "t", b"x", msg_id="pmsg")
    net.pump()
    time.sleep(0.12)
    net.pump()
    gov.sync_net_events()
    during = (gov.edge_suspected("n1", "n2"), gov.edge_suspected("n2", "n1"),
              gov.snapshot()["suspect_edges"])
    net.pump()              # round 3: the partition's last
    n1.send("n2", "t", b"x", msg_id="pmsg~1")
    net.pump()
    clock.advance(0.1)
    gov.sync_net_events()   # rate-limited: a second call within 0.25 s reads nothing
    rate_limited = gov.edge_suspected("n1", "n2")
    clock.advance(0.5)
    gov.sync_net_events()
    after = (rate_limited, gov.edge_suspected("n1", "n2"), gov.snapshot()["suspect_edges"])
    kinds = [e["kind"] for e in L.netstats.netstats().snapshot()["events"]]
    return during, after, kinds


def test_governor_suspects_a_partitioned_edge():
    ref, port = _partition_suspects("ref"), _partition_suspects("port")
    assert port == ref
    (during, after, kinds) = port
    assert during == (True, False, ["n1->n2"])
    assert after == (True, False, [])
    assert kinds == ["net.partition_suspect", "net.partition_healed"]


def test_engine_and_wal_registered_their_wait_sites():
    for L in LAYERS.values():
        sites = L.contention.wait_sites()
        assert sites[("engine.py", "_worker_loop")] == "lock_wait"
        assert sites[("engine.py", "wait_or_killed")] == "lock_wait"
        assert sites[("wal.py", "flush")] == "io_wait"
        assert sites[("wal.py", "_flush_inner")] == "io_wait"


# ------------------------------------------------- off by default, fresh

_OFF_SCRIPT = r"""
import json, os, threading
for knob in ("NETSTATS", "FLOWPROF", "CONTENTION", "CLUSTER", "TIMELINE", "SAMPLER",
             "DEVICEMON", "OVERLOAD"):
    os.environ.pop("CORDA_TPU_" + knob, None)
real_lock, real_rlock, real_cond = threading.Lock, threading.RLock, threading.Condition
import torch
cuda_calls = []
for name in ("is_available", "device_count", "memory_stats", "current_device",
             "get_device_properties", "init"):
    orig = getattr(torch.cuda, name)
    def spy(*a, _n=name, _o=orig, **kw):
        cuda_calls.append(_n)
        return _o(*a, **kw)
    setattr(torch.cuda, name, spy)
import corda_tpu_torch.testing.mocknet as mocknet
from corda_tpu_torch.finance import CashIssueFlow
from corda_tpu_torch.node.monitoring import monitoring_snapshot, node_metrics
from corda_tpu_torch.messaging.netstats import active_netstats
from corda_tpu_torch.observability import (
    active_cluster, active_contention, active_devicemon, active_flowprof, active_sampler,
    active_slo, active_timeline, flowprof_frame, flowprof_hint, metrics_text)
from corda_tpu_torch.observability.contention import installed
from corda_tpu_torch.observability.flowprof import flowprof
cuda_calls.clear()
mocknet.MOCK_PARKING_GRACE_S = 30.0   # the plain versions outlast the 1 s grace
with mocknet.MockNetworkNodes(device="cpu") as net:
    alice = net.create_node("OffAlice")
    notary = net.create_notary_node("OffNotary")
    alice.run_flow(CashIssueFlow(100, "GBP", b"\x01", notary.party), timeout=300)
    threads = sorted(t.name for t in threading.enumerate())
snap = monitoring_snapshot()
names = sorted(node_metrics().snapshot())
text = metrics_text()
print(json.dumps({
    "sections": {k: snap[k] for k in ("net", "flowprof", "contention", "cluster", "slo",
                                      "devices", "timeline", "sampler", "causal")},
    "names": [n for n in names if n.startswith(
        ("net.", "flowprof.", "contention.", "cluster.", "slo.", "device.", "timeline.",
         "sampler.", "causal.", "loadharness."))],
    "active": [f.__name__ for f in (active_netstats, active_flowprof, active_contention,
                                    active_cluster, active_slo, active_timeline,
                                    active_sampler, active_devicemon) if f() is not None],
    "threads": [t for t in threads if t in ("stack-sampler", "slo-monitor", "timeline-sampler",
                                            "devicemon-watchdog")],
    "patched": not (threading.Lock is real_lock and threading.RLock is real_rlock
                    and threading.Condition is real_cond) or installed(),
    "noop_frames": flowprof_frame("serialize") is flowprof_frame("checkpoint")
                   and flowprof_hint("notary_rtt") is flowprof_hint("queue_wait"),
    "ledgered": flowprof().snapshot()["flows"],
    "families": [f for f in ("cordatpu_net_", "cordatpu_slo_", "cordatpu_device_",
                             "cordatpu_contention_", "cordatpu_causal_") if f in text],
    "cuda_calls": cuda_calls,
}))
"""

_ON_SCRIPT = r"""
import json, threading
from corda_tpu_torch.observability.contention import (
    TimedContentionLock, active_contention, installed)
assert active_contention() is not None
assert installed()
assert isinstance(threading.Lock(), TimedContentionLock)
import corda_tpu_torch.testing.mocknet as mocknet
from corda_tpu_torch.finance import CashIssueFlow
from corda_tpu_torch.node.monitoring import monitoring_snapshot
mocknet.MOCK_PARKING_GRACE_S = 30.0
with mocknet.MockNetworkNodes(device="cpu") as net:
    alice = net.create_node("EnvAlice")
    notary = net.create_notary_node("EnvNotary")
    alice.run_flow(CashIssueFlow(100, "GBP", b"\x01", notary.party), timeout=300)
snap = monitoring_snapshot()["contention"]
print(json.dumps({"enabled": snap["enabled"], "installed": snap["installed"],
                  "smm": snap["sites"].get("engine.smm", {}).get("acquires", 0)}))
"""


def _run(script: str, env_extra: dict | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("CORDA_TPU_")}
    # one torch thread: a thread pool beside the suite's workers only contends
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                **(env_extra or {})})
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def off_run():
    return _run(_OFF_SCRIPT)


@pytest.mark.parametrize("section", ["net", "flowprof", "contention", "cluster", "slo",
                                     "devices", "timeline", "sampler", "causal"])
def test_off_sections_are_disabled_markers(off_run, section):
    assert off_run["sections"][section] == {"enabled": False}


@pytest.mark.parametrize("fact, want", [
    ("names", []), ("active", []), ("threads", []), ("patched", False),
    ("noop_frames", True), ("ledgered", 0), ("families", []), ("cuda_calls", []),
])
def test_off_leaves_no_footprint(off_run, fact, want):
    assert off_run[fact] == want


def test_contention_env_knob_times_the_smm_monitor():
    out = _run(_ON_SCRIPT, {"CORDA_TPU_CONTENTION": "1"})
    assert out["enabled"] and out["installed"]
    assert out["smm"] > 0


# ------------------------------------------------------------- hygiene

_HYGIENE_SCRIPT = r"""
import sys, threading
sys.path.insert(0, "tests")
import test_torch_layers as T
import corda_tpu_torch.testing.mocknet as mocknet
from corda_tpu.finance import CashIssueFlow as RefIssue
from corda_tpu.testing import MockNetworkNodes as RefNet
from corda_tpu_torch.finance import CashIssueFlow as PortIssue
real_lock = threading.Lock
before = T.registry_names()
for L in T.LAYERS.values():
    T.all_layers_on(L)
    L.timeseries.timeline().tick()
    L.slo.configure_slo(objectives=(L.slo.SLOObjective(
        name="hygiene", priority="interactive", p99_s=1e-9, min_samples=1),))
    L.slo.active_slo().observe("interactive", 1.0)
    L.slo.active_slo().evaluate()
with RefNet() as net:
    a, n = net.create_node("HygA"), net.create_notary_node("HygN")
    a.run_flow(RefIssue(10, "GBP", b"\x01", n.party))
mocknet.MOCK_PARKING_GRACE_S = 30.0
with mocknet.MockNetworkNodes(device="cpu") as net:
    a, n = net.create_node("HygA"), net.create_notary_node("HygN")
    a.run_flow(PortIssue(10, "GBP", b"\x01", n.party), timeout=300)
assert any(k.startswith("slo.") for k in T.registry_names()["ref"])
T.layers_off(before)
assert threading.Lock is real_lock
from test_devicemon import TestOffByDefault
check = TestOffByDefault()
check.test_monitors_inactive_and_sections_marked_disabled()
check.test_no_monitor_threads_exist()
check.test_scheduler_traffic_creates_no_device_or_slo_metrics()
print('{"ok": true}')
"""


def test_layers_off_leaves_the_reference_offbydefault_checks_passing():
    """The port's files cannot add to the reference's known SLO-family leak
    (``test_devicemon.py::TestOffByDefault`` after ``test_timeline.py``):
    after every layer of both packages was on, with an SLO breach in each,
    ``layers_off`` leaves the reference's checks passing."""
    assert _run(_HYGIENE_SCRIPT)["ok"]


def test_layers_off_restores_this_process():
    before = registry_names()
    for L in LAYERS.values():
        all_layers_on(L)
        L.slo.configure_slo(objectives=(L.slo.SLOObjective(
            name="hygiene", priority="interactive", p99_s=1e-9, min_samples=1),))
        L.slo.active_slo().observe("interactive", 1.0)
        L.slo.active_slo().evaluate()
    layers_off(before)
    after = registry_names()
    for pkg, L in LAYERS.items():
        added = after[pkg] - before[pkg]
        assert not [k for k in added if k.startswith(_LEAKY)], (pkg, added)
        assert L.contention.installed() is False
        assert "cordatpu_slo_" not in L.exposition.metrics_text() or any(
            k.startswith("slo.") for k in before[pkg])
    assert threading.Lock is LAYERS["ref"].contention._REAL_LOCK
    names = {t.name for t in threading.enumerate()}
    assert not names & {"stack-sampler", "slo-monitor", "timeline-sampler",
                        "devicemon-watchdog"}


# ------------------------------------------------ exit with locks timed

@pytest.mark.parametrize("probe", ["flow", "notary_window", "scheduler"])
def test_exit_with_work_in_flight_under_contention(probe):
    """The exit drain (``serving/scheduler.py``'s one exit hook) still
    exits 0 with every lock the process made after import a timed
    contention lock (``CORDA_TPU_CONTENTION=1`` installs at import) and
    work in flight: the probes of ``test_torch_exit.py``."""
    import textwrap

    from test_torch_exit import PRELUDE, PROBES

    code = PRELUDE + textwrap.dedent(PROBES[probe]) + """
import threading
from corda_tpu_torch.observability.contention import TimedContentionLock, installed
assert installed() and isinstance(threading.Lock(), TimedContentionLock)
time.sleep(0.3)
print("exiting", sum(f.done() for f in FUTS), len(FUTS), flush=True)
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith("CORDA_TPU_")}
    env.update({"OMP_NUM_THREADS": "1", "CORDA_TPU_CONTENTION": "1", "PYTHONPATH": REPO})
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "terminate called" not in proc.stderr
    lines = proc.stdout.split()
    settled = lines[lines.index("settled") + 1:lines.index("settled") + 3]
    assert int(settled[0]) == int(settled[1])
