"""Lock contention and lock order: the port's
``observability/contention.py`` and ``lockwatch.py`` against the
reference's (``tests/test_contention.py``).

- the frame classifier: equal ``classify_frame`` on the reference tests'
  fake frames (stdlib waits, runnable frames, registered sites winning
  over the stdlib table, the depth bound) and on seeded random stacks;
- ``ContentionMonitor``: the same seeded acquires, blocked acquires, edge
  waits and releases give an equal section (sites, quantiles, the
  top-contended table, holder→waiter edges) and byte-equal Prometheus
  lines; the reservoir's quantiles under the same values;
- timed locks through a real convoy: the same sites, counts and edges;
  ``install()`` patches and ``uninstall()`` restores ``threading``'s
  factories in both packages;
- lockwatch: the same acquisition order gives the same edges and the same
  cycle report, strict and not.

Wall-clock waits are compared by their counts, not their seconds."""

import random
import threading
import time

import pytest

from test_torch_layers import (  # noqa: F401  (fixtures)
    LAYERS,
    clean_layers,
    one_torch_thread,
)

PKGS = ("ref", "port")


class _FakeCode:
    def __init__(self, filename, name):
        self.co_filename = filename
        self.co_name = name


class _FakeFrame:
    def __init__(self, filename, name, back=None):
        self.f_code = _FakeCode(filename, name)
        self.f_back = back


def _stack(specs):
    """A fake stack from innermost-first (filename, function) pairs."""
    frame = None
    for filename, name in reversed(specs):
        frame = _FakeFrame(filename, name, back=frame)
    return frame


FILES = ["/usr/lib/python3.12/threading.py", "/usr/lib/python3.12/selectors.py",
         "/usr/lib/python3.12/socket.py", "/usr/lib/python3.12/queue.py",
         "/usr/lib/python3.12/ssl.py", "/repo/pkg/flows/engine.py",
         "/repo/pkg/durability/wal.py", "/repo/app.py", "/repo/fakewal.py"]
FUNCS = ["wait", "acquire", "join", "select", "recv", "get", "put", "read", "flush",
         "_flush_inner", "_worker_loop", "wait_or_killed", "run", "call", "_wait_for_tstate_lock"]


@pytest.mark.parametrize("stack", [
    [("/usr/lib/python3.11/threading.py", "wait")],
    [("/usr/lib/python3.11/selectors.py", "select")],
    [("/repo/corda/flows/engine.py", "run")],
    [("/usr/lib/python3.11/threading.py", "wait"), ("/repo/fakewal.py", "flush")],
    [("/repo/app.py", f"fn{i}") for i in range(20)] + [("/x/threading.py", "wait")],
])
def test_classify_reference_frames_equal(stack):
    for pkg in PKGS:
        LAYERS[pkg].contention.register_wait_site("fakewal.py", "flush", "io_wait")
    frame = _stack(stack)
    for depth in (16, 32):
        assert (LAYERS["port"].contention.classify_frame(frame, max_depth=depth)
                == LAYERS["ref"].contention.classify_frame(frame, max_depth=depth))


@pytest.mark.parametrize("seed", range(4))
def test_classify_seeded_stacks_equal(seed):
    rng = random.Random(seed)
    got = {"ref": [], "port": []}
    for _ in range(300):
        stack = [(rng.choice(FILES), rng.choice(FUNCS)) for _ in range(rng.randint(1, 24))]
        frame = _stack(stack)
        depth = rng.choice((4, 16, 32))
        for pkg in PKGS:
            got[pkg].append(LAYERS[pkg].contention.classify_frame(frame, max_depth=depth))
    assert got["port"] == got["ref"]
    assert {"lock_wait", "io_wait", None} <= set(got["ref"])


def test_wait_site_tables_equal():
    for pkg in PKGS:
        with pytest.raises(ValueError):
            LAYERS[pkg].contention.register_wait_site("x.py", "f", "napping")
    # the reference's serving scheduler registers its dispatch and hedge
    # loops when it is imported; the port's scheduler hooks come with the
    # serving layer (ROADMAP.md, Queue 1 step 6)
    import corda_tpu.serving.scheduler  # noqa: F401

    ref = dict(LAYERS["ref"].contention.wait_sites())
    port = dict(LAYERS["port"].contention.wait_sites())
    assert port == {k: v for k, v in ref.items() if k[0] != "scheduler.py"}
    assert ref[("scheduler.py", "_dispatch_loop")] == "lock_wait"


def _monitor(pkg: str, seed: int) -> dict:
    C = LAYERS[pkg].contention
    rng = random.Random(seed)
    mon = C.ContentionMonitor()
    mon.enable()
    sites = [f"site{i}.py:{10 * i}" for i in range(6)]
    held: list = []
    for _ in range(400):
        op = rng.random()
        if op < 0.45 or not held:
            site = rng.choice(sites)
            contended = rng.random() < 0.4
            if contended:
                mon.note_blocked(site)
            wait = rng.random() * 0.01 if contended else 0.0
            mon.note_acquire(site, wait, contended)
            if contended:
                mon.note_edge_wait(site, mon.waiter_context(), wait)
            held.append(site)
        else:
            site = held.pop(rng.randrange(len(held)))
            mon.note_release(site, rng.random() * 0.02)
    snap = mon.snapshot(top_n=4)
    snap.pop("installed")
    return snap


@pytest.mark.parametrize("seed", range(4))
def test_monitor_section_equal(seed):
    ref, port = _monitor("ref", seed), _monitor("port", seed)
    assert port == ref
    assert ref["top"] and ref["edges"]


def test_reservoir_equal():
    rng = random.Random(3)
    vals = [rng.random() for _ in range(2000)]
    out = {}
    for pkg in PKGS:
        r = LAYERS[pkg].contention._Reservoir(slots=64)
        first = r.quantiles()
        for v in vals:
            r.add(v)
        out[pkg] = (first, r.quantiles())
    assert out["port"] == out["ref"]


def test_prometheus_lines_byte_equal():
    out = {}
    for pkg in PKGS:
        C = LAYERS[pkg].contention
        mon = C.configure_contention(enabled=True, patch=False, reset=True)
        for site, wait in (('a"b\\c.py:1', 0.25), ("engine.smm", 0.5), ("wal.py:9", 0.0)):
            mon.note_blocked(site)
            mon.note_acquire(site, wait, wait > 0)
            mon.note_edge_wait(site, "thread:flow-worker", wait)
            mon.note_release(site, 0.125)
        out[pkg] = "\n".join(C.prometheus_lines())
    assert out["port"].encode() == out["ref"].encode()
    for pkg in PKGS:
        assert LAYERS[pkg].exposition.parse_prometheus(out["port"] + "\n")


def _convoy(pkg: str) -> dict:
    C = LAYERS[pkg].contention
    C.configure_contention(enabled=True, patch=False, reset=True)
    lock = C.timed_lock("convoy.site")
    outer = C.timed_lock("outer.site", reentrant=True)
    taken, coming = threading.Event(), threading.Event()

    def holder():
        with lock:
            taken.set()
            coming.wait(5.0)
            time.sleep(0.2)

    t = threading.Thread(target=holder, name="convoy-holder")
    t.start()
    taken.wait(timeout=5.0)
    coming.set()
    with outer:
        with outer:
            with lock:
                pass
    t.join(timeout=5.0)
    got = lock.acquire(blocking=False)
    lock.release()
    wrapped = C.wrap_lock(threading.RLock(), "wrapped.site")
    cond = threading.Condition(C.timed_lock("cond.site", reentrant=True))
    with cond:
        cond.notify_all()
        cond.wait(0.01)
    with wrapped:
        pass
    snap = C.contention_section()
    return {
        "got": got,
        "sites": {s: (d["acquires"], d["contended"]) for s, d in snap["sites"].items()},
        "edges": sorted((e["holder"], e["waiter"], e["count"]) for e in snap["edges"]),
        "top": [e["site"] for e in snap["top"]],
        "names": (C.timed_lock("explicit").name, wrapped.name),
    }


def test_convoy_through_timed_locks_equal():
    ref, port = _convoy("ref"), _convoy("port")
    assert port == ref
    assert ref["sites"]["convoy.site"][1] == 1
    assert ("convoy.site", "outer.site", 1) in ref["edges"]


def test_install_patches_and_restores_in_both():
    real = (threading.Lock, threading.RLock, threading.Condition)
    for pkg in PKGS:
        C = LAYERS[pkg].contention
        C.configure_contention(enabled=True, reset=True)
        C.install()
        try:
            assert C.installed()
            assert isinstance(threading.Lock(), C.TimedContentionLock)
            assert isinstance(threading.RLock(), C.TimedContentionLock)
            cond = threading.Condition()
            with cond:
                cond.notify_all()
            assert C.contention_section()["installed"] is True
            # the registry's snapshot completes under the patch
            LAYERS[pkg].monitoring.node_metrics().snapshot()
        finally:
            C.uninstall()
        assert (threading.Lock, threading.RLock, threading.Condition) == real
        assert not C.installed()


# ------------------------------------------------------------ lockwatch

def _order(pkg: str, strict: bool) -> dict:
    W = LAYERS[pkg].lockwatch
    W.reset()
    a, b, c = W.WatchedLock("A"), W.WatchedLock("B"), W.WatchedLock("C")
    a2 = W.WatchedLock("A")
    for first, second in ((a, b), (b, c), (c, a), (a, a2), (b, c)):
        with first:
            with second:
                pass
    r = W.WatchedLock("R", reentrant=True)
    with r:
        with r:
            with a:
                pass
    edges = W.lockwatch_edges()
    report = W.cycle_report(strict=strict)
    for cyc in report:
        for e in cyc["edges"]:
            e["stack"] = bool(e["stack"])
    W.reset()
    return {"edges": edges, "report": report}


@pytest.mark.parametrize("strict", [False, True])
def test_lockwatch_cycle_report_equal(strict):
    ref, port = _order("ref", strict), _order("port", strict)
    assert port == ref
    assert ref["report"]
