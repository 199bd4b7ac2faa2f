"""Timing probe of the co-located notary clusters, on the CPU.

Runs the 3-replica Raft cluster of ``bench.py``'s
``bench_notary_raft_cluster`` (``RaftUniquenessProvider.make_cluster``:
election timeout 0.15-0.3 s, heartbeat 0.05 s; a 10 s submit window,
``--retry-s``) and the 4-replica BFT cluster of its
``bench_notary_bft_cluster`` (``BFTUniquenessProvider.make_cluster``: BLS
certificates, a 1 s view timeout; a quorum wait of three submit
windows, bench.py's 30 s), with windows of 2,048 one-input commit
requests put in flight three deep through ``commit_batch_async``, as
``BatchedNotaryService.process_stream`` does, over one
``InMemoryMessagingNetwork`` pump thread. ``--load N`` keeps N threads
busy with pure-Python work beside it, as a notary service's stage threads
keep the interpreter busy.

``--timers slow`` gives the replicas the slower timers that
``chip_smoke.py`` phase 20 sets instead: ``make_node_on_endpoint``'s
election timeout of 1-2 s and heartbeat of 0.25 s, a 10 s view timeout.

Either package runs it (``--package corda_tpu`` or ``corda_tpu_torch``),
with the same requests from ``--seed``. Each pass prints what the
clusters' timers did: the Raft term (or BFT view) at the start and end,
the windows whose round took more than 2 s or failed, the leader's log
entries for the windows, and whether every replica applied every round
within 30 s with equal consumed sets. It measures no rate.

    JAX_PLATFORMS=cpu python3 cluster_probe.py --package corda_tpu --load 3
    python3 cluster_probe.py --package corda_tpu_torch --load 3 --cluster raft
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import random
import threading
import time

WINDOWS = 12      # windows a pass
WINDOW = 2048     # requests a window: bench.py's NOTARY_CHUNK
STALL_S = 2.0     # a window's round past this counts as a stall
SETTLE_S = 30.0   # how long every replica gets to apply every round
DEPTH = 3         # rounds in flight, as process_stream's depth


def busy(stop: threading.Event) -> None:
    """Pure-Python work that holds the interpreter lock in turns."""
    while not stop.is_set():
        sum(i * i for i in range(20000))


def windows_of(pkg: str, n_windows: int, size: int, seed: int) -> list:
    """``n_windows`` windows of ``size`` requests, each spending one fresh
    state: (states, tx id, caller)."""
    crypto = importlib.import_module(f"{pkg}.crypto")
    ledger = importlib.import_module(f"{pkg}.ledger")
    rng = random.Random(seed)

    def h():
        return crypto.SecureHash(rng.randbytes(32))

    return [[([ledger.StateRef(h(), 0)], h(), "alice") for _ in range(size)]
            for _ in range(n_windows)]


def run_windows(provider, windows) -> tuple[list, int, float]:
    """Every window through ``provider.commit_batch_async``, ``DEPTH``
    in flight: (each window's wait in its collect, or the exception it
    raised; failures; seconds)."""
    inflight: collections.deque = collections.deque()
    waits: list = []
    t0 = time.perf_counter()

    def collect_oldest():
        pending = inflight.popleft()
        t = time.perf_counter()
        try:
            pending.collect()
            waits.append(time.perf_counter() - t)
        except Exception as e:  # noqa: BLE001 - a failed round is what is counted
            waits.append(e)

    for w in windows:
        inflight.append(provider.commit_batch_async(w))
        if len(inflight) == DEPTH:
            collect_oldest()
    while inflight:
        collect_oldest()
    return waits, sum(isinstance(w, Exception) for w in waits), time.perf_counter() - t0


def wait_until(done, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while not done():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def raft_pass(pkg: str, tag: str, windows, slow: bool, retry_s: float) -> dict:
    messaging = importlib.import_module(f"{pkg}.messaging")
    notary = importlib.import_module(f"{pkg}.notary")
    serialization = importlib.import_module(f"{pkg}.serialization")

    net = messaging.InMemoryMessagingNetwork()
    net.start_pumping()
    providers = []
    try:
        names = [f"{tag}-r{i}" for i in range(3)]
        if slow:
            for name in names:
                providers.append(notary.RaftUniquenessProvider.make_node_on_endpoint(
                    name, names, net.create_node(name)))
            for p in providers:
                p.node.start()
        else:
            providers = notary.RaftUniquenessProvider.make_cluster(names, net)
        for p in providers:
            p._retry_s = retry_s
        if not wait_until(lambda: any(p.node.role == "leader" for p in providers), 10.0):
            raise AssertionError("no raft leader")
        leader = next(p for p in providers if p.node.role == "leader")
        term0 = max(p.node.current_term for p in providers)
        waits, failed, secs = run_windows(leader, windows)
        term1 = max(p.node.current_term for p in providers)
        now = next((p for p in providers if p.node.role == "leader"), leader)
        entries = len(now.node.log.entries)
        # an empty batch lets a leader elected mid-pass commit the entries
        # it inherited (it appends none of its own when elected)
        settle_error = None
        try:
            leader._submit_retrying(serialization.serialize(("batch", [])))
        except Exception as e:  # noqa: BLE001 - reported, the replicas still compared
            settle_error = e
        top = max(p.node.commit_index for p in providers)
        applied = wait_until(lambda: all(p.node.last_applied >= top for p in providers),
                             SETTLE_S)
        digests = {p.node._install_map_fn.__defaults__[0].consumed_digest() for p in providers}
        return {"secs": secs, "start": term0, "end": term1, "waits": waits, "failed": failed,
                "entries": entries, "applied": applied, "equal": len(digests) == 1,
                "settle_error": settle_error,
                "final_term": max(p.node.current_term for p in providers)}
    finally:
        for p in providers:
            p.close()
        net.stop_pumping()


def bft_pass(pkg: str, tag: str, windows, slow: bool, retry_s: float) -> dict:
    messaging = importlib.import_module(f"{pkg}.messaging")
    notary = importlib.import_module(f"{pkg}.notary")

    net = messaging.InMemoryMessagingNetwork()
    net.start_pumping()
    replicas = []
    try:
        replicas, make_client = notary.BFTUniquenessProvider.make_cluster(
            4, net, prefix=f"{tag}-replica", view_timeout_s=10.0 if slow else 1.0)
        provider = make_client(f"{tag}-client")
        provider.client._timeout_s = 3 * retry_s  # bench.py's quorum wait at 10 s
        waits, failed, secs = run_windows(provider, windows)
        views = [r.view for r in replicas]
        rounds = len(windows) - failed
        applied = wait_until(lambda: all(r._next_exec >= rounds for r in replicas), SETTLE_S)
        behind = [r.name for r in replicas if r._next_exec < rounds]
        digests = {r.base.consumed_digest() for r in replicas}
        return {"secs": secs, "start": 0, "end": max(views), "waits": waits, "failed": failed,
                "entries": None, "applied": applied, "equal": len(digests) == 1,
                "behind": behind, "views": views}
    finally:
        for r in replicas:
            r.stop()
        net.stop_pumping()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("corda_tpu", "corda_tpu_torch"), required=True)
    ap.add_argument("--cluster", choices=("raft", "bft", "both"), default="both")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--load", type=int, default=0, help="busy host threads beside the cluster")
    ap.add_argument("--timers", choices=("bench", "slow"), default="bench")
    ap.add_argument("--retry-s", type=float, default=10.0,
                    help="each Raft provider's submit window (bench.py's 10 s); the BFT "
                         "client's quorum wait is three of them")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if args.package == "corda_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    stop = threading.Event()
    load = [threading.Thread(target=busy, args=(stop,), daemon=True) for _ in range(args.load)]
    for t in load:
        t.start()
    kinds = ("raft", "bft") if args.cluster == "both" else (args.cluster,)
    try:
        for kind in kinds:
            for i in range(args.passes):
                windows = windows_of(args.package, WINDOWS, WINDOW, args.seed * 1000 + i)
                r = (raft_pass if kind == "raft" else bft_pass)(
                    args.package, f"{kind}-{i}", windows, args.timers == "slow",
                    args.retry_s)
                stalls = [f"{w:.1f}" for w in r["waits"]
                          if not isinstance(w, Exception) and w > STALL_S]
                timer = "term" if kind == "raft" else "view"
                line = (f"{args.package} {kind} pass {i + 1} ({args.timers} timers, load "
                        f"{args.load}): "
                        f"{len(windows)} windows of {WINDOW} in {r['secs']:.1f} s; "
                        f"{timer} {r['start']} -> {r['end']}; stalls > {STALL_S} s: "
                        f"{len(stalls)} {stalls}; failed windows {r['failed']}")
                if kind == "raft":
                    line += f"; leader's log {r['entries']} entries"
                    if r["settle_error"] is not None:
                        line += (f"; the empty batch after the pass failed "
                                 f"({type(r['settle_error']).__name__}, term then "
                                 f"{r['final_term']})")
                else:
                    line += f"; views {r['views']}, behind after {SETTLE_S:.0f} s {r['behind']}"
                line += (f"; every replica applied every round: {r['applied']}; consumed "
                         f"sets equal: {r['equal']}")
                first_error = next((w for w in r["waits"] if isinstance(w, Exception)), None)
                if first_error is not None:
                    line += f"; first failure {type(first_error).__name__}: {first_error}"
                print(line, flush=True)
    finally:
        stop.set()
        for t in load:
            t.join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
