#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits nonzero):

1. the card's name and power limit (as nvidia-smi reports them), the
   torch/CUDA versions, and the kernel build from csrc/ (seconds, and
   ptxas' registers and spills);
2. kernel A (ed25519_challenge) against its plain version: 8192 lanes of
   44-byte messages plus lanes of 0 and 47 bytes, exactly equal, and equal
   to hashlib on a sample;
3. kernel B (ed25519_verify_ladder) against its plain version, run on the
   card: 1024 lanes with every adversarial kind, exactly equal, and equal
   to the pure-Python oracle (phase 5 repeats this at 8192 lanes);
4. the main path: a DeviceScheduler on the card serves a backlog of
   69,410 signatures in 26 requests from four threads across the three
   priority classes (sizes 1 to 8192, one request of variable-length
   messages on the host-hash route); every verdict must equal the oracle,
   every row must settle on the device, and both kernels' launch counters
   (zeroed just before) must have risen. The same backlog is then served
   twice more, for the steady rate and under torch.profiler for the
   device's busy share, with the same checks;
5. times from CUDA events at B = 8192 (each kernel, each plain version)
   and the end-to-end rate through the scheduler, each beside the card's
   name and power limit; the bound of each kernel; the ladder's time per
   launch at 1024, 8192 and 32768 lanes; the host's prep and enqueue time
   for one 8192-row bucket.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero before any
result.
"""

from __future__ import annotations

import cProfile
import hashlib
import json
import pstats
import random
import subprocess
import sys
import threading
import time

# peak rates of one H100 SXM (NVIDIA data sheet; CUDA C++ Programming
# Guide, arithmetic instruction throughput for compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 64

MAIN_PATH_SIZES = [8192] * 6 + [6000, 4096, 3000, 2048, 1500, 1024, 777, 512,
                                300, 256, 100, 64, 33, 17, 8, 5, 3, 2, 1]
VAR_REQUEST_ROWS = 512


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, from CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fixed_plane(rng: random.Random, n: int, msg_len: int):
    """(n, 161) packed plane of random R, A, s and ``msg_len``-byte messages,
    packed and padded as the fixed-length route does."""
    import numpy as np

    from corda_tpu_torch.ops.ed25519 import pack_rows

    rand = np.frombuffer(rng.randbytes(n * 128), np.uint8).reshape(n, 128)
    msgs = [rng.randbytes(msg_len) for _ in range(n)]
    plane = np.zeros((n, 161), np.uint8)
    pack_rows(plane, rand[:, :64], rand[:, 64:96], rand[:, 96:128],
              np.ones(n, bool), msgs)
    return plane, msgs


def pack_triples(triples):
    import numpy as np

    from corda_tpu_torch.ops import ed25519 as ed

    pks, sigs, msgs = map(list, zip(*triples))
    pk_arr, sig_arr, ok = ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, pre = ed._canonical_precheck(pk_arr, sig_arr, ok)
    plane = np.zeros((len(pks), 161), np.uint8)
    ed.pack_rows(plane, sig_arr, pk_arr, s_arr, pre, msgs)
    return plane


def serve_backlog(sched, rows_by_req, classes):
    """Submit every request from four threads and wait for all of them:
    ({request: RowResult}, CUDA-event ms, host-clock ms)."""
    import torch

    futures: dict = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wall0 = time.perf_counter()

    def submit(ks):
        for k in ks:
            futures[k] = sched.submit_rows(rows_by_req[k], priority=classes[k])

    threads = [threading.Thread(target=submit, args=(range(t, len(rows_by_req), 4),),
                                daemon=True)
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    results = {k: f.result(timeout=600) for k, f in futures.items()}
    end.record()
    end.synchronize()
    return results, start.elapsed_time(end), (time.perf_counter() - wall0) * 1e3


def check_backlog(results, requests, n_rows) -> None:
    """Every request answered, every verdict equal to the oracle, every
    row settled on the device."""
    if len(results) != len(requests):
        raise AssertionError("not every request was submitted")
    device_rows = 0
    for k, (_rows, want_k, _cls) in enumerate(requests):
        if results[k].mask.tolist() != want_k:
            raise AssertionError(f"request {k}: verdicts differ from the oracle")
        device_rows += results[k].n_device
    if device_rows != n_rows:
        raise AssertionError(f"device_rows {device_rows} != rows submitted {n_rows}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from corda_tpu_torch.crypto import PublicKey, ed25519_host
        from corda_tpu_torch.ops import _build
        from corda_tpu_torch.ops.ed25519_ladder import (
            FIELD_MUL_PER_VERIFY,
            FIELD_SQ_PER_VERIFY,
            INT_OPS_PER_FIELD_MUL,
            INT_OPS_PER_FIELD_SQ,
            TABLE_ROWS,
            ed25519_verify_ladder,
            ladder_table,
            verify_ladder_plain,
        )
        from corda_tpu_torch.ops.scalar25519 import (
            CHALLENGE_INT_OPS_PER_LANE,
            challenge_windows_plain,
            ed25519_challenge,
        )
        from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE, DeviceScheduler
        from corda_tpu_torch.testing import adversarial_lanes, signed_triples
        from corda_tpu_torch.verifier import dispatch_signature_rows
    except ImportError as e:
        print(f"chip_smoke: the corda_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    rng = random.Random(20261016)

    # ---- 1. the card, the versions, the build
    card = smi("name,power.limit")
    print(card)
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  {n_sm} SMs, max SM clock {sm_clock_mhz:g} MHz")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if _build.build_info['built'] else 'cached'})")
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    # ---- 2. kernel A against its plain version
    err_a = 0
    for n, mlen in ((8192, 44), (256, 0), (256, 47)):
        plane, msgs = fixed_plane(rng, n, mlen)
        packed = torch.from_numpy(plane).to(dev)
        got = ed25519_challenge(packed)
        want = challenge_windows_plain(packed)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel A != plain at {n} lanes, {mlen}-byte messages")
        err_a = max(err_a, int((got - want).abs().max()))
        host = got.cpu().numpy()
        for i in range(0, n, max(1, n // 64)):
            h = int.from_bytes(hashlib.sha512(
                plane[i, :64].tobytes() + msgs[i]).digest(), "little") % ed25519_host.L
            if [int(v) for v in host[:, i]] != [(h >> (4 * k)) & 15 for k in range(64)]:
                raise AssertionError(f"kernel A != hashlib at lane {i}")
        print(f"kernel A == plain: {n} lanes, {mlen}-byte messages")

    # ---- 3. kernel B against its plain version (and the oracle)
    t0 = time.perf_counter()
    lanes = adversarial_lanes(7)
    kinds = [k for k, *_ in lanes]
    pool = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    pool += signed_triples(1024 - len(pool), seed=7)
    oracle = np.array([ed25519_host.verify(*t) for t in pool])
    print(f"signed and oracle-checked {len(pool)} triples in "
          f"{time.perf_counter() - t0:.1f} s ({len(kinds)} adversarial kinds: "
          f"{', '.join(kinds)})")
    packed = torch.from_numpy(pack_triples(pool)).to(dev)
    win = challenge_windows_plain(packed)
    table = ladder_table(dev)
    got = ed25519_verify_ladder(packed, win, table)
    want = verify_ladder_plain(packed, win, table)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).flatten().tolist()
        raise AssertionError(f"kernel B != plain at lanes {bad[:20]}")
    if got.cpu().numpy().tolist() != oracle.tolist():
        raise AssertionError("kernel B != the pure-Python oracle")
    err_b = int((got.int() - want.int()).abs().max())
    print(f"kernel B == plain == oracle: {len(pool)} lanes, "
          f"{int(got.sum())} accepted")

    # ---- 4. the main path through the scheduler
    var_pool = signed_triples(128, seed=8, msg_len=(1, 200))
    var_oracle = [ed25519_host.verify(*t) for t in var_pool]
    requests = []
    offset = 0
    for k, size in enumerate(MAIN_PATH_SIZES):
        idx = [(offset + i) % len(pool) for i in range(size)]
        requests.append(([pool[i] for i in idx], [bool(oracle[i]) for i in idx],
                         (BULK, SERVICE, INTERACTIVE)[k % 3]))
        offset += size
    idx = [i % len(var_pool) for i in range(VAR_REQUEST_ROWS)]
    requests.insert(3, ([var_pool[i] for i in idx], [var_oracle[i] for i in idx], SERVICE))
    n_rows = sum(len(r[0]) for r in requests)
    assert len(requests) >= 24 and n_rows >= 65536

    rows_by_req = [[(PublicKey(4, pk), s, m) for pk, s, m in rows]
                   for rows, _want, _cls in requests]
    classes = [cls for _rows, _want, cls in requests]
    sched = DeviceScheduler(device=dev)
    try:
        # warm-up: pinned staging buffers and the table's first upload
        warm = sched.submit_rows(rows_by_req[-1])
        warm.result(timeout=300)
        ed25519_challenge.launches = 0
        ed25519_verify_ladder.launches = 0
        torch.cuda.synchronize()
        results, e2e_ms, wall_ms = serve_backlog(sched, rows_by_req, classes)
        launches_a = ed25519_challenge.launches
        launches_b = ed25519_verify_ladder.launches
        counters = dict(sched.counters)
        # the same backlog twice more, with every bucket's buffers warm:
        # once for the steady rate, once under the profiler for the
        # device's busy share
        steady, steady_ms, _ = serve_backlog(sched, rows_by_req, classes)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _, prof_wall_ms = serve_backlog(sched, rows_by_req, classes)
    finally:
        sched.shutdown()
    for res in (results, steady, profiled):
        check_backlog(res, requests, n_rows)
    if launches_a == 0 or launches_b == 0:
        raise AssertionError(f"kernel launches A={launches_a} B={launches_b}: "
                             "the main path missed a kernel")
    batches = sorted({rr.batch_seq for rr in results.values()})
    print(f"main path: {len(requests)} requests, {n_rows} signatures, "
          f"{len(batches)} device batches, every verdict == oracle, "
          f"device_rows == {n_rows}; launches A={launches_a} B={launches_b}; "
          f"counters {counters}")
    print(f"e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host "
          f"clock {wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"e2e, steady pass: {n_rows} sigs in {steady_ms:.1f} ms (CUDA events) = "
          f"{n_rows / steady_ms * 1e3:.0f} sigs/s  [{card}]")
    device_us = {}
    for evt in prof.key_averages():
        if evt.self_device_time_total > 0:
            device_us[evt.key] = device_us.get(evt.key, 0.0) + evt.self_device_time_total
    busy_ms = sum(device_us.values()) / 1e3
    print(f"profiled pass: {prof_wall_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1]))
          + f"  [{card}]")

    # ---- 5. kernel times at the path's full bucket, and their bounds
    n = 8192
    big = torch.from_numpy(pack_triples([pool[i % len(pool)] for i in range(n)])).to(dev)
    win_big = ed25519_challenge(big)
    # kernel B against its plain version at the main path's bucket too
    got_big = ed25519_verify_ladder(big, win_big, table)
    want_big = verify_ladder_plain(big, win_big, table)
    torch.cuda.synchronize()
    if not torch.equal(got_big, want_big):
        bad = torch.nonzero(got_big != want_big).flatten().tolist()
        raise AssertionError(f"kernel B != plain at {n} lanes, lanes {bad[:20]}")
    if got_big.cpu().numpy().tolist() != [bool(oracle[i % len(pool)]) for i in range(n)]:
        raise AssertionError(f"kernel B != the pure-Python oracle at {n} lanes")
    err_b = max(err_b, int((got_big.int() - want_big.int()).abs().max()))
    print(f"kernel B == plain == oracle: {n} lanes, {int(got_big.sum())} accepted")
    ms_a = cuda_ms(lambda: ed25519_challenge(big), 50)
    plain_ms_a = cuda_ms(lambda: challenge_windows_plain(big), 3)
    ms_b = cuda_ms(lambda: ed25519_verify_ladder(big, win_big, table), 10)
    plain_ms_b = cuda_ms(lambda: verify_ladder_plain(big, win_big, table), 1)
    int_rate = INT32_OPS_PER_CLOCK_PER_SM * n_sm * sm_clock_mhz * 1e6

    def bound(bytes_moved, ops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int_rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    bound_a = bound(n * (128 + 64 * 4), n * CHALLENGE_INT_OPS_PER_LANE)
    bound_b = bound(n * (161 + 64 * 4 + 1) + TABLE_ROWS * 40,
                    n * (FIELD_MUL_PER_VERIFY * INT_OPS_PER_FIELD_MUL
                         + FIELD_SQ_PER_VERIFY * INT_OPS_PER_FIELD_SQ))
    for name, ms, plain_ms, (b_ms, b_by) in (
        ("ed25519_challenge", ms_a, plain_ms_a, bound_a),
        ("ed25519_verify_ladder", ms_b, plain_ms_b, bound_b),
    ):
        print(f"{name}: {ms:.4f} ms at B={n} (plain {plain_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)  [{card}]")

    # one lane per thread: the ladder's time per launch against its lanes
    sweep = []
    for lanes in (1024, n, 4 * n):
        reps = -(-lanes // n)
        packed_l = big.repeat(reps, 1)[:lanes].contiguous()
        win_l = win_big.repeat(1, reps)[:, :lanes].contiguous()
        sweep.append((lanes, cuda_ms(lambda: ed25519_verify_ladder(packed_l, win_l, table), 5)))
    print("ed25519_verify_ladder per launch: " + ", ".join(
        f"{lanes} lanes {ms:.3f} ms" for lanes, ms in sweep) + f"  [{card}]")

    # the host's share of one full bucket: prep and enqueue on the
    # dispatching thread (host clock), against the kernels' time
    rows_n = [(PublicKey(4, pk), s, m) for pk, s, m in (pool[i % len(pool)] for i in range(n))]
    prep_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = dispatch_signature_rows(rows_n, min_bucket=n, device=dev)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        pending.collect()
    print(f"one {n}-row bucket: host prep + enqueue {sorted(prep_ms)[2]:.2f} ms "
          f"(median of 5), kernels A + B {ms_a + ms_b:.2f} ms  [{card}]")
    # where the host's share goes: one more dispatch under cProfile (which
    # inflates Python-heavy calls; read it as a ranking, not as times)
    torch.cuda.synchronize()
    prof_host = cProfile.Profile()
    pending = prof_host.runcall(dispatch_signature_rows, rows_n, min_bucket=n, device=dev)
    pending.collect()
    top = sorted(pstats.Stats(prof_host).stats.items(), key=lambda kv: -kv[1][2])[:6]
    print("host prep under cProfile, by own time: " + ", ".join(
        f"{func[2]} ({func[0].rsplit('/', 1)[-1]}:{func[1]}) {tt * 1e3:.2f} ms"
        for func, (_cc, _nc, tt, _ct, _callers) in top))

    print(json.dumps({"kernels": [
        {"name": "ed25519_challenge", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_challenge.cu",
         "replaces": "corda_tpu/ops/ed25519.py:355",
         "launches": launches_a, "max_abs_err": float(err_a), "ms": ms_a,
         "plain_ms": plain_ms_a, "bound_ms": bound_a[0], "bound_by": bound_a[1],
         "library_ms": None},
        {"name": "ed25519_verify_ladder", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "corda_tpu/ops/ed25519_pallas13.py:388",
         "launches": launches_b, "max_abs_err": float(err_b), "ms": ms_b,
         "plain_ms": plain_ms_b, "bound_ms": bound_b[0], "bound_by": bound_b[1],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
