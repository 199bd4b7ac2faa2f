#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits nonzero):

1. the card's name and power limit (as nvidia-smi reports them), the
   torch/CUDA versions, and the kernel build from csrc/ (seconds, and
   ptxas' registers and spills; A's and C's with their shared memory);
2. kernel A (ed25519_challenge) against its plain version: 1, 32 (one
   warp), 37, 512 and 8192 lanes of 44-byte messages plus lanes of 0 and
   47 bytes, exactly equal, and equal to hashlib on a sample;
3. kernel B (ed25519_verify_ladder) against its plain version, run on the
   card: 1024 lanes with every adversarial kind, exactly equal, and equal
   to the pure-Python oracle (phase 5 repeats this at 8192 lanes);
4. the main path: a DeviceScheduler on the card serves a backlog of
   69,410 signatures in 26 requests from four threads across the three
   priority classes (sizes 1 to 8192, one request of variable-length
   messages on the host-hash route); every row must settle on the device,
   both kernels' launch counters (zeroed just before) must have risen, and
   every verdict must equal the oracle where the cofactorless rule and the
   cofactored rule of full buckets agree (a batch that fills its bucket
   takes the cofactored one); of the rows where they differ it prints how
   many took each. The same backlog is then served
   twice more, for the steady rate and under torch.profiler for the
   device's busy share, with the same checks. Kernel A is then held
   against its plain version and hashlib at every batch size the path
   launched it at in the three passes (each batch's pad bucket, from the
   requests that rode in it; as many of the first pass's as A's launches);
5. times at B = 8192 (each kernel on the card, with the stream held while
   the host queues its runs, and kernel A's host time a call; each plain
   version from CUDA events) and the end-to-end rate through the
   scheduler, each beside the card's name and power limit; the bound of
   each kernel; kernel A's time at B = 1, 32, 512 and 8192 beside its
   bound and its serial floor (the rounds warp's chain at one
   scheduler's rate); the ladder's time per launch at 1024, 8192 and 32768
   lanes; the host's prep and enqueue time for one 8192-row bucket (a
   full bucket: the cofactored rule's prep);
6. kernels C (sha256_leaves) and D (sha256_merkle_sweep) against their
   plain versions and hashlib: 8,192 messages of 0-1,100 bytes with every
   padding boundary, and one sweep of two levels (8,192 pairs, then 4,096
   of their parents);
7. kernel E (ed25519_comb) against its plain version and the pure-Python
   oracle on 1,024 lanes (0, 1, L - 1, 2^252, 2^256 - 1, 16^k * j for
   every window k and scalars whose digits fall in one quad's windows among
   them), and ed25519_sign_batch on the card byte-equal to the oracle's
   signer on 256 signatures;
8. the notary path: a BatchedNotaryService(validating=False) on the card
   notarises 24,576 Cash moves signed by Alice (signed on the card by
   kernel E) plus one request of each adversarial kind, through
   process_stream over windows of 2,048 at depth 3. Every request must
   come back as its expected kind, every signature must verify (all
   through the port's verify path, 512 through the oracle, over ids the
   host recomputes), the launch counters of kernels A to E (zeroed just
   before) must all have risen, and kernel D must have launched once for
   each id sweep of the pass. It prints notarised tx/s for a first and a
   steady pass, the device's busy share over a profiled pass, the host
   time per window of the id sweep's prep, the commit and the signing's
   host half. Then it holds C, D and E against their plain versions at one
   window's shapes (D's whole sweep in one launch), holds D and the ids on
   the card against the host's on a cohort led by the stream's issue (a
   group of 24,580 components), and prints each kernel's time on the card
   and the host's time a call against its bound and its plain version, the
   share of E's time that its inversion takes (csrc/fe_chain_probe.cu), and
   ptxas' report for C, D and E. It also holds C against its plain version
   and hashlib at 2,048 and at 32 leaves of 13 blocks and on the deep
   cohort's leaves, and prints C's time at the window's leaves and at both
   of those beside its serial floor (the longest message's rounds on the
   consumer warp at one scheduler's rate);
9. kernel F (ecdsa_verify_k1, ecdsa_verify_r1) against its plain version
   on the card, each curve: 1,024 lanes with every adversarial kind of
   testing.ecdsa_adversarial_lanes, exactly equal, and equal to the
   pure-Python oracle on a sample of 512, then the same at the main path's
   shape (those lanes tiled to 1,365 and padded to 8,192); ptxas' report
   for it and each block's dynamic shared memory (its k*Q tables); its
   time at B = 512,
   1,365 and 8,192 lanes and at the main path's shape (1,365 signatures
   padded to 8,192 lanes) against its bound, and the plain version's time;
10. the mixed-scheme path: a DeviceScheduler on the card serves bench.py's
   whole MIXED_COMPOSITION (2,048 ed25519, 512 secp256k1, 512 secp256r1,
   8 SPHINCS and 8 RSA rows, 16 keys a scheme, fewer where a scheme has
   fewer rows), tiled 8 times to 24,704 rows with the adversarial ECDSA,
   SPHINCS and RSA lanes at known positions, in 14 requests of 1 to 8,192
   rows from four threads across the three classes. Every verdict must
   equal the oracle, every row but the RSA ones (which the host settles,
   as in the reference) must settle on the device, and the launch counters
   of A, B, both halves of F and H (zeroed just before) must all have
   risen. It prints sigs/s for a first and two steady passes, and for
   two passes of the three-scheme cut (the same rows less SPHINCS and RSA,
   every verdict equal to the oracle) in the same scheduler, the device's busy share over a profiled pass by name (H
   included), the padded share of the lanes, and the host prep of one
   8,192-row mixed batch, with its ECDSA prep, its SPHINCS prep and its
   RSA bucket;
11. the four verify ladders, kernel B (ed25519_verify_ladder and
   ed25519_verify_ladder_w4: the radix-8192 tier, the comb and the 16-entry
   window) and kernel G (ed25519_verify_g8, ed25519_verify_g4: the
   radix-4096 tier, both shapes), against their plain versions on the card:
   phase 3's 1,024 lanes with every adversarial kind, exactly equal, and
   equal to the oracle; their times from CUDA events in turns at B = 1,024,
   8,192 and 32,768, each with its bound and share of it, the plain
   versions' times, ptxas' report (registers, spills, stack frame) and
   each block's dynamic shared memory as the launch sets it; then each
   kernel again against its plain version's result at 8,192 lanes (the
   run that timed it) and that result tiled at 1,024 and 32,768 lanes,
   and that plain result against the oracle tiled;
12. phase 4's backlog through a DeviceScheduler of Ed25519Tier(4096, 8):
   every verdict equal to the oracle as in phase 4, every row settled on
   the device, G's launch counter risen and B's not; sigs/s for a first and
   a steady pass and the device's busy share over a profiled pass;
13. the validating notary: BatchedNotaryService(validating=True) over
   24,576 Cash moves plus every adversarial kind, the contract-invalid
   ones included, windows of 2,048 at depth 3, on each of the four tiers
   (radix 8192 and radix 4096, each with the comb and with the 16-entry
   window). Every request
   must come back as its expected kind, the answers of the tiers must be
   equal request for request (signature bytes included), and the launch
   counters of A, C, D, E and the tier's ladder (zeroed just before) must
   have risen while the other ladders' stayed at 0. It prints notarised
   tx/s for a first and a steady pass on each tier and the host ms per
   window of the validation stage (to_ledger_transaction and
   verify_ledger_batch);
14. full ed25519 buckets under the cofactored rule of the reference's RLC
   route, on each of the four tiers: phase 3's lanes plus the 8 small-order
   encodings as A and as R and an R of small order that the cofactorless
   rule accepts, tiled to 8,192 rows. A full bucket through
   dispatch_signature_rows must equal the port's verify_single row by row
   (the tier's ladder launched, the others not), the ladder's cofactored
   launch its plain version at 1,024, 8,192 and 32,768 lanes, and a
   partial bucket the cofactorless oracle; it prints each ladder's time in
   both modes, in turns;
15. the back-chain resolve (BASELINE config #4): verify_transaction_dag on
   the card through the shared scheduler over testing.back_chain(1000), an
   issue and 1,000 self-moves of Cash (1,001 transactions and signatures,
   four windows of 256 at depth 3, every id cache cold on every pass). The
   result (order, levels, signatures, consumed set) must equal the port's
   host route (use_device=False), every primed id must equal hashlib's id
   of the same bytes, the launch counters of A, C, D and B (zeroed just
   before) must rise while the other ladders' and E's stay at 0, and the
   scheduler's batch counter must rise. It prints resolved tx/s for a first
   pass and the median of three steady passes with their spread, the
   card's busy share over a profiled pass, and the host ms a window of each
   stage over a pass of its own (level sort, id plan and enqueue, flatten
   and submit, id collect, verdict collect, consumed set and resolution,
   to_ledger_transaction + verify_ledger_batch). The same checks on a
   GeneratedLedger DAG of 2,048 transactions and 8 parties, on kernel B
   and on kernel G (radix 4096, comb). Then each failure kind on the card:
   a forged chain link in window 2 raises at its own window and leaves no
   claimed id cached, a tampered signature, a double spend, an orphan and
   a non-conserving Cash move raise, and a CommercialPaper issue, move and
   redemption with its Cash resolves as on the host;
16. kernel H (sphincs_verify) alone: against its plain version on the
   card, exactly equal, at 8, 32, 64 and 1,024 lanes of a few distinct
   signatures tiled with every adversarial kind of
   testing.sphincs_adversarial_lanes, and equal to the host engine
   (sphincs.verify); ptxas' report and each block's shared memory; its
   time on the card and the host's time a call at 8, 32 (the mixed path's
   bucket), 64 and 1,024 lanes of valid signatures, each beside its bound
   (the SHA-256 blocks those lanes need, chain steps from each digit
   only, the digits read from the plain version's stages, against the
   bytes), its serial floor (the longest lane's critical chain of
   operations in the redesigned kernel at one scheduler's rate,
   ``sphincs_chain_ops``, beside the one-thread design's chain of dependent
   blocks), its plain version's time and the host route's (sphincs.verify
   a lane, pure Python).

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero before any
result.

    python3 chip_smoke.py --ladders TREE

runs phases 11 and 9 alone (the ed25519 ladders, then kernel F on both
curves), as the chip_smoke.py of TREE (a checkout of this repository, of
this commit or another) does them, on that tree's kernels: to compare two
commits' ladders on one card, unpack the other with ``git archive`` into a
directory ``.gitignore`` lists and run, in one call, ``--ladders OTHER``,
``--ladders .``, ``--ladders .``, ``--ladders OTHER``.

    python3 chip_smoke.py --notary-kernels TREE

times the notary's signing and id kernels on TREE's package and kernels,
with this script's timer (the card's time, the stream held while the host
queues the runs, beside the host's time a call): kernel E at one window's
2,048 lanes, and kernel D over the Merkle levels of one window of the
notary stream (2,048 requests): TREE's one sweep launch
(``sha256_merkle_sweep``) where it has one, else its launch a level
(``sha256_pair_level``) over the same plan. Run it as ``--ladders`` is
run, in the order other, this, this, other.

    python3 chip_smoke.py --hash-kernels TREE

holds and times kernels C and A on TREE's package and kernels, each
called as that tree's own paths call it, with this script's timer: C at
one notary window's leaves, at 2,048 leaves of 13 blocks and at one warp
of leaves of 13, 1 and 7 blocks; A at B = 1, 32, 512 and 8,192; with
TREE's ptxas report for both. Run it as ``--ladders`` is run.

    python3 chip_smoke.py --sphincs-kernel TREE

holds kernel H of TREE's package and kernels against the host engine on
every adversarial kind, and times it with this script's timer at 8, 32,
64 and 1,024 lanes of valid signatures, with TREE's ptxas report and
shared memory. Run it as ``--ladders`` is run.

    python3 chip_smoke.py --sphincs-stages TREE

builds a copy of TREE's kernel H that stamps the SM clock after each
stage's barrier and prints each stage's median clocks over the blocks at
32 and 1,024 lanes (stage 0 the FORS trees, 1 the FORS pk, then each
layer's chains and its WOTS pk and auth path).
"""

from __future__ import annotations

import cProfile
import functools
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
INT32_OPS_PER_CLOCK_PER_SCHEDULER = INT32_OPS_PER_CLOCK_PER_SM // 4  # four a SM

NOTARY_TXS = 24576     # bench.py's notarisation stream
NOTARY_WINDOW = 2048   # bench.py's NOTARY_CHUNK
NOTARY_DEPTH = 3
SHA_LANES = 8192
SHA_BOUNDARIES = [0, 1, 55, 56, 63, 64, 65, 119, 120, 127, 128, 1100]
COMB_LANES = 1024
SIGN_SAMPLE = 256
ORACLE_SAMPLE = 512

ECDSA_LANES = 1024      # phase 9's lanes a curve
ECDSA_SHARE = 1365      # a curve's rows in an 8,192-row mixed batch
MIXED_TILE = 8          # phase 10: 3,088 distinct rows x 8 = 24,704
MIXED_SIZES = [8192, 6128, 4096, 3000, 1500, 1024, 300, 256, 100, 64, 33, 8, 2, 1]
H_SIZES = (8, 32, 64, 1024)   # phase 16: kernel H's lanes; 32 is the mixed path's bucket

G_SIZES = (1024, 8192, 32768)  # phase 11's lanes a launch

A_SIZES = (1, 32, 512, 8192)  # kernel A's held and timed batches; 32 is one warp
C_LONG_BYTES = 800            # a 13-block leaf, as long as a notary window's longest
C_LONG_LANES = (2048, 32)     # a window's count of 13-block leaves, and one warp of them

RESOLVE_HOPS = 1000    # BASELINE config #4: a 1k-hop Cash back-chain
RESOLVE_WINDOW = 256   # verify_transaction_dag's window and depth
RESOLVE_DEPTH = 3
GEN_TXS = 2048         # phase 15's generated DAG
GEN_PARTIES = 8

MAIN_PATH_SIZES = [8192] * 6 + [6000, 4096, 3000, 2048, 1500, 1024, 777, 512,
                                300, 256, 100, 64, 33, 17, 8, 5, 3, 2, 1]
VAR_REQUEST_ROWS = 512


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_times(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per run of ``fn`` over ``reps`` runs, after one
    warm-up run. A sleeping kernel holds the stream while the host enqueues
    every run, so the CUDA events time the runs back to back on the card,
    not the host's rate of launching them (for a kernel shorter than its
    wrapper, back-to-back calls measure the wrapper). The host ms is the
    enqueue time per run. If the hold ran out before the last run was
    queued, it is doubled and the runs repeated."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = max(2 * reps * (time.perf_counter() - t0), 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(int(hold_s * 2e9))  # cycles; at most 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_ms
        hold_s *= 2
    raise AssertionError("the stream's hold ran out before every run was queued")


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per run of a kernel's wrapper (``device_times``)."""
    return device_times(fn, reps)[0]


def plain_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of a plain version over ``reps`` runs, from CUDA
    events around back-to-back calls after one warm-up run (a plain
    version is a long host-driven run of small operations)."""
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


def card_rates() -> tuple[int, float, float]:
    """The card's SM count, its maximum SM clock in MHz and its peak rate of
    32-bit integer operations a second."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return n_sm, mhz, INT32_OPS_PER_CLOCK_PER_SM * n_sm * mhz * 1e6


def adversarial_pool(n: int = 1024, seed: int = 7):
    """Phase 3's lanes: one of every adversarial kind of
    ``testing.adversarial_lanes``, then signed triples up to ``n``. Returns
    the kinds, the (pk, sig, msg) triples and the pure-Python oracle's
    verdicts."""
    import numpy as np

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.testing import adversarial_lanes, signed_triples

    lanes = adversarial_lanes(seed)
    pool = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    pool += signed_triples(n - len(pool), seed=seed)
    return [k for k, *_ in lanes], pool, np.array([ed25519_host.verify(*t) for t in pool])


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


def pack_triples(triples, cofactored=False):
    import numpy as np

    from corda_tpu_torch.ops import ed25519 as ed

    pks, sigs, msgs = map(list, zip(*triples))
    pk_arr, sig_arr, ok = ed._gather_fixed(pks, sigs, len(pks))
    _y, _s, s_arr, pre = ed._canonical_precheck(pk_arr, sig_arr, ok, cofactored)
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


def check_backlog(results, requests, n_rows, device_rows_want=None) -> tuple[int, int]:
    """Every request answered, every row settled on the device (or
    ``device_rows_want`` of them, where host rows ride along), every
    verdict equal to the oracle. A request (rows, want, class, want_cof)
    also carries the cofactored rule's verdicts, which a full ed25519
    bucket takes: where the two rules agree the verdict must equal both,
    and where they differ it takes one of them. Returns how many rows on
    which the rules differ took the cofactored verdict, and how many the
    cofactorless one."""
    if len(results) != len(requests):
        raise AssertionError("not every request was submitted")
    device_rows = 0
    took = [0, 0]
    for k, req in enumerate(requests):
        want_k = req[1]
        want_cof = req[3] if len(req) > 3 else want_k
        got = results[k].mask.tolist()
        if len(got) != len(want_k):
            raise AssertionError(f"request {k}: {len(got)} verdicts for {len(want_k)} rows")
        for i, (g, w, c) in enumerate(zip(got, want_k, want_cof)):
            if w == c and g != w:
                raise AssertionError(f"request {k}, row {i}: verdict differs from the oracle")
            if w != c:
                took[g == w] += 1
        device_rows += results[k].n_device
    want_rows = n_rows if device_rows_want is None else device_rows_want
    if device_rows != want_rows:
        raise AssertionError(f"device_rows {device_rows} != {want_rows} of the {n_rows} rows")
    return took[0], took[1]


def device_busy(prof) -> tuple[float, dict]:
    """(device-busy ms, {kernel or copy name: us}) of a profiled run."""
    device_us = {}
    for evt in prof.key_averages():
        if evt.self_device_time_total > 0:
            device_us[evt.key] = device_us.get(evt.key, 0.0) + evt.self_device_time_total
    return sum(device_us.values()) / 1e3, device_us


def challenge_batches(results, rows_by_req) -> list[int]:
    """Kernel A's batch size in each device batch of one backlog pass that
    launches it, from the batch each request rode in (its ``batch_seq``):
    the pad bucket that the scheduler and the ed25519 dispatch give the
    batch's rows, where they all carry messages of one length of at most
    MAX_FIXED_MSG bytes (the rows are all ed25519)."""
    from collections import Counter, defaultdict

    from corda_tpu_torch.ops._blockpack import bucket_floor, pow2_at_least
    from corda_tpu_torch.ops.ed25519 import MAX_FIXED_MSG
    from corda_tpu_torch.serving.shapes import shape_table

    rows, lengths = Counter(), defaultdict(set)
    for k, rr in results.items():
        rows[rr.batch_seq] += len(rows_by_req[k])
        lengths[rr.batch_seq].update(len(m) for _key, _sig, m in rows_by_req[k])
    table = shape_table()
    return [pow2_at_least(n, bucket_floor(table.bucket_for(n), True))
            for seq, n in rows.items()
            if len(lengths[seq]) == 1 and max(lengths[seq]) <= MAX_FIXED_MSG]


def backlog_passes(dev, rows_by_req, requests, classes, n_rows, kernels, tier=None):
    """The backlog through a DeviceScheduler of ``tier`` three times, each
    pass checked: first with ``kernels``' launch counters zeroed just
    before and read just after, then steady, then profiled. Returns
    (launches, counters, batches, first CUDA ms, first host ms, steady CUDA
    ms, profiler, profiled host ms, check_backlog's split of the first
    pass, and kernel A's batch sizes in each pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.serving import DeviceScheduler

    sched = DeviceScheduler(device=dev, tier=tier)
    try:
        # warm-up: pinned staging buffers and the table's first upload
        sched.submit_rows(rows_by_req[-1]).result(timeout=300)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        results, e2e_ms, wall_ms = serve_backlog(sched, rows_by_req, classes)
        launches = {k.__name__: k.launches for k in kernels}
        counters = dict(sched.counters)
        # the same backlog twice more, with every bucket's buffers warm:
        # once for the steady rate, once under the profiler for the
        # device's busy share
        steady, steady_ms, _ = serve_backlog(sched, rows_by_req, classes)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _, prof_wall_ms = serve_backlog(sched, rows_by_req, classes)
    finally:
        sched.shutdown()
    took = [check_backlog(res, requests, n_rows) for res in (results, steady, profiled)][0]
    batches = sorted({rr.batch_seq for rr in results.values()})
    a_batches = [challenge_batches(res, rows_by_req) for res in (results, steady, profiled)]
    return (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof, prof_wall_ms, took,
            a_batches)


def bound(bytes_moved, ops, int_rate):
    """(least ms, what bounds it): bytes over the HBM rate against 32-bit
    integer operations over the card's integer rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serial_floor_ms(chain_ops: int, mhz: float) -> float:
    """The least time of one warp whose lanes each run a serial chain of
    ``chain_ops`` integer operations: 32 lanes at one scheduler's rate."""
    return chain_ops * 32 / INT32_OPS_PER_CLOCK_PER_SCHEDULER / (mhz * 1e3)


def sphincs_lane_work(signed: list[bytes]) -> tuple[int, int]:
    """(SHA-256 blocks, longest chain of dependent blocks) of one prechecked
    SPHINCS lane, for kernel H's bound and serial floor, from the D digests
    its layers sign: the FORS pk, then each layer's root but the top (the
    plain version's stages). Kernel H runs steps digit .. W - 2 of each
    chain only; the chain is a FORS tree, the FORS pk, then per layer its
    longest chain, the WOTS pk and the auth path."""
    from corda_tpu_torch.crypto.sphincs import A, D, HT, K, LEN, N, W, _digits
    from corda_tpu_torch.ops.sphincs_batch import _blocks

    assert len(signed) == D
    # each hash is tag || pub_seed || address (20 bytes) || data
    fors_tree = _blocks(8 + 52 + N) + A * _blocks(8 + 52 + 2 * N)  # 2 + 8 x 3
    fors_pk = _blocks(6 + 52 + K * N)  # 9
    step = _blocks(2 + 52 + N)  # 2
    per_layer = _blocks(6 + 52 + LEN * N) + HT * _blocks(4 + 52 + 2 * N)  # 35 + 6 x 3
    steps = [[W - 1 - d for d in _digits(dg)] for dg in signed]
    blocks = K * fors_tree + fors_pk + step * sum(map(sum, steps)) + D * per_layer
    chain = fors_tree + fors_pk + sum(step * max(s) + per_layer for s in steps)
    return blocks, chain


def sphincs_chain_ops(signed: list[bytes], idx: int) -> int:
    """The 32-bit integer operations on one prechecked SPHINCS lane's
    critical chain in kernel H (csrc/sphincs.cuh), for its serial floor,
    from the D digests its layers sign (as ``sphincs_lane_work``) and its
    hypertree index. With ops/sha256.py's counts, a round R = 14, a
    schedule word S = 10 and the final adds F = 8, so a block is 1,384 on
    one thread and its consumer's share C = 64R + F = 904 on the warp pair
    (the producer's schedule runs beside it); a hoisted first block starts
    at round 13 or 14:

        FORS tree   (51R + F + C) + A (51R + F + 2C)        on the pair
        FORS pk     (50R + F) + 8C                          on the pair
        per layer   s (51R + 48S + F + 1,384)               its longest chain, s steps,
                                                            on one thread
                    + (50R + F) + 34C                       the WOTS pk, on the pair
                    + per auth level 2C at an odd position (the first block
                      hoisted whole), (50R + F) + 2C at an even one."""
    from corda_tpu_torch.crypto.sphincs import A, D, HT, W, _digits
    from corda_tpu_torch.ops.sha256 import INT_OPS_PER_BLOCK, INT_OPS_ROUNDS_PER_BLOCK

    assert len(signed) == D
    r, s, f, c = 14, 10, 8, INT_OPS_ROUNDS_PER_BLOCK
    from13, from14 = (64 - 13) * r + f, (64 - 14) * r + f
    ops = (from13 + c) + A * (from13 + 2 * c) + from14 + 8 * c
    for layer, dg in enumerate(signed):
        steps = W - 1 - min(_digits(dg))
        ops += steps * (from13 + 48 * s + INT_OPS_PER_BLOCK) + from14 + 34 * c
        leaf = (idx >> (HT * layer)) & ((1 << HT) - 1)
        ops += sum(2 * c if (leaf >> lvl) & 1 else from14 + 2 * c for lvl in range(HT))
    return ops


def print_ptxas(label: str, names) -> None:
    """ptxas' report (entry, registers and shared memory, stack and spills)
    of the kernels whose entry names contain one of ``names``."""
    from corda_tpu_torch.ops import _build

    entry = ""
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = line
        if any(name in entry for name in names) and any(
                w in line for w in ("Compiling entry", "registers", "spill")):
            print(f"ptxas ({label}):", line.strip())


def hold_challenge(dev, rng, n: int, mlen: int = 44):
    """Kernel A against its plain version on ``n`` lanes of ``mlen``-byte
    messages, exactly, and against hashlib on a sample; returns (the
    packed plane on ``dev``, the largest difference)."""
    import torch

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain, ed25519_challenge

    plane, msgs = fixed_plane(rng, n, mlen)
    packed = torch.from_numpy(plane).to(dev)
    got = ed25519_challenge(packed)
    want = challenge_windows_plain(packed)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel A != plain at {n} lanes, {mlen}-byte messages")
    host = got.cpu().numpy()
    for i in sorted({*range(0, n, max(1, n // 64)), n - 1}):
        h = int.from_bytes(hashlib.sha512(
            plane[i, :64].tobytes() + msgs[i]).digest(), "little") % ed25519_host.L
        if [int(v) for v in host[:, i]] != [(h >> (4 * k)) & 15 for k in range(64)]:
            raise AssertionError(f"kernel A != hashlib at lane {i} of {n}")
    return packed, int((got - want).abs().max())


def hold_leaves(dev, msgs, label: str):
    """Kernel C against its plain version and hashlib on ``msgs``; returns
    (the uploaded blocks, offsets and counts, the digests, the largest
    difference)."""
    import torch

    from corda_tpu_torch.ops import sha256 as sha

    up = sha.upload_messages(msgs, dev)
    got = sha.sha256_leaves(*up)
    want = sha.sha256_leaves_plain(*up)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel C != plain at {label}")
    if sha.digest_words_to_bytes(got.cpu().numpy()) != [hashlib.sha256(m).digest() for m in msgs]:
        raise AssertionError(f"kernel C != hashlib at {label}")
    return up, got, int((got.long() - want.long()).abs().max())


def check_sha256_kernels(dev, rng, n: int = SHA_LANES) -> tuple[int, int]:
    """Phase 6: kernels C and D against their plain versions and hashlib;
    returns each kernel's largest difference from its plain version (0)."""
    import numpy as np
    import torch

    from corda_tpu_torch.ops import sha256 as sha

    lengths = SHA_BOUNDARIES + [rng.randrange(0, 1101) for _ in range(n - len(SHA_BOUNDARIES))]
    msgs = [rng.randbytes(k) for k in lengths]
    (_blocks, _offs, cnts), got, err_c = hold_leaves(dev, msgs, f"{n} messages")
    print(f"kernel C == plain == hashlib: {n} messages of 0-1100 bytes "
          f"({int(cnts.sum())} blocks, boundaries {SHA_BOUNDARIES})")

    # two levels in one sweep over a pool of 2n digests: n pairs of children
    # in shuffled order, then n / 2 pairs of those parents
    pool = torch.cat([got, torch.flip(got, [0]), torch.zeros_like(got),
                      torch.zeros_like(got[: n // 2])]).contiguous()
    perm = np.array(rng.sample(range(2 * n), 2 * n), dtype=np.int32)
    second = np.arange(2 * n, 3 * n, dtype=np.int32)
    pairs = [(2 * n, perm[:n], perm[n:]), (3 * n, second[0::2], second[1::2])]
    levels = [(first, torch.from_numpy(left.copy()).to(dev), torch.from_numpy(right.copy()).to(dev))
              for first, left, right in pairs]
    pool_plain = pool.clone()
    sha.sha256_sweep_plain(pool_plain, levels)
    sha.sha256_merkle_sweep(pool, levels)
    if not torch.equal(pool, pool_plain):
        raise AssertionError("kernel D != plain")
    rows = sha.digest_words_to_bytes(pool.cpu().numpy())
    for first, left, right in pairs:
        if rows[first : first + len(left)] != [
                hashlib.sha256(rows[a] + rows[b]).digest() for a, b in zip(left, right)]:
            raise AssertionError(f"kernel D != hashlib at the level from row {first}")
    err_d = int((pool.long() - pool_plain.long()).abs().max())
    print(f"kernel D == plain == hashlib: one launch of two levels, {n} and {n // 2} pairs")
    return err_c, err_d


def check_comb_kernel(dev, rng, n: int = COMB_LANES) -> int:
    """Phase 7: kernel E against its plain version and the oracle, and
    signing on the card against the oracle's signer; returns the largest
    difference (0)."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ed25519_host as host
    from corda_tpu_torch.ops.ed25519_sign import (
        comb_plain,
        comb_table,
        ed25519_comb,
        ed25519_sign_batch,
    )

    L = host.L
    rs = [0, 1, L - 1, 2**252, 2**256 - 1]
    rs += [j * 16**k for k in range(64) for j in (1 + k % 15, 15)]
    # digits in one quad's 16 windows only (each quad in turn)
    rs += [v << (64 * q) for q in range(4) for v in (2**64 - 1, 1, rng.randrange(2**64))]
    rs += [rng.randrange(L) for _ in range(n - len(rs))]
    raw = np.frombuffer(b"".join(r.to_bytes(32, "little") for r in rs), np.uint8)
    r_dev = torch.from_numpy(raw.reshape(n, 32).copy()).to(dev)
    table = comb_table(dev)
    got = ed25519_comb(r_dev, table)
    want = comb_plain(r_dev, table)
    if not torch.equal(got, want):
        raise AssertionError("kernel E != plain")
    enc = [bytes(row) for row in got.cpu().numpy()]
    oracle = [host.compress(host.scalar_mul(r % L, host.BASE)) for r in rs]
    if enc != oracle:
        bad = [i for i, (a, b) in enumerate(zip(enc, oracle)) if a != b]
        raise AssertionError(f"kernel E != the oracle at lanes {bad[:20]}")
    err = int((got.int() - want.int()).abs().max())
    print(f"kernel E == plain == oracle: {n} lanes (0, 1, L-1, 2^252, 2^256-1, 16^k*j for "
          f"every window k, digits in one quad's windows only)")
    seeds = [hashlib.sha256(b"signer %d" % (i % 7)).digest() for i in range(SIGN_SAMPLE)]
    msgs = [rng.randbytes(rng.randrange(0, 200)) for _ in range(SIGN_SAMPLE)]
    if ed25519_sign_batch(seeds, msgs, device=dev) != [host.sign(k, m) for k, m in zip(seeds, msgs)]:
        raise AssertionError("ed25519_sign_batch on the card != the oracle's signer")
    print(f"ed25519_sign_batch on the card == ed25519_host.sign: {SIGN_SAMPLE} signatures")
    return err


def timed(fn, acc: list):
    """``fn`` with its host-clock seconds appended to ``acc`` per call."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc.append(time.perf_counter() - t0)
    return wrapper


def notary_pass(dev, stream, windows, *, sync, host_times=None, validating=False,
                tier=None):
    """One pass of the notary over ``windows`` of the stream, from a fresh
    provider with every id cache cold: (results per window, seconds). A
    validating notary resolves inputs over the stream's issue."""
    from corda_tpu_torch.notary import BatchedNotaryService, PersistentUniquenessProvider
    from corda_tpu_torch.testing import state_resolver

    for w in windows:
        for stx in w:
            stx.tx.__dict__.pop("_id", None)
    svc = BatchedNotaryService(
        stream.notary, stream.notary_keypair, PersistentUniquenessProvider(),
        validating=validating, use_scheduler=True, max_batch=len(windows[0]), device=dev,
        tier=tier)
    if host_times is not None:
        svc.dispatch_ids = timed(svc.dispatch_ids, host_times["ids"])
        svc.uniqueness.commit_batch_async = timed(svc.uniqueness.commit_batch_async,
                                                  host_times["commit"])
        svc._dispatch_sign = timed(svc._dispatch_sign, host_times["sign"])
        if "validate" in host_times:
            svc.validate = timed(svc.validate, host_times["validate"])
    resolve = state_resolver(stream.issue.tx) if validating else None
    requests = [[(stx, resolve, "alice") for stx in w] for w in windows]
    sync()
    t0 = time.perf_counter()
    out = svc.process_stream(requests, depth=NOTARY_DEPTH)
    sync()
    return out, time.perf_counter() - t0


def check_notary_results(out, stream, dev, oracle: bool) -> int:
    """Every request came back as its expected kind; every signature
    verifies through the port's verify path, and (``oracle``) a sample
    through the oracle over ids the host recomputes. Returns the signed
    count."""
    from corda_tpu_torch.crypto import ed25519_host as host
    from corda_tpu_torch.serialization import deserialize
    from corda_tpu_torch.testing import outcome_kind
    from corda_tpu_torch.verifier import verify_signature_rows

    got = [[outcome_kind(r) for r in w] for w in out]
    if got != stream.kinds:
        bad = [(wi, si, g, k) for wi, (gw, kw) in enumerate(zip(got, stream.kinds))
               for si, (g, k) in enumerate(zip(gw, kw)) if g != k]
        raise AssertionError(f"notary outcomes differ (window, slot, got, want): {bad[:10]}")
    flat = [(stx, r) for w_out, w_in in zip(out, stream.windows)
            for stx, r in zip(w_in, w_out) if outcome_kind(r) == "signed"]
    rows = [(r.by, r.signature, r.signable_for(stx.id)) for stx, r in flat]
    if not verify_signature_rows(rows, device=dev).all():
        raise AssertionError("a notary signature fails the port's verify path")
    for stx, r in [] if not oracle else flat[:: max(1, len(flat) // ORACLE_SAMPLE)][:ORACLE_SAMPLE]:
        tx_id = deserialize(stx.tx_bits).id  # recomputed on the host
        if tx_id != stx.id or not host.verify(r.by.encoded, r.signature, r.signable_for(tx_id)):
            raise AssertionError(f"notary signature on {tx_id} fails the oracle")
    return len(flat)


def notary_phase(dev, rng, card, int_rate, n_moves=NOTARY_TXS, window=NOTARY_WINDOW):
    """Phase 8: the notary stream through process_stream, its checks and
    numbers, and kernels C, D and E held against their plain versions and
    timed at one window's shapes, D also on the deep cohort. Returns the
    launch counts of the first pass and (ms, plain ms, bound, largest
    difference from the plain version) per new kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.crypto import (
        CURRENT_PLATFORM_VERSION,
        EDDSA_ED25519_SHA512,
        SignableData,
        SignatureMetadata,
        ed25519_host,
    )
    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.ops import _build, txid
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.ed25519_sign import (
        COMB_INT_OPS_PER_LANE,
        COMB_ROWS,
        comb_plain,
        comb_table,
        ed25519_comb,
        ed25519_sign_dispatch,
    )
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import (
        INT_OPS_PER_BLOCK,
        INT_OPS_PER_PAIR,
        INT_OPS_ROUNDS_PER_BLOCK,
        digest_words_to_bytes,
        pack_messages,
        sha256_leaves,
        sha256_leaves_plain,
        sha256_merkle_sweep,
        sha256_sweep_plain,
    )
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import ADVERSARIAL_KINDS, notary_stream

    t0 = time.perf_counter()
    stream = notary_stream(n_moves, window, seed=20261017, device=dev)
    stxs = [stx for w in stream.windows for stx in w]
    # the notary holds each request's serialized component rows (as
    # bench.py's stream does); the ids stay cold for every pass
    for stx in stxs:
        for g in ComponentGroupType:
            stx.tx.component_bytes(g)
    print(f"notary stream: {len(stxs)} requests ({n_moves} moves and "
          f"{len(stxs) - n_moves} adversarial) in {len(stream.windows)} windows of "
          f"{window}, built and signed on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        notary_pass(dev, stream, stream.windows[:2], sync=sync)  # warm-up
        kernels_ae = (ed25519_challenge, ed25519_verify_ladder, sha256_leaves,
                      sha256_merkle_sweep, ed25519_comb)
        # the first pass counts its id sweeps beside the kernels' launches
        sweeps = [0]
        roots_device = txid._tx_id_roots_device

        def counted_sweep(*args):
            sweeps[0] += 1
            return roots_device(*args)

        for k in kernels_ae:
            k.launches = 0
        txid._tx_id_roots_device = counted_sweep
        try:
            out, first_s = notary_pass(dev, stream, stream.windows, sync=sync)
        finally:
            txid._tx_id_roots_device = roots_device
        launches_n = {k.__name__: k.launches for k in kernels_ae}
        host_times = {"ids": [], "commit": [], "sign": []}
        steady, steady_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                       host_times=host_times)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_n:
            profiled_n, prof_n_s = notary_pass(dev, stream, stream.windows, sync=sync)
    finally:
        shutdown_scheduler()
    for k, res in enumerate((out, steady, profiled_n)):
        n_signed = check_notary_results(res, stream, dev, oracle=k == 0)
    if min(launches_n.values()) == 0:
        raise AssertionError(f"notary path launches {launches_n}: it missed a kernel")
    if launches_n["sha256_merkle_sweep"] != sweeps[0]:
        raise AssertionError(f"kernel D launched {launches_n['sha256_merkle_sweep']} times for "
                             f"{sweeps[0]} id sweeps: want one launch a sweep")
    print(f"notary path, first pass: kernel D launched {launches_n['sha256_merkle_sweep']} times "
          f"for {sweeps[0]} id sweeps")
    print(f"notary path: every request as expected ({n_signed} signed; "
          f"{len(stxs) - n_signed} rejected, one of each adversarial kind "
          f"{[name for name, _kind in ADVERSARIAL_KINDS]}), every signature verified "
          f"on the card and {ORACLE_SAMPLE} by the oracle; launches {launches_n}")
    print(f"notary, first pass: {n_signed} notarised in {first_s * 1e3:.1f} ms (host clock) = "
          f"{n_signed / first_s:.0f} tx/s  [{card}]")
    print(f"notary, steady pass: {n_signed} notarised in {steady_s * 1e3:.1f} ms = "
          f"{n_signed / steady_s:.0f} tx/s  [{card}]")
    busy_ms, device_us = device_busy(prof_n)
    print(f"notary, profiled pass: {prof_n_s * 1e3:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / (prof_n_s * 1e3):.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + f"  [{card}]")

    # the signing's host half for one full window: the nonces and the
    # enqueue, then (card idle) the responses S = r + h * a
    ids = [stx.id for stx in stream.windows[1]]
    meta = SignatureMetadata(CURRENT_PLATFORM_VERSION, EDDSA_ED25519_SHA512)
    payloads = [SignableData(i, meta).to_bytes() for i in ids]
    seed = stream.notary_keypair.private.encoded
    t0 = time.perf_counter()
    pending_sig = ed25519_sign_dispatch([seed] * len(ids), payloads, device=dev)
    sign_enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync()
    t0 = time.perf_counter()
    pending_sig.collect()
    sign_finish_ms = (time.perf_counter() - t0) * 1e3
    per_window = {k: 1e3 * sum(v) / len(v) for k, v in host_times.items()}
    print(f"notary host time per window of {window} (steady pass, host clock): "
          f"id sweep prep and enqueue {per_window['ids']:.2f} ms, commit "
          f"{per_window['commit']:.2f} ms, signing enqueue {per_window['sign']:.2f} ms; "
          f"signing's host half alone: nonces and enqueue {sign_enqueue_ms:.2f} ms + "
          f"responses {sign_finish_ms:.2f} ms  [{card}]")

    # the id sweep's host half for one window, stage by stage, beside the
    # host computing the same ids with hashlib (host clock)
    window_txs = [stx.tx for stx in stream.windows[1]]
    t0 = time.perf_counter()
    flat = txid._flatten(window_txs)
    t1 = time.perf_counter()
    leaf_msgs, levels, roots, rows = txid._plan(*flat)
    t2 = time.perf_counter()
    pack_messages(leaf_msgs)
    t3 = time.perf_counter()
    for wtx in window_txs:
        wtx.__dict__.pop("_id", None)
    t4 = time.perf_counter()
    for wtx in window_txs:
        wtx.id
    t5 = time.perf_counter()
    print(f"id sweep host half for one window of {window}: flatten "
          f"{(t1 - t0) * 1e3:.2f} ms, plan (nonce hashing, levels) {(t2 - t1) * 1e3:.2f} ms, "
          f"pack {(t3 - t2) * 1e3:.2f} ms; the same ids by hashlib on the host "
          f"{(t5 - t4) * 1e3:.2f} ms  [{card}]")

    # kernels C, D and E against their plain versions at the shapes one
    # window of the path gives them: C over the window's leaves, D over
    # every level of its sweep, E over a window of nonces
    n_leaves = len(leaf_msgs)
    (blocks, offs, cnts), leaf_words, err_c = hold_leaves(
        dev, leaf_msgs, f"the window's {n_leaves} leaves")
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    pool[:n_leaves] = leaf_words
    pool_plain = pool.clone()
    plan = txid.upload_levels(levels, dev)
    sha256_merkle_sweep(pool, plan)
    sha256_sweep_plain(pool_plain, plan)
    if not torch.equal(pool, pool_plain):
        raise AssertionError(f"kernel D != plain over the window's {len(levels)} levels")
    if digest_words_to_bytes(pool[roots].cpu().numpy()) != [wtx.id.bytes for wtx in window_txs]:
        raise AssertionError("the window's roots from kernels C and D != the host's ids")
    err_d = int((pool.long() - pool_plain.long()).abs().max())
    r_win = torch.from_numpy(np.frombuffer(b"".join(
        rng.randrange(ed25519_host.L).to_bytes(32, "little") for _ in range(window)),
        np.uint8).reshape(window, 32).copy()).to(dev)
    ctable = comb_table(dev)
    got_e = ed25519_comb(r_win, ctable)
    want_e = comb_plain(r_win, ctable)
    if not torch.equal(got_e, want_e):
        raise AssertionError(f"kernel E != plain at {window} lanes")
    r_host = r_win.cpu().numpy()
    enc = got_e.cpu().numpy()
    oracle_lanes = range(0, window, max(1, window // 128))
    for i in oracle_lanes:
        r = int.from_bytes(r_host[i].tobytes(), "little")
        if enc[i].tobytes() != ed25519_host.compress(ed25519_host.scalar_mul(r, ed25519_host.BASE)):
            raise AssertionError(f"kernel E != the oracle at lane {i} of {window}")
    err_e = int((got_e.int() - want_e.int()).abs().max())
    n_pairs = sum(len(lv[1]) for lv in levels)
    print(f"at one window's shapes: kernel C == plain == hashlib over {n_leaves} leaves "
          f"({int(cnts.sum())} blocks); kernel D == plain over {len(levels)} levels "
          f"({n_pairs} pairs: {[len(lv[1]) for lv in levels]}) in one launch, roots == host ids; "
          f"kernel E == plain over {window} lanes ({len(oracle_lanes)} of them == oracle)")
    # kernel C on 13-block leaves alone: as many as a window holds, and one
    # warp of them (its serial floor measured directly)
    long_leaves = {}
    for lanes in C_LONG_LANES:
        msgs = [rng.randbytes(C_LONG_BYTES) for _ in range(lanes)]
        long_leaves[lanes], _w, err = hold_leaves(dev, msgs, f"{lanes} leaves of 13 blocks")
        err_c = max(err_c, err)
    print(f"kernel C == plain == hashlib at {' and '.join(map(str, C_LONG_LANES))} leaves of "
          f"{C_LONG_BYTES} bytes (13 blocks each)")
    err_c = max(err_c, deep_cohort_check(dev, [stream.issue.tx] + window_txs[:3]))

    # times on the card (the stream held while the host queues the runs),
    # each beside the host's time a call
    n_blocks = int(cnts.sum())
    ms_c, host_c = device_times(lambda: sha256_leaves(blocks, offs, cnts), 50)
    plain_ms_c = plain_ms(lambda: sha256_leaves_plain(blocks, offs, cnts))
    ms_d, host_d = device_times(lambda: sha256_merkle_sweep(pool, plan), 50)
    plain_ms_d = plain_ms(lambda: sha256_sweep_plain(pool_plain, plan))
    ms_e, host_e = device_times(lambda: ed25519_comb(r_win, ctable), 20)
    plain_ms_e = plain_ms(lambda: comb_plain(r_win, ctable))
    bound_c = bound(n_blocks * 64 + len(leaf_msgs) * (8 + 32),
                    n_blocks * INT_OPS_PER_BLOCK, int_rate)
    bound_d = bound(n_pairs * (64 + 8 + 32), n_pairs * INT_OPS_PER_PAIR, int_rate)
    bound_e = bound(window * 64 + COMB_ROWS * 40,
                    window * COMB_INT_OPS_PER_LANE, int_rate)
    for name, shape, ms, host_ms, p_ms, (b_ms, b_by) in (
        ("sha256_leaves", f"{len(leaf_msgs)} leaves, {n_blocks} blocks", ms_c, host_c,
         plain_ms_c, bound_c),
        ("sha256_merkle_sweep", f"one window's sweep, {len(levels)} levels of {n_pairs} pairs",
         ms_d, host_d, plain_ms_d, bound_d),
        ("ed25519_comb", f"{window} lanes", ms_e, host_e, plain_ms_e, bound_e),
    ):
        print(f"{name}: {ms:.4f} ms on the card at {shape}, host {host_ms:.4f} ms a call "
              f"(plain {p_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)"
              f"  [{card}]")
    # kernel C's serial floor: the longest message's rounds on the consumer
    # warp (the producer's schedule on another scheduler), against the card
    # at the window, at a window's count of 13-block leaves and at one warp
    mhz = card_rates()[1]
    for label, (bl, of, cn) in [(f"the window's {n_leaves} leaves", (blocks, offs, cnts))] + [
            (f"{lanes} leaves of 13 blocks", long_leaves[lanes]) for lanes in C_LONG_LANES]:
        longest = int(cn.max())
        ms, host_ms = device_times(lambda: sha256_leaves(bl, of, cn), 50)
        floor = serial_floor_ms(longest * INT_OPS_ROUNDS_PER_BLOCK, mhz)
        one_thread = serial_floor_ms(longest * INT_OPS_PER_BLOCK, mhz)
        b_ms, b_by = bound(int(cn.sum()) * 64 + cn.numel() * (8 + 32),
                           int(cn.sum()) * INT_OPS_PER_BLOCK, int_rate)
        print(f"sha256_leaves at {label}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call; serial floor {floor:.4f} ms ({longest} blocks x {INT_OPS_ROUNDS_PER_BLOCK} "
              f"operations on the consumer warp at {mhz:g} MHz; one thread a message: "
              f"{one_thread:.4f}), {floor / ms:.1%} of it; bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms:.1%} of it  [{card}]")
    # kernel E's inversion alone in E's launch shape, and E's and D's
    # compiler report
    if dev.type == "cuda":
        lib = _build.kernels()
        words = torch.empty((4 * window,), dtype=torch.int32, device=dev)
        chain = cuda_ms(lambda: _build.check_launch(lib.ct_comb_chain_probe(
            r_win.data_ptr(), words.data_ptr(), window, _build.stream_of(r_win)),
            "comb_chain_probe"), 20)
        print(f"kernel E's inversion alone (E's launch shape): {chain:.4f} ms at {window} "
              f"lanes = {chain / ms_e:.1%} of E  [{card}]")
    print_ptxas("kernels C, D, E", ("sha256_leaves", "sha256_merkle_sweep", "ed25519_comb"))

    return {
        "launches": launches_n,
        "sha256_leaves": (ms_c, plain_ms_c, bound_c, err_c),
        "sha256_merkle_sweep": (ms_d, plain_ms_d, bound_d, err_d),
        "ed25519_comb": (ms_e, plain_ms_e, bound_e, err_e),
    }


def deep_cohort_check(dev, wtxs) -> int:
    """Kernels C and D on a cohort whose first transaction has a group of
    thousands of components (the stream's issue: a group tree far deeper
    than the top tree): C over its leaves against its plain version and
    hashlib, D's sweep in one launch against its plain version, and
    ``compute_tx_ids`` on the card against the host's ids. Returns C's
    largest difference from its plain version (0)."""
    import torch

    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.ops.sha256 import (
        digest_words_to_bytes,
        sha256_merkle_sweep,
        sha256_sweep_plain,
    )

    flat = txid._flatten(wtxs)
    leaf_msgs, levels, roots, rows = txid._plan(*flat)
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    _up, leaf_words, err_c = hold_leaves(dev, leaf_msgs, "the deep cohort's leaves")
    pool[: len(leaf_msgs)] = leaf_words
    pool_plain = pool.clone()
    plan = txid.upload_levels(levels, dev)
    sha256_merkle_sweep(pool, plan)
    sha256_sweep_plain(pool_plain, plan)
    want = [wtx.id.bytes for wtx in wtxs]  # the host's hashlib ids
    if not torch.equal(pool, pool_plain):
        raise AssertionError("kernel D != plain on the deep cohort")
    if digest_words_to_bytes(pool[roots].cpu().numpy()) != want or \
            [i.bytes for i in txid.compute_tx_ids(wtxs, device=dev)] != want:
        raise AssertionError("the deep cohort's ids on the card != the host's")
    widest = max(hi - lo for lo, hi in flat[2][0])
    print(f"deep cohort: kernel C == plain == hashlib over its {len(leaf_msgs)} leaves, kernel "
          f"D == plain over {len(levels)} levels in one launch (the first transaction's "
          f"largest group {widest} components), compute_tx_ids on the card == host ids for "
          f"{len(wtxs)} transactions")
    return err_c


def check_ecdsa_kernel(dev, curve, card, int_rate, n=ECDSA_LANES,
                       sizes=(512, ECDSA_SHARE, 8192)):
    """Phase 9 for one curve: kernel F against its plain version on the
    card and the oracle, then its times at ``sizes`` (the last is the full
    bucket, the middle one a curve's share of it). Returns (ms, plain ms,
    bound, largest difference) at the full bucket."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ecdsa_host
    from corda_tpu_torch.ops.secp256 import _prep_byte_planes, pack_planes
    from corda_tpu_torch.ops.secp256_ladder import (
        ECDSA_ROW,
        VERIFY,
        ecdsa_table,
        int_ops_per_verify,
        verify_plain,
    )
    from corda_tpu_torch.testing import ecdsa_adversarial_lanes, mixed_rows

    t0 = time.perf_counter()
    lanes = ecdsa_adversarial_lanes(curve, seed=9)
    kinds = [k for k, *_ in lanes]
    pool = [(pk, sig, msg) for _k, pk, sig, msg in lanes]
    pool += [(k.encoded, s, m) for k, s, m in
             mixed_rows(((curve, n - len(pool)),), seed=9, device="cpu")]
    cv = ecdsa_host.CURVES[curve]
    sample = list(range(len(lanes))) + list(range(len(lanes), n, max(1, n // (512 - len(lanes)))))
    sample = sample[:512]
    oracle = {i: ecdsa_host.verify(cv, *pool[i]) for i in sample}
    print(f"{curve}: signed {n - len(lanes)} rows and checked {len(sample)} with the "
          f"oracle in {time.perf_counter() - t0:.1f} s ({len(kinds)} kinds: {', '.join(kinds)})")

    def packed_for(triples, b):
        pks, sigs, msgs = map(list, zip(*triples))
        host = np.zeros((b, ECDSA_ROW), np.uint8)
        pack_planes(host, _prep_byte_planes(curve, pks, sigs, msgs, b))
        return torch.from_numpy(host).to(dev)

    verify = VERIFY[curve]
    table = ecdsa_table(curve, dev)
    packed = packed_for(pool, n)
    got = verify(packed, table)
    want = verify_plain(curve, packed, table)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).flatten().tolist()
        raise AssertionError(f"{verify.__name__} != plain at lanes {bad[:20]}")
    host = got.cpu().numpy()
    bad = [i for i in sample if bool(host[i]) != oracle[i]]
    if bad:
        raise AssertionError(f"{verify.__name__} != the oracle at lanes {bad[:20]}")
    err = int((got.int() - want.int()).abs().max())
    accepted = dict(zip(kinds, host[: len(kinds)].tolist()))
    print(f"{verify.__name__} == plain: {n} lanes ({int(got.sum())} accepted), == oracle on "
          f"{len(sample)}; the kinds accepted: {[k for k, v in accepted.items() if v]}")

    # times: lanes of valid rows (tiled), then the main path's shape, a
    # curve's share of an 8,192-row batch padded to 8,192 lanes
    valid = [t for i, t in enumerate(pool) if host[i]]
    ops = int_ops_per_verify(curve)
    table_bytes = table.numel() * 4
    share, full = sizes[1], sizes[-1]
    times = {}
    for b in sizes:
        pk_b = packed_for([valid[i % len(valid)] for i in range(b)], b)
        times[b] = cuda_ms(lambda: verify(pk_b, table), 10 if b < full else 5)
    path = packed_for([valid[i % len(valid)] for i in range(share)], full)
    got_path = verify(path, table)
    want_path = verify_plain(curve, path, table)
    torch.cuda.synchronize()
    if not torch.equal(got_path, want_path) or int(got_path.sum()) != share:
        raise AssertionError(f"{verify.__name__} != plain at the path's shape")
    err = max(err, int((got_path.int() - want_path.int()).abs().max()))
    # the path's shape again with every adversarial kind among its rows
    adv_path = packed_for([pool[i % n] for i in range(share)], full)
    got_adv = verify(adv_path, table)
    want_adv = verify_plain(curve, adv_path, table)
    torch.cuda.synchronize()
    host_adv = got_adv.cpu().numpy()
    if not torch.equal(got_adv, want_adv) or any(
            bool(host_adv[i]) != oracle[i] for i in sample if i < share) or \
            host_adv[share:].any():
        raise AssertionError(f"{verify.__name__} != plain or the oracle at the path's shape "
                             "with the adversarial kinds")
    print(f"{verify.__name__} == plain at the path's shape with every adversarial kind "
          f"({int(got_adv.sum())} of {share} accepted), == oracle on "
          f"{sum(i < share for i in sample)}")
    path_ms = cuda_ms(lambda: verify(path, table), 10)
    big = packed_for([valid[i % len(valid)] for i in range(full)], full)
    plain_t = plain_ms(lambda: verify_plain(curve, big, table))
    for b, ms in times.items():
        b_ms, b_by = bound(b * (ECDSA_ROW + 1) + table_bytes, b * ops, int_rate)
        print(f"{verify.__name__}: {ms:.4f} ms at B={b} ({b / ms * 1e3:.0f} sigs/s; bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)  [{card}]")
    p_ms, p_by = bound(full * (ECDSA_ROW + 1) + table_bytes, share * ops, int_rate)
    print(f"{verify.__name__}: {path_ms:.4f} ms at the path's shape ({share} signatures "
          f"padded to {full} lanes; bound {p_ms:.4f} ms by {p_by}); plain {plain_t:.1f} ms at "
          f"B={full}; {ops} integer operations a lane  [{card}]")
    return (times[full], plain_t,
            bound(full * (ECDSA_ROW + 1) + table_bytes, full * ops, int_rate), err)


def mixed_phase(dev, card, sizes=MIXED_SIZES, tile=MIXED_TILE, composition=None,
                full=8192):
    """Phase 10: the mixed backlog through the scheduler, its checks and
    numbers. Returns the launch counts of the first pass."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.crypto import PublicKey, is_valid
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.secp256 import _prep_byte_planes
    from corda_tpu_torch.ops.secp256_ladder import ecdsa_verify_k1, ecdsa_verify_r1
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, pad_floor, \
        pow2_at_least, sphincs_verify
    from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE, DeviceScheduler
    from corda_tpu_torch.testing import (
        MIXED_COMPOSITION,
        ecdsa_adversarial_lanes,
        mixed_rows,
        rsa_adversarial_lanes,
        sphincs_adversarial_lanes,
    )
    from corda_tpu_torch.verifier import dispatch_signature_rows

    composition = composition or MIXED_COMPOSITION
    t0 = time.perf_counter()
    timings = {}
    rows = mixed_rows(composition, keys_per_scheme=16, tile=tile, seed=10, device=dev,
                      timings=timings)
    adversarial = [(PublicKey(sid, pk), s, m) for sid, curve in ((2, "secp256k1"), (3, "secp256r1"))
                   for _k, pk, s, m in ecdsa_adversarial_lanes(curve, seed=10)]
    adversarial += [(PublicKey(5, pk), s, m) for _k, pk, s, m in sphincs_adversarial_lanes(10)]
    adversarial += [(PublicKey(1, pk), s, m) for _k, pk, s, m in rsa_adversarial_lanes(10)]
    positions = [(7 + 733 * k) % len(rows) for k in range(len(adversarial))]
    for pos, row in zip(positions, adversarial):
        rows[pos] = row
    distinct = {}
    for row in rows:
        if row not in distinct:
            distinct[row] = is_valid(*row)
    want = [distinct[row] for row in rows]
    n_rows = len(rows)
    n_host = sum(key.scheme_id == 1 for key, _s, _m in rows)
    assert sum(sizes) == n_rows, (sum(sizes), n_rows)
    print(f"mixed backlog: {n_rows} rows ({', '.join(f'{c} {name}' for name, c in composition)}"
          f" x {tile}, bench.py's whole MIXED_COMPOSITION), {len(adversarial)} adversarial "
          f"ECDSA, SPHINCS and RSA lanes at known positions, {n_host} RSA rows (host rows), "
          f"{len(distinct)} distinct rows checked by the oracle ({sum(distinct.values())} valid),"
          f" built in {time.perf_counter() - t0:.1f} s (by scheme: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items()) + ")")

    rows_by_req, requests, at = [], [], 0
    for k, size in enumerate(sizes):
        rows_by_req.append(rows[at : at + size])
        requests.append((rows[at : at + size], want[at : at + size],
                         (BULK, SERVICE, INTERACTIVE)[k % 3]))
        at += size
    classes = [cls for _r, _w, cls in requests]
    kernels = (ed25519_challenge, ed25519_verify_ladder, ecdsa_verify_k1, ecdsa_verify_r1,
               sphincs_verify)
    # the three-scheme cut, the same rows less the SPHINCS and RSA ones,
    # served twice by the same scheduler for a rate in the same call
    cut_requests = [([r for r in req if r[0].scheme_id in (2, 3, 4)], cls)
                    for req, cls in zip(rows_by_req, classes)]
    cut_requests = [(req, [distinct[r] for r in req], cls) for req, cls in cut_requests if req]
    cut = [req for req, _w, _c in cut_requests]
    n_cut = sum(map(len, cut))
    sched = DeviceScheduler(device=dev)
    try:
        sched.submit_rows(rows_by_req[-3]).result(timeout=300)  # warm-up
        before = dict(sched.counters)
        for k in kernels:
            k.launches = 0
        results, e2e_ms, wall_ms = serve_backlog(sched, rows_by_req, classes)
        launches = {k.__name__: k.launches for k in kernels}
        counters = {k: v - before[k] for k, v in sched.counters.items()}
        steady, steady_ms, _ = serve_backlog(sched, rows_by_req, classes)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled, _, prof_wall_ms = serve_backlog(sched, rows_by_req, classes)
        cut_passes = [serve_backlog(sched, cut, [c for _r, _w, c in cut_requests])
                      for _ in range(2)]
        steady2, steady2_ms, _ = serve_backlog(sched, rows_by_req, classes)
    finally:
        sched.shutdown()
    for res in (results, steady, profiled, steady2):
        check_backlog(res, requests, n_rows, n_rows - n_host)
    for res, _ms, _wall in cut_passes:
        check_backlog(res, cut_requests, n_cut)
    if min(launches.values()) == 0:
        raise AssertionError(f"mixed path launches {launches}: it missed a kernel")
    batches = sorted({rr.batch_seq for rr in results.values()})
    dev_rows, lanes = counters["serving.device_rows"], counters["serving.padded_lanes"]
    if dev_rows != n_rows - n_host:
        raise AssertionError(f"mixed path sent {dev_rows} of {n_rows} rows to the device, "
                             f"expected all but the {n_host} RSA rows")
    print(f"mixed path: {len(requests)} requests, {n_rows} signatures, {len(batches)} device "
          f"batches, every verdict == oracle, device_rows == {dev_rows} (all but the {n_host} "
          f"RSA rows); launches {launches}; padded lanes {lanes} for {dev_rows} rows "
          f"({1 - dev_rows / lanes:.1%} padding); counters {counters}")
    print(f"mixed e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host clock "
          f"{wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"mixed e2e, steady passes: {n_rows} sigs in {steady_ms:.1f} and {steady2_ms:.1f} ms "
          f"(CUDA events) = {n_rows / steady_ms * 1e3:.0f} and "
          f"{n_rows / steady2_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"mixed e2e, the three-scheme cut (the same rows less SPHINCS and RSA, {n_cut} "
          f"sigs), two passes in the same scheduler after the full ones, every verdict == "
          f"oracle: " + " and ".join(f"{n_cut / ms * 1e3:.0f}" for _r, ms, _w in cut_passes)
          + f" sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"mixed, profiled pass: {prof_wall_ms:.1f} ms host clock, device busy {busy_ms:.1f} ms"
          f" = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + "; kernel H: " + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                                       for k, v in device_us.items() if "sphincs" in k)
          + f"  [{card}]")

    # the host's share of one 8,192-row mixed batch on the dispatching
    # thread (host clock): prep and enqueue of its buckets, the ECDSA prep,
    # the SPHINCS prep and the RSA bucket (settled on the host)
    batch = rows[:full]
    by_curve = {c: [r for r in batch if r[0].scheme_id == sid]
                for sid, c in ((2, "secp256k1"), (3, "secp256r1"))}
    sph = [r for r in batch if r[0].scheme_id == 5]
    rsa_rows = [r for r in batch if r[0].scheme_id == 1]
    b_sph = pow2_at_least(max(len(sph), 1), pad_floor(full))
    prep_ms, ecdsa_ms, sph_ms, rsa_ms = [], [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = dispatch_signature_rows(batch, min_bucket=full, device=dev)
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        pending.collect()
        t0 = time.perf_counter()
        for curve, crow in by_curve.items():
            _prep_byte_planes(curve, [k.encoded for k, _s, _m in crow],
                              [s for _k, s, _m in crow], [m for _k, _s, m in crow], full)
        ecdsa_ms.append((time.perf_counter() - t0) * 1e3)
        plane = np.zeros(b_sph * ROW_BYTES, np.uint8)
        t0 = time.perf_counter()
        pack_plane(plane, [k.encoded for k, _s, _m in sph], [s for _k, s, _m in sph],
                   [m for _k, _s, m in sph])
        sph_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for row in rsa_rows:
            is_valid(*row)
        rsa_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"one {full}-row mixed batch ({', '.join(f'{len(v)} {c}' for c, v in by_curve.items())},"
          f" {len(sph)} SPHINCS in a {b_sph}-lane bucket, {len(rsa_rows)} RSA): host prep + "
          f"enqueue {sorted(prep_ms)[2]:.2f} ms (median of 5), of which the two ECDSA buckets' "
          f"_prep_byte_planes {sorted(ecdsa_ms)[2]:.2f} ms, the SPHINCS prep (pack_plane) "
          f"{sorted(sph_ms)[2]:.2f} ms, the RSA bucket (host verify) {sorted(rsa_ms)[2]:.2f} ms"
          f"  [{card}]")
    return launches


def check_sphincs_kernel(dev, card, int_rate, mhz, sizes=H_SIZES):
    """Phase 16: kernel H against its plain version and the host engine,
    its times beside its bound, serial floor, plain version and the host
    route, and ptxas' report. Returns {lanes: (ms, plain ms, bound,
    largest difference)}."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign, sphincs
    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops.sha256 import INT_OPS_PER_BLOCK
    from corda_tpu_torch.ops.sphincs_batch import (
        ROW_BYTES,
        pack_plane,
        split_plane,
        sphincs_stages_plain,
        sphincs_verify,
        sphincs_verify_plain,
    )
    from corda_tpu_torch.testing import sphincs_adversarial_lanes

    print_ptxas("kernel H", ("sphincs_verify",))
    print(f"kernel H: {_build.kernels().ct_sphincs_smem_bytes()} bytes of static shared memory "
          "a block (one lane, 96 threads: the warp pair and the hoister)")
    t0 = time.perf_counter()
    lanes = sphincs_adversarial_lanes(16)
    kinds = [k for k, *_ in lanes]
    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))
    pool = [t[1:] for t in lanes] + valid
    oracle = [sphincs.verify(*t) for t in pool]
    print(f"kernel H lanes: {len(kinds)} adversarial kinds ({', '.join(kinds)}) and "
          f"{len(valid)} more valid signatures, signed and checked by the host engine in "
          f"{time.perf_counter() - t0:.1f} s")

    def planes(triples, device=dev):
        plane = np.zeros(len(triples) * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*triples)))
        return split_plane(torch.from_numpy(plane).to(device))

    # each valid lane's work, from the digests its layers sign (the plain
    # version's stages, on the host): its blocks, the parent design's chain
    # of blocks and the redesigned chain's operations
    valid_planes = planes(valid, "cpu")
    stages = sphincs_stages_plain(*valid_planes[:3])
    signed_of = [[bytes(s[i].numpy()) for s in stages[:-1]] for i in range(len(valid))]
    work_of = [sphincs_lane_work(signed) + (sphincs_chain_ops(signed, int(idx)),)
               for signed, idx in zip(signed_of, valid_planes[2].tolist())]

    # each size once through the plain version, on the adversarial lanes:
    # it runs every step of every lane whatever the data, so the same run
    # holds kernel H and gives the plain version's time at that size
    err, plain_at = 0, {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for n in sizes:
        trip = [pool[i % len(pool)] for i in range(n)]
        views = planes(trip)
        got = sphincs_verify(*views)
        start.record()
        want = sphincs_verify_plain(*views)
        end.record()
        end.synchronize()
        plain_at[n] = start.elapsed_time(end)
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).flatten().tolist()
            raise AssertionError(f"kernel H != plain at {n} lanes, lanes {bad[:20]}")
        if got.cpu().tolist() != [oracle[i % len(pool)] for i in range(n)]:
            raise AssertionError(f"kernel H != the host engine at {n} lanes")
        err = max(err, int((got.int() - want.int()).abs().max()))
        print(f"kernel H == plain == sphincs.verify: {n} lanes ({int(got.sum())} accepted; "
              f"{min(n, len(kinds))} of the {len(kinds)} kinds among them)")

    out = {}
    for n in sizes:
        trip = [valid[i % len(valid)] for i in range(n)]
        views = planes(trip)
        ms, host_ms = device_times(lambda: sphincs_verify(*views), 20 if n < 1024 else 5)
        t0 = time.perf_counter()
        route = [sphincs.verify(*t) for t in trip]
        route_ms = (time.perf_counter() - t0) * 1e3
        assert all(route)
        work = [work_of[i % len(valid)] for i in range(n)]
        blocks = sum(w[0] for w in work)
        chain = max(w[1] for w in work)
        chain_ops = max(w[2] for w in work)
        b_ms, b_by = bound(n * (ROW_BYTES + 1), blocks * INT_OPS_PER_BLOCK, int_rate)
        floor_ms = serial_floor_ms(chain_ops, mhz)
        old_floor_ms = serial_floor_ms(chain * INT_OPS_PER_BLOCK, mhz)
        out[n] = (ms, plain_at[n], (b_ms, b_by), err)
        print(f"sphincs_verify: {ms:.4f} ms on the card at B={n} (host {host_ms:.4f} ms a "
              f"call; {n / ms * 1e3:.0f} sigs/s); bound {b_ms:.4f} ms by {b_by} ({blocks} "
              f"SHA-256 blocks, {b_ms / ms:.1%} of it); serial floor {floor_ms:.4f} ms (the "
              f"pair's chain of {chain_ops} operations, {floor_ms / ms:.1%} of it; the one-"
              f"thread design's floor {old_floor_ms:.4f} ms, a chain of {chain} blocks); plain "
              f"{plain_at[n]:.1f} ms (one run); the host route (sphincs.verify a lane) "
              f"{route_ms:.1f} ms  [{card}]")
    return out


def check_g_kernel(dev, card, int_rate, pool, oracle, sizes=G_SIZES, n=8192):
    """Phase 11: the verify ladders, kernel B and kernel G, each in both
    fixed-base shapes, against their plain versions on the card and the
    oracle over ``pool``, then their times in turns at ``sizes``, and each
    kernel held against its plain version and the oracle again at ``n``
    lanes (the main path's bucket) and at every shape of ``sizes`` (``pool``
    tiled). Returns {wrapper name: (ms, plain ms, bound, largest
    difference)} at ``n`` lanes."""
    import numpy as np
    import torch

    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops import ed25519_ladder as b
    from corda_tpu_torch.ops import ed25519_ladder4096 as g
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain

    entry = ""
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            entry = line
        if ("ed25519_verify_g" in entry or "ed25519_verify_ladder" in entry) and any(
                w in line for w in ("Compiling entry", "registers", "spill")):
            print("ptxas (kernels B, G):", line.strip())
    packed = torch.from_numpy(pack_triples(pool)).to(dev)
    win = challenge_windows_plain(packed)
    table_b, table_g = b.ladder_table(dev), g.ladder_table(dev)
    # name -> (wrapper, table, plain version, integer operations a lane)
    ladders = {}
    for mod, table, plain in ((b, table_b, b.verify_ladder_plain), (g, table_g, g.verify_plain_g)):
        verifiers = b.VERIFY_B if mod is b else g.VERIFY_G
        for fw, verify in verifiers.items():
            ladders[verify.__name__] = (verify, table, functools.partial(plain, fixed_win=fw),
                                        mod.int_ops_per_verify(fw))
    if dev.type == "cuda":
        lib = _build.kernels()
        print("dynamic shared memory a block (as each launch sets it): kernel B "
              f"{lib.ct_ed25519_verify_ladder_smem_bytes()} bytes, kernel G "
              f"{lib.ct_ed25519_verify_g_smem_bytes()} bytes")
    errs = {}
    for name, (verify, table, plain, _ops) in ladders.items():
        got = verify(packed, win, table)
        want = plain(packed, win, table)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).flatten().tolist()
            raise AssertionError(f"{name} != plain at lanes {bad[:20]}")
        if got.cpu().numpy().tolist() != oracle.tolist():
            raise AssertionError(f"{name} != the pure-Python oracle")
        errs[name] = int((got.int() - want.int()).abs().max())
        print(f"{name} == plain == oracle: {len(pool)} lanes, {int(got.sum())} accepted")

    # times in turns (each ladder, then the same in reverse) at each shape,
    # means of the pairs
    big = packed.repeat(n // len(pool), 1).contiguous()
    win_big = challenge_windows_plain(big)
    shapes = {}
    for lanes in sizes:
        reps = -(-lanes // n)
        shapes[lanes] = (big.repeat(reps, 1)[:lanes].contiguous(),
                         win_big.repeat(1, reps)[:, :lanes].contiguous())
    order = list(ladders) + list(ladders)[::-1]
    times = {}
    for lanes, (packed_l, win_l) in shapes.items():
        acc = {name: [] for name in ladders}
        for name in order:
            fn, table = ladders[name][:2]
            acc[name].append(cuda_ms(lambda: fn(packed_l, win_l, table), 5))
        times[lanes] = {name: sum(v) / len(v) for name, v in acc.items()}

    def bounds(name, lanes):
        table = ladders[name][1]
        return bound(lanes * (161 + 64 * 4 + 1) + table.numel() * 4,
                     lanes * ladders[name][3], int_rate)

    for lanes, by_name in times.items():
        print(f"ladders at B={lanes}: " + "; ".join(
            f"{name} {ms:.4f} ms (bound {bounds(name, lanes)[0]:.4f} ms by "
            f"{bounds(name, lanes)[1]}, {bounds(name, lanes)[0] / ms:.1%} of it)"
            for name, ms in by_name.items()) + f"  [{card}]")
    b_ms = times[n]["ed25519_verify_ladder"]
    if dev.type == "cuda":
        # the two exponent chains alone, whole on every thread of a quad as
        # the ladders run them (the csrc/fe_chain_probe.cu probe)
        lib = _build.kernels()
        words = torch.empty((4 * n,), dtype=torch.int32, device=dev)
        for field, names in ((10, ("ed25519_verify_ladder", "ed25519_verify_ladder_w4")),
                             (8, ("ed25519_verify_g8", "ed25519_verify_g4"))):
            chain = cuda_ms(lambda: _build.check_launch(lib.ct_fe_chain_probe(
                big.data_ptr(), words.data_ptr(), n, field, _build.stream_of(big)),
                "fe_chain_probe"), 10)
            print(f"exponent chains alone ({field}-word field, four threads a signature): "
                  f"{chain:.4f} ms at B={n} = " + ", ".join(
                      f"{chain / times[n][name]:.1%} of {name}" for name in names)
                  + f"  [{card}]")
    # each kernel against its plain version at n lanes (the plain result of
    # its timed run) and at every timed shape (that result tiled), and
    # against the oracle tiled
    oracle_n = torch.from_numpy(np.resize(np.asarray(oracle, dtype=bool), n)).to(dev)
    out = {}
    for name, (fn, table, plain, ops) in ladders.items():
        plain_out = []
        plain_t = plain_ms(lambda: plain_out.append(plain(big, win_big, table)))
        want_n = plain_out[-1]
        if not torch.equal(want_n.bool(), oracle_n):
            raise AssertionError(f"plain {name} != the pure-Python oracle at {n} lanes")
        for lanes, (packed_l, win_l) in shapes.items():
            got = fn(packed_l, win_l, table)
            want = want_n.repeat(-(-lanes // n))[:lanes]
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = torch.nonzero(got != want).flatten().tolist()
                raise AssertionError(f"{name} != plain at {lanes} lanes, lanes {bad[:20]}")
            errs[name] = max(errs[name], int((got.int() - want.int()).abs().max()))
        print(f"{name} == plain == oracle at " + ", ".join(f"{lanes}" for lanes in shapes)
              + " lanes")
        ms = times[n][name]
        print(f"{name}: {ms:.4f} ms at B={n}, {ms / b_ms:.3f}x kernel B (comb); plain "
              f"{plain_t:.1f} ms; {ops} integer operations a lane  [{card}]")
        out[name] = (ms, plain_t, bounds(name, n), errs[name])
    return out


def tier_backlog_phase(dev, card, rows_by_req, requests, classes, n_rows):
    """Phase 12: phase 4's backlog through a scheduler of the radix-4096
    tier (comb). Returns kernel G's launches in the first pass."""
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge

    tier = Ed25519Tier(4096, 8)
    kernels = (ed25519_challenge, ed25519_verify_ladder, ed25519_verify_ladder_w4,
               ed25519_verify_g8, ed25519_verify_g4)
    (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof,
     prof_wall_ms, took, _a_batches) = backlog_passes(dev, rows_by_req, requests, classes,
                                                      n_rows, kernels, tier=tier)
    if min(launches["ed25519_challenge"], launches["ed25519_verify_g8"]) == 0 or \
            launches["ed25519_verify_ladder"] or launches["ed25519_verify_ladder_w4"] or \
            launches["ed25519_verify_g4"]:
        raise AssertionError(f"{tier} backlog launches {launches}: want A and G8 only")
    print(f"{tier} backlog: {len(requests)} requests, {n_rows} signatures, {len(batches)} "
          f"device batches, every verdict == oracle where the two rules agree (of the rows "
          f"where they differ, {took[0]} took the cofactored verdict of a full bucket, "
          f"{took[1]} the cofactorless one), device_rows == {n_rows}; launches {launches}; "
          f"counters {counters}")
    print(f"{tier} e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host "
          f"clock {wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"{tier} e2e, steady pass: {n_rows} sigs in {steady_ms:.1f} ms (CUDA events) = "
          f"{n_rows / steady_ms * 1e3:.0f} sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"{tier} profiled pass: {prof_wall_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
          + f"  [{card}]")
    return launches["ed25519_verify_g8"]


def answer_of(result):
    """A notary answer as comparable data: signature bytes, or the error."""
    if type(result).__name__ == "TransactionSignature":
        return ("signed", result.signature, result.by.encoded)
    return (type(result).__name__, str(result))


def validating_phase(dev, card, n_moves=NOTARY_TXS, window=NOTARY_WINDOW):
    """Phase 13: the validating notary over the stream with its
    contract-invalid kinds, on each tier: checks, then tx/s and the host
    time of the validation stage. Returns the launch counts of each tier's
    first pass."""
    import torch

    from corda_tpu_torch.ledger import ComponentGroupType
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import CONTRACT_INVALID_KINDS, notary_stream

    t0 = time.perf_counter()
    stream = notary_stream(n_moves, window, seed=20261018, contract_invalid=True, device=dev)
    # the notary holds each request's serialized component rows, as in
    # phase 8; the ids stay cold for every pass
    for w in stream.windows:
        for stx in w:
            for g in ComponentGroupType:
                stx.tx.component_bytes(g)
    n_req = sum(len(w) for w in stream.windows)
    print(f"validating stream: {n_req} requests ({n_moves} moves, {n_req - n_moves} "
          f"adversarial, {len(CONTRACT_INVALID_KINDS)} of them contract-invalid) in "
          f"{len(stream.windows)} windows of {window}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    common = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ed25519_comb)
    ladders = {Ed25519Tier(): ed25519_verify_ladder,
               Ed25519Tier(8192, 4): ed25519_verify_ladder_w4,
               Ed25519Tier(4096, 8): ed25519_verify_g8, Ed25519Tier(4096, 4): ed25519_verify_g4}
    sync = torch.cuda.synchronize
    answers, launches_by_tier = {}, {}
    for tier, ladder in ladders.items():
        try:
            notary_pass(dev, stream, stream.windows[:2], sync=sync, validating=True,
                        tier=tier)  # warm-up
            kernels = common + tuple(ladders.values())
            for k in kernels:
                k.launches = 0
            out, first_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                       validating=True, tier=tier)
            launches = {k.__name__: k.launches for k in kernels}
            host_times = {"ids": [], "commit": [], "sign": [], "validate": []}
            steady, steady_s = notary_pass(dev, stream, stream.windows, sync=sync,
                                           host_times=host_times, validating=True, tier=tier)
        finally:
            shutdown_scheduler()
        for k, res in enumerate((out, steady)):
            n_signed = check_notary_results(res, stream, dev, oracle=k == 0)
        others = [lad.__name__ for lad in ladders.values() if lad is not ladder]
        if min(launches[k.__name__] for k in common + (ladder,)) == 0 or \
                any(launches[name] for name in others):
            raise AssertionError(f"validating notary on {tier}: launches {launches}")
        answers[tier] = [answer_of(r) for w in out for r in w]
        launches_by_tier[tier] = launches
        per_window = {k: 1e3 * sum(v) / len(v) for k, v in host_times.items()}
        print(f"validating notary on {tier}: every request as expected ({n_signed} signed, "
              f"{n_req - n_signed} rejected), every signature verified; launches {launches}")
        print(f"validating notary on {tier}: first pass {n_signed / first_s:.0f} tx/s "
              f"({first_s * 1e3:.1f} ms host clock), steady pass {n_signed / steady_s:.0f} tx/s "
              f"({steady_s * 1e3:.1f} ms); host ms per window of {window} (steady): validation "
              f"(to_ledger_transaction + verify_ledger_batch) {per_window['validate']:.2f}, id "
              f"sweep {per_window['ids']:.2f}, commit {per_window['commit']:.2f}, signing "
              f"{per_window['sign']:.2f}  [{card}]")
    first = next(iter(answers.values()))
    for tier, ans in answers.items():
        if ans != first:
            bad = [i for i, (a, b) in enumerate(zip(ans, first)) if a != b]
            raise AssertionError(f"{tier}'s answers differ from the default tier's at {bad[:10]}")
    print(f"validating notary: the {len(answers)} tiers' answers equal request for request, "
          f"signature bytes included ({len(first)} requests)")
    return launches_by_tier


def cofactored_phase(dev, card, pool, n=8192):
    """Phase 14: full ed25519 buckets under the cofactored rule of the
    reference's RLC route, on each of the four tiers. ``pool`` (phase 3's
    lanes) plus the 8 small-order encodings as A and as R and an R of small
    order that the cofactorless rule accepts, tiled to ``n`` rows: a full
    bucket through dispatch_signature_rows equals the port's
    ``verify_single`` row by row (the tier's ladder launched, its counter
    zeroed just before and read just after, the other ladders not), the
    ladder's cofactored launch equals its plain version (at ``n`` lanes,
    and that result cut to 1,024 and tiled to 4n), a partial bucket
    equals the cofactorless oracle; then each ladder's time in both modes,
    in turns. Returns the launches of each tier's full-bucket run."""
    import numpy as np
    import torch

    from corda_tpu_torch.batchverify import verify_rows
    from corda_tpu_torch.crypto import PublicKey, ed25519_host
    from corda_tpu_torch.ops import ed25519_ladder as b
    from corda_tpu_torch.ops import ed25519_ladder4096 as g
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.scalar25519 import challenge_windows_plain
    from corda_tpu_torch.testing import cofactored_lanes
    from corda_tpu_torch.verifier import dispatch_signature_rows

    t0 = time.perf_counter()
    extra = cofactored_lanes(14)
    distinct = [(pk, s, m) for _k, pk, s, m in extra] + list(pool)
    cof = verify_rows(distinct)
    plain = [ed25519_host.verify(*t) for t in distinct]
    differ = sum(c != p for c, p in zip(cof, plain))
    rows = [distinct[i % len(distinct)] for i in range(n)]
    want_cof = [cof[i % len(distinct)] for i in range(n)]
    want_plain = [plain[i % len(distinct)] for i in range(n)]
    key_rows = [(PublicKey(4, pk), s, m) for pk, s, m in rows]
    print(f"cofactored bucket: {n} rows ({len(distinct)} distinct: phase 3's lanes and "
          f"{len(extra)} small-order kinds; the two rules differ on {differ} distinct rows), "
          f"oracles in {time.perf_counter() - t0:.1f} s")
    tiers = {Ed25519Tier(): (b.ed25519_verify_ladder, b.verify_ladder_plain, b),
             Ed25519Tier(8192, 4): (b.ed25519_verify_ladder_w4, b.verify_ladder_plain, b),
             Ed25519Tier(4096, 8): (g.ed25519_verify_g8, g.verify_plain_g, g),
             Ed25519Tier(4096, 4): (g.ed25519_verify_g4, g.verify_plain_g, g)}
    ladders = [v[0] for v in tiers.values()]
    packed = torch.from_numpy(pack_triples(rows, cofactored=True)).to(dev)
    win = challenge_windows_plain(packed)
    out = {}
    for tier, (ladder, plain_fn, mod) in tiers.items():
        for lad in ladders:
            lad.launches = 0
        torch.cuda.synchronize()
        got = dispatch_signature_rows(key_rows, min_bucket=n, device=dev, tier=tier).collect()
        launches = {lad.__name__: lad.launches for lad in ladders}
        if got.tolist() != want_cof:
            bad = [i for i, (x, y) in enumerate(zip(got.tolist(), want_cof)) if x != y]
            raise AssertionError(f"{tier}: full bucket != verify_single at rows {bad[:20]}")
        if launches[ladder.__name__] == 0 or any(
                v for k, v in launches.items() if k != ladder.__name__):
            raise AssertionError(f"{tier}: full-bucket launches {launches}")
        partial = dispatch_signature_rows(key_rows, min_bucket=n + 1, device=dev,
                                          tier=tier).collect()
        if partial.tolist() != want_plain:
            raise AssertionError(f"{tier}: partial bucket != the cofactorless oracle")
        table = mod.ladder_table(dev)
        got_k = ladder(packed, win, table, True)
        want_k = plain_fn(packed, win, table, tier.fixed_win, True)
        torch.cuda.synchronize()
        if not torch.equal(got_k, want_k) or got_k.cpu().tolist() != want_cof:
            raise AssertionError(f"{ladder.__name__} cofactored != plain or verify_single")
        # the same rows cut to 1,024 lanes and tiled to 32,768
        for lanes in (1024, 4 * n):
            reps = -(-lanes // n)
            got_l = ladder(packed.repeat(reps, 1)[:lanes].contiguous(),
                           win.repeat(1, reps)[:, :lanes].contiguous(), table, True)
            torch.cuda.synchronize()
            if not torch.equal(got_l, want_k.repeat(reps)[:lanes]):
                raise AssertionError(f"{ladder.__name__} cofactored != plain at {lanes} lanes")
        acc = {False: [], True: []}
        for mode in (False, True, True, False):
            acc[mode].append(cuda_ms(lambda: ladder(packed, win, table, mode), 5))
        ms = {mode: sum(v) / len(v) for mode, v in acc.items()}
        print(f"{tier}: full bucket == verify_single ({n} rows, {int(got.sum())} accepted), "
              f"partial == cofactorless oracle, {ladder.__name__} cofactored == plain at "
              f"1024, {n} and {4 * n} lanes; "
              f"launches {launches}; {ladder.__name__} at B={n}: cofactorless {ms[False]:.4f} "
              f"ms, cofactored {ms[True]:.4f} ms ({ms[True] / ms[False] - 1:+.1%})  [{card}]")
        out[tier] = launches[ladder.__name__]
    return out


def resolve_outcome(res) -> tuple:
    """A resolve's result as comparable data."""
    return (list(res.order), [list(lvl) for lvl in res.levels], res.n_sigs,
            sorted((ref.txhash.bytes, ref.index) for ref in res.consumed))


def cold_ids(stxs) -> None:
    for stx in stxs:
        object.__getattribute__(stx.tx, "__dict__").pop("_id", None)


def check_primed_ids(stxs) -> None:
    """Every primed id equals the id hashlib gives the same bytes on the
    host (a fresh copy of the wire transaction)."""
    from corda_tpu_torch.serialization import deserialize

    for stx in stxs:
        primed = object.__getattribute__(stx.tx, "__dict__").get("_id")
        if primed != deserialize(stx.tx_bits).id:
            raise AssertionError(f"primed id {primed} != the bytes' id of {stx}")


def resolve_pass(dev, dag, allowed, sync, **kw):
    """One resolve of ``dag`` on ``dev`` with every id cache cold: (result,
    host-clock seconds)."""
    from corda_tpu_torch.parallel import verify_transaction_dag

    cold_ids(dag.values())
    sync()
    t0 = time.perf_counter()
    res = verify_transaction_dag(dag, allowed_missing_fn=allowed, device=dev,
                                 window=RESOLVE_WINDOW, depth=RESOLVE_DEPTH, **kw)
    sync()
    return res, time.perf_counter() - t0


def resolve_launches(dev, dag, allowed, sync, want_host, tier=None):
    """The first resolve of ``dag`` on the card, with the kernels' launch
    counters and the scheduler's batch counter read around it: checked
    against the host route's result, its ids against hashlib, its launches
    (A, C, D and the tier's ladder risen; the other ladders and E at 0).
    Returns (launches, scheduler batches, seconds)."""
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.ops.ed25519_ladder import ed25519_verify_ladder, ed25519_verify_ladder_w4
    from corda_tpu_torch.ops.ed25519_ladder4096 import ed25519_verify_g4, ed25519_verify_g8
    from corda_tpu_torch.ops.ed25519_sign import ed25519_comb
    from corda_tpu_torch.ops.scalar25519 import ed25519_challenge
    from corda_tpu_torch.ops.sha256 import sha256_leaves, sha256_merkle_sweep
    from corda_tpu_torch.serving import device_scheduler

    tier = tier or Ed25519Tier()
    ladders = {Ed25519Tier(): ed25519_verify_ladder,
               Ed25519Tier(8192, 4): ed25519_verify_ladder_w4,
               Ed25519Tier(4096, 8): ed25519_verify_g8, Ed25519Tier(4096, 4): ed25519_verify_g4}
    kernels = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ed25519_comb,
               *ladders.values())
    sched = device_scheduler(dev, tier)
    batches0 = sched.counters["serving.batches"]
    for k in kernels:
        k.launches = 0
    res, secs = resolve_pass(dev, dag, allowed, sync, tier=tier)
    launches = {k.__name__: k.launches for k in kernels}
    batches = sched.counters["serving.batches"] - batches0
    if resolve_outcome(res) != want_host:
        raise AssertionError(f"the resolve on {tier} differs from the host route's")
    check_primed_ids(dag.values())
    must = (ed25519_challenge, sha256_leaves, sha256_merkle_sweep, ladders[tier])
    if min(launches[k.__name__] for k in must) == 0 or any(
            launches[k.__name__] for k in kernels if k not in must):
        raise AssertionError(f"resolve on {tier}: launches {launches}")
    if batches == 0:
        raise AssertionError("the resolve did not ride the shared scheduler")
    return launches, batches, secs


def resolve_stage_times(dev, dag, allowed, sync) -> dict:
    """Host seconds by stage over one resolve (a pass of its own, outside
    the timed ones): each stage's function, on its module or class,
    wrapped with a timer for that pass, and put back."""
    from corda_tpu_torch.ledger import WireTransaction
    from corda_tpu_torch.ops.txid import PendingIdCheck
    from corda_tpu_torch.parallel import wavefront
    from corda_tpu_torch.serving import DeviceScheduler, FuturePending

    stages = {"sort": (wavefront, "topological_levels"),
              "ids": (wavefront, "dispatch_check_ids"),
              "submit": (DeviceScheduler, "submit_transactions"),
              "ids_collect": (PendingIdCheck, "collect"),
              "verdicts": (FuturePending, "collect"),
              "walk": (wavefront, "_walk_levels"),
              "ltx": (WireTransaction, "to_ledger_transaction"),
              "contracts": (wavefront, "verify_ledger_batch")}
    acc = {k: [] for k in stages}
    originals = {k: getattr(owner, name) for k, (owner, name) in stages.items()}
    try:
        for k, (owner, name) in stages.items():
            setattr(owner, name, timed(originals[k], acc[k]))
        _res, secs = resolve_pass(dev, dag, allowed, sync)
    finally:
        for k, (owner, name) in stages.items():
            setattr(owner, name, originals[k])
    total = {k: sum(v) for k, v in acc.items()}
    total["walk"] -= total["ltx"]  # the consumed set, resolution, outputs
    total["ltx"] += total.pop("contracts")
    total["pass"] = secs
    return total


def paper_chain():
    """A CommercialPaper issue, a move and its redemption against Cash, with
    the Cash issue that pays it: (signed transactions, notary)."""
    from corda_tpu_torch.finance import (
        CASH_PROGRAM_ID,
        CP_PROGRAM_ID,
        CashState,
        CommercialPaperState,
        Issue,
        Move,
        Redeem,
    )
    from corda_tpu_torch.ledger import (
        Amount,
        Issued,
        PartyAndReference,
        PrivacySalt,
        TimeWindow,
        TransactionBuilder,
    )
    from corda_tpu_torch.testing import _party

    alice, akp = _party(b"Paper Issuer")
    bob, bkp = _party(b"Paper Holder")
    notary, _nkp = _party(b"Paper Notary")
    token = Issued(PartyAndReference(alice, b"\x01"), "GBP")
    maturity = 1_800_000_000.0
    rng = random.Random(15)

    def builder(tw=None):
        b = TransactionBuilder(notary=notary)
        b.set_privacy_salt(PrivacySalt(rng.randbytes(32)))
        if tw is not None:
            b.set_time_window(tw)
        return b

    b = builder()
    b.add_output_state(CashState(Amount(1000, token), alice), CASH_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    cash = b.sign_initial_transaction(akp)
    b = builder(TimeWindow(until_time=int((maturity - 86400) * 1e6)))
    b.add_output_state(CommercialPaperState(token.issuer, alice, Amount(1000, token), maturity),
                       CP_PROGRAM_ID)
    b.add_command(Issue(), alice.owning_key)
    issue = b.sign_initial_transaction(akp)
    b = builder()
    b.add_input_state(issue.tx.out_ref(0))
    b.add_output_state(issue.tx.outputs[0].data.with_new_owner(bob), CP_PROGRAM_ID)
    b.add_command(Move(), alice.owning_key)
    move = b.sign_initial_transaction(akp)
    b = builder(TimeWindow(from_time=int((maturity + 60) * 1e6)))
    b.add_input_state(move.tx.out_ref(0))
    b.add_input_state(cash.tx.out_ref(0))
    b.add_output_state(CashState(Amount(1000, token), bob), CASH_PROGRAM_ID)
    b.add_command(Redeem(), bob.owning_key)
    b.add_command(Move(), alice.owning_key)
    redeem = b.sign_initial_transaction(bkp, akp)
    return [cash, issue, move, redeem], notary


def resolve_failures(dev, chain, notary, sync) -> None:
    """Phase 15c: each failure kind raises on the card through the shared
    scheduler."""
    import dataclasses

    from corda_tpu_torch.crypto import SecureHash
    from corda_tpu_torch.finance import CASH_PROGRAM_ID, CashState, Move
    from corda_tpu_torch.ledger import (
        Amount,
        SignedTransaction,
        StateAndRef,
        StateRef,
        TransactionBuilder,
        TransactionVerificationException,
    )
    from corda_tpu_torch.parallel import (
        DoubleSpendInDagError,
        UnresolvedStateError,
        verify_transaction_dag,
        wavefront,
    )
    from corda_tpu_torch.serialization import deserialize
    from corda_tpu_torch.testing import _party
    from corda_tpu_torch.verifier import InvalidSignatureError

    owner, okp = _party(b"Chain Owner")
    allowed = lambda s: {notary.owning_key}  # noqa: E731
    dag = {stx.id: stx for stx in chain}
    token = chain[0].tx.outputs[0].data.amount.token

    def move(spend, amount=1000, to=owner):
        b = TransactionBuilder(notary=notary)
        b.add_input_state(spend)
        b.add_output_state(CashState(Amount(amount, token), to), CASH_PROGRAM_ID)
        b.add_command(Move(), owner.owning_key)
        return b

    def expect(name, err_cls, bad_dag, match=None):
        cold_ids(bad_dag.values())
        try:
            verify_transaction_dag(bad_dag, allowed_missing_fn=allowed, device=dev,
                                   window=RESOLVE_WINDOW, depth=RESOLVE_DEPTH)
        except err_cls as e:
            if match is not None and match not in str(e):
                raise AssertionError(f"{name}: {e}") from e
            print(f"resolve failure on the card, {name}: {type(e).__name__}")
            return
        raise AssertionError(f"{name}: the resolve did not raise {err_cls.__name__}")

    # a forged chain link in window 2: another move of the same input,
    # carrying the original's signature, keyed under the original's id
    at = 2 * RESOLVE_WINDOW + RESOLVE_WINDOW // 2
    orig = chain[at]
    forged_wtx = move(chain[at - 1].tx.out_ref(0), to=notary).to_wire_transaction()
    forged = dict(dag)
    forged[orig.id] = SignedTransaction.create(forged_wtx, list(orig.sigs))
    walks = []
    walk = wavefront._walk_levels
    wavefront._walk_levels = lambda wl, *a: walks.append(len(wl)) or walk(wl, *a)
    try:
        expect("forged chain link", TransactionVerificationException, forged,
               "transaction id mismatch")
    finally:
        wavefront._walk_levels = walk
    if len(walks) != 2:
        raise AssertionError(f"the forged link raised after {len(walks)} windows, not at window 2")
    for stx in forged.values():
        cached = object.__getattribute__(stx.tx, "__dict__").get("_id")
        if cached is not None and cached != deserialize(stx.tx_bits).id:
            raise AssertionError(f"a claimed id stayed cached on {stx}")
    print("resolve failure on the card, forged chain link: raised at window 2, no claimed id "
          "left cached")

    k = len(chain) // 3
    sig = chain[k].sigs[0]
    tampered = dict(dag)
    tampered[chain[k].id] = dataclasses.replace(chain[k], sigs=(dataclasses.replace(
        sig, signature=sig.signature[:9] + bytes([sig.signature[9] ^ 1]) + sig.signature[10:]),))
    expect("tampered signature", InvalidSignatureError, tampered)

    spend = move(chain[len(chain) // 2].tx.out_ref(0)).sign_initial_transaction(okp)
    expect("double spend", DoubleSpendInDagError, {**dag, spend.id: spend})

    ghost = StateAndRef(chain[0].tx.outputs[0], StateRef(SecureHash(bytes(range(32))), 0))
    orphan = move(ghost).sign_initial_transaction(okp)
    expect("orphan", UnresolvedStateError, {**dag, orphan.id: orphan})

    leak = move(chain[-1].tx.out_ref(0), amount=999).sign_initial_transaction(okp)
    expect("non-conserving Cash move", TransactionVerificationException, {**dag, leak.id: leak},
           "value not conserved")


def resolve_phase(dev, card, hops=RESOLVE_HOPS, n_gen=GEN_TXS, sync=None) -> None:
    """Phase 15: the back-chain resolve on the card (BASELINE config #4),
    a generated DAG on two tiers, each failure kind, and a CommercialPaper
    chain."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from corda_tpu_torch.ops.ed25519 import Ed25519Tier
    from corda_tpu_torch.serving import shutdown_scheduler
    from corda_tpu_torch.testing import GeneratedLedger, back_chain

    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    chain, notary = back_chain(hops, seed=20261019, device=dev)
    dag = {stx.id: stx for stx in chain}
    allowed = lambda s: {notary.owning_key}  # noqa: E731
    n_windows = -(-len(chain) // RESOLVE_WINDOW)
    print(f"back-chain: {len(chain)} transactions, {sum(len(s.sigs) for s in chain)} signatures,"
          f" built in {time.perf_counter() - t0:.1f} s (signed on the card)")
    try:
        # (a) BASELINE config #4 through the shared scheduler
        t0 = time.perf_counter()
        host = resolve_outcome(resolve_pass(dev, dag, allowed, sync, use_device=False)[0])
        host_s = time.perf_counter() - t0
        if len(host[1]) != len(chain) or any(len(lvl) != 1 for lvl in host[1]) or \
                host[2] != len(chain):
            raise AssertionError("the host route's levels or signatures are not the chain's")
        launches, batches, first_s = resolve_launches(dev, dag, allowed, sync, host)
        steady = []
        for _ in range(3):
            res, secs = resolve_pass(dev, dag, allowed, sync)
            if resolve_outcome(res) != host:
                raise AssertionError("a steady resolve differs from the host route's")
            steady.append(secs)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, prof_s = resolve_pass(dev, dag, allowed, sync)
        if resolve_outcome(res) != host:
            raise AssertionError("the profiled resolve differs from the host route's")
        stages = resolve_stage_times(dev, dag, allowed, sync)
        n = len(chain)
        rates = sorted(n / s for s in steady)
        print(f"resolve (BASELINE config #4): {n} transactions, {n} levels of one, {n} "
              f"signatures, {n_windows} windows of {RESOLVE_WINDOW} at depth {RESOLVE_DEPTH}, "
              f"ids cold every pass; == the host route ({host_s:.2f} s), every primed id == "
              f"hashlib's; launches {launches}; {batches} scheduler batches")
        print(f"resolve: first pass {n / first_s:.0f} tx/s ({first_s * 1e3:.1f} ms host clock), "
              f"steady median {statistics.median(rates):.0f} tx/s over 3 (min {rates[0]:.0f}, "
              f"max {rates[-1]:.0f}, spread {(rates[-1] - rates[0]) / statistics.median(rates):.1%})"
              f"  [{card}]")
        busy_ms, device_us = device_busy(prof)
        print(f"resolve, profiled pass: {prof_s * 1e3:.1f} ms host clock, device busy "
              f"{busy_ms:.2f} ms = {busy_ms / (prof_s * 1e3):.2%}; by name: "
              + ", ".join(f"{k.split('(')[0]} {v / 1e3:.3f} ms"
                          for k, v in sorted(device_us.items(), key=lambda kv: -kv[1])[:8])
              + f"  [{card}]")
        per_window = {k: v * 1e3 / n_windows for k, v in stages.items()}
        print(f"resolve, host ms a window of {RESOLVE_WINDOW} by stage (a pass of its own, "
              f"{stages['pass'] * 1e3:.1f} ms): level sort {per_window['sort']:.2f}, id plan "
              f"and enqueue {per_window['ids']:.2f}, flatten and submit "
              f"{per_window['submit']:.2f}, id collect {per_window['ids_collect']:.2f}, verdict "
              f"collect {per_window['verdicts']:.2f}, consumed set and resolution "
              f"{per_window['walk']:.2f}, to_ledger_transaction + verify_ledger_batch "
              f"{per_window['ltx']:.2f}  [{card}]")

        # (b) a generated DAG on B8 and G8
        t0 = time.perf_counter()
        gen = GeneratedLedger(seed=20261019, n_parties=GEN_PARTIES, device=dev)
        gdag = gen.generate(n_gen)
        gallowed = lambda s: {gen.notary.owning_key}  # noqa: E731
        g_sigs = sum(len(s.sigs) for s in gdag.values())
        print(f"generated DAG: {len(gdag)} transactions, {g_sigs} signatures, built in "
              f"{time.perf_counter() - t0:.1f} s (signed on the card, a batch a transaction)")
        ghost_res, ghost_s = resolve_pass(dev, gdag, gallowed, sync, use_device=False)
        ghost = resolve_outcome(ghost_res)
        for tier in (Ed25519Tier(), Ed25519Tier(4096, 8)):
            g_launches, g_batches, g_s = resolve_launches(dev, gdag, gallowed, sync, ghost, tier)
            print(f"generated DAG on {tier}: {len(ghost[1])} levels (widest "
                  f"{max(len(lvl) for lvl in ghost[1])}), == the host route ({ghost_s:.2f} s), "
                  f"every primed id == "
                  f"hashlib's; launches {g_launches}; {g_batches} scheduler batches; first pass "
                  f"{len(gdag) / g_s:.0f} tx/s  [{card}]")
        print("generated DAG: the two tiers' results equal (each == the host route's)")

        # (c) failures on the card, and a CommercialPaper chain that resolves
        resolve_failures(dev, chain, notary, sync)
        paper, p_notary = paper_chain()
        pdag = {stx.id: stx for stx in paper}
        p_allowed = lambda s: {p_notary.owning_key}  # noqa: E731
        p_host = resolve_outcome(resolve_pass(dev, pdag, p_allowed, sync, use_device=False)[0])
        p_res = resolve_outcome(resolve_pass(dev, pdag, p_allowed, sync)[0])
        if p_res != p_host or len(p_res[0]) != 4:
            raise AssertionError("the CommercialPaper chain did not resolve as on the host")
        check_primed_ids(paper)
        print(f"CommercialPaper issue -> move -> redeem with its Cash: resolved on the card, "
              f"{len(p_res[1])} levels, == the host route")
    finally:
        shutdown_scheduler()


def ladder_probe(tree: str) -> int:
    """Phases 11 and 9 alone, run by the chip_smoke.py of ``tree`` over that
    tree's package: the ed25519 ladders on phase 3's 1,024 lanes (every
    adversarial kind), then kernel F on both curves."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as tree_smoke

    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [ladders of {os.path.abspath(tree)}]")
    _build.kernels()
    _kinds, pool, oracle = adversarial_pool()
    dev, int_rate = torch.device("cuda", 0), card_rates()[2]
    tree_smoke.check_g_kernel(dev, card, int_rate, pool, oracle)
    for curve in ("secp256k1", "secp256r1"):
        tree_smoke.check_ecdsa_kernel(dev, curve, card, int_rate)
    return 0


def notary_kernel_probe(tree: str) -> int:
    """Kernel E at a notary window's 2,048 lanes and kernel D over one
    window's Merkle levels, on the package and kernels of ``tree``, timed
    by this script's ``device_times``: D is the tree's one sweep launch
    where it has one (``sha256_merkle_sweep``), else its launch a level
    (``sha256_pair_level``) over the same plan."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [notary kernels of {os.path.abspath(tree)}]")
    _build.kernels()
    notary_kernel_times(torch.device("cuda", 0), card)
    return 0


def notary_kernel_times(dev, card, window=NOTARY_WINDOW) -> None:
    """``--notary-kernels``' checks and times on ``dev``, with whichever
    corda_tpu_torch is imported."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import ed25519_host
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.ops.ed25519_sign import comb_plain, comb_table, ed25519_comb
    from corda_tpu_torch.testing import notary_stream

    stream = notary_stream(2 * window, window, seed=20261017, device=dev)
    wtxs = [stx.tx for stx in stream.windows[1]]
    leaf_msgs, levels, roots, rows = txid._plan(*txid._flatten(wtxs))
    pool = torch.zeros((rows, 8), dtype=torch.int32, device=dev)
    sha.sha256_leaves(*sha.upload_messages(leaf_msgs, dev), out=pool[: len(leaf_msgs)])
    plan = [(first, torch.tensor(left, dtype=torch.int32, device=dev),
             torch.tensor(right, dtype=torch.int32, device=dev)) for first, left, right in levels]
    if hasattr(sha, "sha256_merkle_sweep"):
        def sweep():
            sha.sha256_merkle_sweep(pool, plan)
        shape = "one launch"
    else:
        def sweep():
            for first, left, right in plan:
                sha.sha256_pair_level(pool, left, right, first)
        shape = f"{len(plan)} launches"
    sweep()
    if sha.digest_words_to_bytes(pool[roots].cpu().numpy()) != [w.id.bytes for w in wtxs]:
        raise AssertionError("the window's roots != the host's ids")
    ms_d, host_d = device_times(sweep, 50)
    rng = random.Random(20261017)
    r_win = torch.from_numpy(np.frombuffer(b"".join(
        rng.randrange(ed25519_host.L).to_bytes(32, "little") for _ in range(window)),
        np.uint8).reshape(window, 32).copy()).to(dev)
    table = comb_table(dev)
    if not torch.equal(ed25519_comb(r_win, table), comb_plain(r_win, table)):
        raise AssertionError("kernel E != plain")
    ms_e, host_e = device_times(lambda: ed25519_comb(r_win, table), 20)
    print(f"ed25519_comb: {ms_e:.4f} ms on the card at {window} lanes, host "
          f"{host_e:.4f} ms a call  [{card}]")
    print(f"merkle levels of one window ({len(plan)} levels, "
          f"{sum(int(lv[1].shape[0]) for lv in plan)} pairs) as {shape}: {ms_d:.4f} ms on the "
          f"card, host {host_d:.4f} ms a call  [{card}]")


def challenge_times(dev, rng, card, int_rate, mhz, sizes=A_SIZES) -> dict:
    """Kernel A's time on the card and the host's time a call at each of
    ``sizes`` lanes, beside its bound and its serial floor (one warp's
    rounds chain); returns {lanes: ms}."""
    from corda_tpu_torch.ops.scalar25519 import (
        CHALLENGE_INT_OPS_PER_LANE,
        CHALLENGE_ROUNDS_WARP_OPS,
        ed25519_challenge,
    )

    floor = serial_floor_ms(CHALLENGE_ROUNDS_WARP_OPS, mhz)
    one_thread = serial_floor_ms(CHALLENGE_INT_OPS_PER_LANE, mhz)
    out = {}
    for n in sizes:
        packed, _err = hold_challenge(dev, rng, n)
        ms, host_ms = device_times(lambda: ed25519_challenge(packed), 50)
        b_ms, b_by = bound(n * (128 + 64 * 4), n * CHALLENGE_INT_OPS_PER_LANE, int_rate)
        print(f"ed25519_challenge at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call; bound {b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it; serial floor "
              f"{floor:.4f} ms ({CHALLENGE_ROUNDS_WARP_OPS} operations on the rounds warp at "
              f"{mhz:g} MHz; one thread a lane: {one_thread:.4f}), {floor / ms:.1%} of it"
              f"  [{card}]")
        out[n] = ms
    return out


def hash_kernel_probe(tree: str) -> int:
    """Kernels A and C on the package and kernels of ``tree``, each called
    as that tree's own paths call it, timed by this script's
    ``device_times``: C at a notary window's leaves, at 2,048 leaves of 13
    blocks and at one warp of leaves of 13, 1 and 7 blocks; A at B = 1,
    32, 512 and 8,192."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [hash kernels of {os.path.abspath(tree)}]")
    _build.kernels()
    print_ptxas("kernels A, C", ("ed25519_challenge", "sha256_leaves"))
    hash_kernel_times(torch.device("cuda", 0), card)
    return 0


def hash_kernel_times(dev, card, window=NOTARY_WINDOW) -> None:
    """``--hash-kernels``' checks and times on ``dev``, with whichever
    corda_tpu_torch is imported."""
    import torch

    from corda_tpu_torch.ops import scalar25519 as sc
    from corda_tpu_torch.ops import sha256 as sha
    from corda_tpu_torch.ops import txid
    from corda_tpu_torch.testing import notary_stream

    stream = notary_stream(2 * window, window, seed=20261017, device=dev)
    leaf_msgs = txid._plan(*txid._flatten([stx.tx for stx in stream.windows[1]]))[0]
    rng = random.Random(20261017)
    # one warp of 1, 7 and 13 blocks a leaf: the time a block of the serial
    # chain and the launch's fixed part
    shapes = [(f"the window's {len(leaf_msgs)} leaves", leaf_msgs)] + [
        (f"{lanes} leaves of 13 blocks", [rng.randbytes(C_LONG_BYTES) for _ in range(lanes)])
        for lanes in C_LONG_LANES] + [
        (f"32 leaves of {k} block{'s' * (k > 1)}", [rng.randbytes(nbytes) for _ in range(32)])
        for k, nbytes in ((1, 40), (7, 400))]
    for label, msgs in shapes:
        up = sha.upload_messages(msgs, dev)
        got = sha.sha256_leaves(*up)
        if sha.digest_words_to_bytes(got.cpu().numpy()) != [hashlib.sha256(m).digest()
                                                            for m in msgs]:
            raise AssertionError(f"kernel C != hashlib at {label}")
        ms, host_ms = device_times(lambda: sha.sha256_leaves(*up), 50)
        print(f"sha256_leaves at {label}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")
    for n in A_SIZES:
        plane, _msgs = fixed_plane(rng, n, 44)
        packed = torch.from_numpy(plane).to(dev)
        if not torch.equal(sc.ed25519_challenge(packed), sc.challenge_windows_plain(packed)):
            raise AssertionError(f"kernel A != plain at B={n}")
        ms, host_ms = device_times(lambda: sc.ed25519_challenge(packed), 50)
        print(f"ed25519_challenge at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")


def sphincs_kernel_probe(tree: str) -> int:
    """Kernel H on the package and kernels of ``tree``, held against the
    host engine and timed by this script's ``device_times`` at 8, 32, 64
    and 1,024 lanes of valid signatures, with TREE's ptxas report."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.ops import _build

    card = smi("name,power.limit")
    print(f"{card}  [kernel H of {os.path.abspath(tree)}]")
    _build.kernels()
    print_ptxas("kernel H", ("sphincs_verify",))
    print(f"kernel H: {_build.kernels().ct_sphincs_smem_bytes()} bytes of static shared memory "
          "a block")
    sphincs_kernel_times(torch.device("cuda", 0), card)
    return 0


def sphincs_kernel_times(dev, card, sizes=H_SIZES) -> None:
    """``--sphincs-kernel``'s checks and times on ``dev``, with whichever
    corda_tpu_torch is imported: every adversarial kind and four valid
    signatures against the host engine, then each size's valid lanes."""
    import numpy as np
    import torch

    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign, sphincs
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, split_plane, \
        sphincs_verify
    from corda_tpu_torch.testing import sphincs_adversarial_lanes

    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))

    def views_of(triples):
        plane = np.zeros(len(triples) * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*triples)))
        return split_plane(torch.from_numpy(plane).to(dev))

    pool = [t[1:] for t in sphincs_adversarial_lanes(16)] + valid
    got = sphincs_verify(*views_of(pool)).cpu().tolist()
    if got != [sphincs.verify(*t) for t in pool]:
        raise AssertionError("kernel H != the host engine on the adversarial lanes")
    print(f"kernel H == sphincs.verify: {len(pool)} lanes ({sum(got)} accepted)")
    for n in sizes:
        views = views_of([valid[i % len(valid)] for i in range(n)])
        if not bool(sphincs_verify(*views).all()):
            raise AssertionError(f"kernel H refused a valid lane at B={n}")
        ms, host_ms = device_times(lambda: sphincs_verify(*views), 20 if n < 1024 else 5)
        print(f"sphincs_verify at B={n}: {ms:.4f} ms on the card, host {host_ms:.4f} ms a "
              f"call  [{card}]")


def stamped_sphincs_source(src: str) -> str:
    """A copy of kernel H's source (csrc/sphincs.cu of any tree) whose
    kernel takes a first argument ``ts`` and has thread 0 write clock64()
    into ts[16 * block + k] after the precheck and after every block-wide
    barrier: the SM clocks of each stage. Exported as ``stamped_launch``."""
    import re

    body = src[src.index("__global__"):src.index("extern \"C\"")]
    body = body.replace("sphincs_verify_kernel(",
                        "sphincs_stamped_kernel(unsigned long long* __restrict__ ts, ", 1)
    pre = re.search(r"if \(!pre\[\w+\]\) \{.*?return;\n    \}\n", body, re.S)
    body = (body[:pre.end()] + "    unsigned long long* tb = ts + (size_t)blockIdx.x * 16;\n"
            "    int tk = 0;\n    if (threadIdx.x == 0) tb[tk] = clock64();\n    tk++;\n"
            + body[pre.end():])
    body = body.replace("__syncthreads();",
                        "__syncthreads();\n        if (threadIdx.x == 0) tb[tk] = clock64();\n"
                        "        tk++;")
    return ("#include <cuda_runtime.h>\n#include \"sphincs.cuh\"\n" + body + """
extern "C" int stamped_launch(void* ts, const void* sigs, const void* dgs, const void* idxs,
                              const void* pre, void* out, int n) {
    sphincs_stamped_kernel<<<n, CT_SP_THREADS>>>((unsigned long long*)ts, (const uint8_t*)sigs,
        (const uint8_t*)dgs, (const int64_t*)idxs, (const uint8_t*)pre, (uint8_t*)out);
    return (int)cudaGetLastError();
}
""")


def sphincs_stage_probe(tree: str) -> int:
    """Kernel H of ``tree`` with a clock64() stamp after every stage barrier
    (``stamped_sphincs_source``), built with nvcc beside TREE's kernels: the
    median SM clocks of each stage over the blocks at 32 and 1,024 lanes of
    valid signatures, and the kernel's time with this script's timer."""
    import ctypes
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from corda_tpu_torch.crypto import derive_keypair_from_entropy, sign
    from corda_tpu_torch.ops import _build
    from corda_tpu_torch.ops.sphincs_batch import ROW_BYTES, pack_plane, split_plane

    card = smi("name,power.limit")
    print(f"{card}  [kernel H's stages of {os.path.abspath(tree)}]")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "sphincs_stamped.cu"
    src.write_text(stamped_sphincs_source((_build.CSRC / "sphincs.cu").read_text()))
    lib_path = _build.BUILD_DIR / "libsphincs_stamped.so"
    _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                 str(src), "-o", str(lib_path)])
    lib = ctypes.CDLL(str(lib_path))
    lib.stamped_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    valid = []
    for k in range(4):
        kp = derive_keypair_from_entropy(5, hashlib.sha256(b"phase 16 %d" % k).digest())
        msg = b"phase 16 message %d" % k
        valid.append((kp.public.encoded, sign(kp.private, msg), msg))
    for n in (32, 1024):
        plane = np.zeros(n * ROW_BYTES, np.uint8)
        pack_plane(plane, *map(list, zip(*[valid[i % 4] for i in range(n)])))
        sigs, dgs, idxs, pre = split_plane(torch.from_numpy(plane).cuda())
        out = torch.zeros(n, dtype=torch.uint8, device="cuda")
        ts = torch.zeros(n * 16, dtype=torch.int64, device="cuda")

        def launch():
            rc = lib.stamped_launch(ts.data_ptr(), sigs.data_ptr(), dgs.data_ptr(),
                                    idxs.data_ptr(), pre.data_ptr(), out.data_ptr(), n)
            if rc:
                raise RuntimeError(f"stamped kernel H launch failed: cudaError {rc}")

        launch()
        torch.cuda.synchronize()
        if not bool(out.bool().all()):
            raise AssertionError(f"the stamped kernel H refused a valid lane at B={n}")
        t = ts.view(n, 16)[:, :11].cpu().numpy().astype(np.int64)
        stages = np.median(np.diff(t, axis=1), axis=0).astype(int).tolist()
        ms = device_times(launch, 20 if n < 1024 else 5)[0]
        print(f"kernel H stages at B={n}: SM clocks (median over blocks) {stages}, in all "
              f"{int(np.median(t[:, 10] - t[:, 0]))}; {ms:.4f} ms a launch with the stamps  "
              f"[{card}]")
    return 0


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--ladders":
        return ladder_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--notary-kernels":
        return notary_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--hash-kernels":
        return hash_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphincs-kernel":
        return sphincs_kernel_probe(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--sphincs-stages":
        return sphincs_stage_probe(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from corda_tpu_torch.batchverify import verify_rows
        from corda_tpu_torch.crypto import PublicKey, ed25519_host
        from corda_tpu_torch.ops import _build
        from corda_tpu_torch.ops.ed25519_ladder import (
            TABLE_ROWS,
            ed25519_verify_ladder,
            int_ops_per_verify,
            ladder_table,
            verify_ladder_plain,
        )
        from corda_tpu_torch.ops.scalar25519 import (
            CHALLENGE_INT_OPS_PER_LANE,
            challenge_windows_plain,
            ed25519_challenge,
        )
        from corda_tpu_torch.serving import BULK, INTERACTIVE, SERVICE
        from corda_tpu_torch.testing import signed_triples
        from corda_tpu_torch.verifier import dispatch_signature_rows
    except ImportError as e:
        print(f"chip_smoke: the corda_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    rng = random.Random(20261016)

    # ---- 1. the card, the versions, the build
    card = smi("name,power.limit")
    print(card)
    n_sm, sm_clock_mhz, int_rate = card_rates()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  {n_sm} SMs, max SM clock {sm_clock_mhz:g} MHz")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if _build.build_info['built'] else 'cached'})")
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    print_ptxas("kernels A, C", ("ed25519_challenge", "sha256_leaves"))
    print(f"kernel A: {_build.kernels().ct_ed25519_challenge_smem_bytes()} bytes of dynamic "
          "shared memory a 128-thread block (as the launch sets it)")

    # ---- 2. kernel A against its plain version
    err_a = 0
    for n, mlen in [(n, 44) for n in A_SIZES] + [(37, 47), (256, 0), (256, 47)]:
        err_a = max(err_a, hold_challenge(dev, rng, n, mlen)[1])
        print(f"kernel A == plain == hashlib: {n} lanes, {mlen}-byte messages")

    # ---- 3. kernel B against its plain version (and the oracle)
    t0 = time.perf_counter()
    kinds, pool, oracle = adversarial_pool()
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
    # the cofactored rule's verdicts, which full buckets take
    cof_oracle = verify_rows(pool)
    var_cof = verify_rows(var_pool)
    print(f"cofactored oracle: {sum(a != b for a, b in zip(oracle, cof_oracle))} of "
          f"{len(pool)} lanes differ from the cofactorless one")
    requests = []
    offset = 0
    for k, size in enumerate(MAIN_PATH_SIZES):
        idx = [(offset + i) % len(pool) for i in range(size)]
        requests.append(([pool[i] for i in idx], [bool(oracle[i]) for i in idx],
                         (BULK, SERVICE, INTERACTIVE)[k % 3], [cof_oracle[i] for i in idx]))
        offset += size
    idx = [i % len(var_pool) for i in range(VAR_REQUEST_ROWS)]
    requests.insert(3, ([var_pool[i] for i in idx], [var_oracle[i] for i in idx], SERVICE,
                        [var_cof[i] for i in idx]))
    n_rows = sum(len(r[0]) for r in requests)
    assert len(requests) >= 24 and n_rows >= 65536

    rows_by_req = [[(PublicKey(4, pk), s, m) for pk, s, m in req[0]] for req in requests]
    classes = [req[2] for req in requests]
    (launches, counters, batches, e2e_ms, wall_ms, steady_ms, prof,
     prof_wall_ms, took, a_batches) = backlog_passes(dev, rows_by_req, requests, classes,
                                                     n_rows,
                                                     (ed25519_challenge, ed25519_verify_ladder))
    launches_a = launches["ed25519_challenge"]
    launches_b = launches["ed25519_verify_ladder"]
    if launches_a == 0 or launches_b == 0:
        raise AssertionError(f"kernel launches A={launches_a} B={launches_b}: "
                             "the main path missed a kernel")
    if len(a_batches[0]) != launches_a:
        raise AssertionError(f"{len(a_batches[0])} batches of the first pass launch kernel A "
                             f"by their rows, but it was launched {launches_a} times")
    a_buckets = {b for sizes in a_batches for b in sizes}
    print(f"main path: {len(requests)} requests, {n_rows} signatures, "
          f"{len(batches)} device batches, every verdict == oracle where the two rules "
          f"agree (of the rows where they differ, {took[0]} took the cofactored verdict of a "
          f"full bucket, {took[1]} the cofactorless one), device_rows == {n_rows}; launches "
          f"A={launches_a} B={launches_b}; counters {counters}")
    print(f"e2e, first pass: {n_rows} sigs in {e2e_ms:.1f} ms (CUDA events; host "
          f"clock {wall_ms:.1f} ms) = {n_rows / e2e_ms * 1e3:.0f} sigs/s  [{card}]")
    print(f"e2e, steady pass: {n_rows} sigs in {steady_ms:.1f} ms (CUDA events) = "
          f"{n_rows / steady_ms * 1e3:.0f} sigs/s  [{card}]")
    busy_ms, device_us = device_busy(prof)
    print(f"profiled pass: {prof_wall_ms:.1f} ms host clock, device busy "
          f"{busy_ms:.1f} ms = {busy_ms / prof_wall_ms:.1%}; by name: "
          + ", ".join(f"{k.split('(')[0]} {v / 1e3:.2f} ms"
                      for k, v in sorted(device_us.items(), key=lambda kv: -kv[1]))
          + f"  [{card}]")

    # kernel A at every batch size the path gave it in the three passes
    for n in sorted(a_buckets):
        err_a = max(err_a, hold_challenge(dev, rng, n)[1])
    print(f"kernel A == plain == hashlib at every batch size the main path launched it at: "
          f"{sorted(a_buckets)}")

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
    ms_a, host_a = device_times(lambda: ed25519_challenge(big), 50)
    plain_ms_a = plain_ms(lambda: challenge_windows_plain(big), 3)
    ms_b = cuda_ms(lambda: ed25519_verify_ladder(big, win_big, table), 10)
    plain_ms_b = plain_ms(lambda: verify_ladder_plain(big, win_big, table))
    bound_a = bound(n * (128 + 64 * 4), n * CHALLENGE_INT_OPS_PER_LANE, int_rate)
    bound_b = bound(n * (161 + 64 * 4 + 1) + TABLE_ROWS * 40, n * int_ops_per_verify(8),
                    int_rate)
    for name, ms, p_ms, (b_ms, b_by) in (
        ("ed25519_challenge", ms_a, plain_ms_a, bound_a),
        ("ed25519_verify_ladder", ms_b, plain_ms_b, bound_b),
    ):
        print(f"{name}: {ms:.4f} ms on the card at B={n} (plain {p_ms:.1f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it)  [{card}]")
    print(f"ed25519_challenge: host {host_a:.4f} ms a call at B={n}  [{card}]")
    challenge_times(dev, rng, card, int_rate, sm_clock_mhz)

    # the ladder's time per launch against its lanes
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

    # ---- 6. kernels C and D against their plain versions and hashlib
    err_c, err_d = check_sha256_kernels(dev, rng)

    # ---- 7. kernel E against its plain version and the oracle
    err_e = check_comb_kernel(dev, rng)

    # ---- 8. the notary path
    notary = notary_phase(dev, rng, card, int_rate)
    launches_n = notary["launches"]
    ms_c, plain_ms_c, bound_c, err_c_path = notary["sha256_leaves"]
    ms_d, plain_ms_d, bound_d, err_d_path = notary["sha256_merkle_sweep"]
    ms_e, plain_ms_e, bound_e, err_e_path = notary["ed25519_comb"]
    err_c, err_d, err_e = max(err_c, err_c_path), max(err_d, err_d_path), max(err_e, err_e_path)

    # ---- 9. kernel F against its plain version and the oracle
    entry = ""
    for line in _build.build_info["ptxas"].splitlines():
        if "Compiling entry" in line:
            entry = line
        if "ecdsa_verify" in entry and any(w in line for w in ("Compiling entry", "registers",
                                                               "spill")):
            print("ptxas (kernel F):", line.strip())
    print(f"kernel F: {_build.kernels().ct_ecdsa_verify_smem_bytes()} bytes of dynamic shared "
          "memory a 128-thread block (as the launch sets it)")
    ecdsa = {curve: check_ecdsa_kernel(dev, curve, card, int_rate)
             for curve in ("secp256k1", "secp256r1")}

    # ---- 10. the mixed-scheme path
    launches_m = mixed_phase(dev, card)

    # ---- 11. kernels B and G, both shapes, against their plain versions and
    # the oracle, and their times in turns
    ladders = check_g_kernel(dev, card, int_rate, pool, oracle)

    # ---- 12. the backlog on the radix-4096 tier
    launches_g8 = tier_backlog_phase(dev, card, rows_by_req, requests, classes, n_rows)

    # ---- 13. the validating notary on each tier
    launches_v = validating_phase(dev, card)
    from corda_tpu_torch.ops.ed25519 import Ed25519Tier

    launches_b4 = launches_v[Ed25519Tier(8192, 4)]["ed25519_verify_ladder_w4"]
    launches_g4 = launches_v[Ed25519Tier(4096, 4)]["ed25519_verify_g4"]

    # ---- 14. full ed25519 buckets under the cofactored rule, each tier
    cofactored_phase(dev, card, pool)

    # ---- 15. the back-chain resolve
    resolve_phase(dev, card)

    # ---- 16. kernel H alone
    sph = check_sphincs_kernel(dev, card, int_rate, sm_clock_mhz)
    h_ms, h_plain_ms, h_bound, err_h = sph[32]  # the mixed path's bucket

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
        {"name": "sha256_leaves", "route": "cuda",
         "source": "corda_tpu_torch/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256.py:117",
         "launches": launches_n["sha256_leaves"], "max_abs_err": float(err_c),
         "ms": ms_c, "plain_ms": plain_ms_c, "bound_ms": bound_c[0],
         "bound_by": bound_c[1], "library_ms": None},
        {"name": "sha256_merkle_sweep", "route": "cuda",
         "source": "corda_tpu_torch/csrc/sha256.cu",
         "replaces": "corda_tpu/ops/sha256.py:142",
         "launches": launches_n["sha256_merkle_sweep"], "max_abs_err": float(err_d),
         "ms": ms_d, "plain_ms": plain_ms_d, "bound_ms": bound_d[0],
         "bound_by": bound_d[1], "library_ms": None},
        {"name": "ed25519_comb", "route": "cuda",
         "source": "corda_tpu_torch/csrc/ed25519_comb.cu",
         "replaces": "corda_tpu/ops/ed25519_sign.py:89",
         "launches": launches_n["ed25519_comb"], "max_abs_err": float(err_e),
         "ms": ms_e, "plain_ms": plain_ms_e, "bound_ms": bound_e[0],
         "bound_by": bound_e[1], "library_ms": None},
    ] + [
        {"name": name, "route": "cuda", "source": "corda_tpu_torch/csrc/ecdsa_verify.cu",
         "replaces": "corda_tpu/ops/secp256_pallas.py:1120",
         "launches": launches_m[name], "max_abs_err": float(ecdsa[curve][3]),
         "ms": ecdsa[curve][0], "plain_ms": ecdsa[curve][1], "bound_ms": ecdsa[curve][2][0],
         "bound_by": ecdsa[curve][2][1], "library_ms": None}
        for name, curve in (("ecdsa_verify_k1", "secp256k1"), ("ecdsa_verify_r1", "secp256r1"))
    ] + [
        {"name": name, "route": "cuda", "source": f"corda_tpu_torch/csrc/{source}",
         "replaces": replaces, "launches": n_launch,
         "max_abs_err": float(ladders[name][3]), "ms": ladders[name][0],
         "plain_ms": ladders[name][1], "bound_ms": ladders[name][2][0],
         "bound_by": ladders[name][2][1], "library_ms": None}
        for name, source, replaces, n_launch in (
            ("ed25519_verify_ladder_w4", "ed25519_verify.cu",
             "corda_tpu/ops/ed25519_pallas13.py:388", launches_b4),
            ("ed25519_verify_g8", "ed25519_verify_g.cu", "corda_tpu/ops/ed25519_pallas.py:523",
             launches_g8),
            ("ed25519_verify_g4", "ed25519_verify_g.cu", "corda_tpu/ops/ed25519_pallas.py:523",
             launches_g4))
    ] + [
        {"name": "sphincs_verify", "route": "cuda", "source": "corda_tpu_torch/csrc/sphincs.cu",
         "replaces": "corda_tpu/ops/sphincs_batch.py:279",
         "launches": launches_m["sphincs_verify"], "max_abs_err": float(err_h), "ms": h_ms,
         "plain_ms": h_plain_ms, "bound_ms": h_bound[0], "bound_by": h_bound[1],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
