"""Wavefront (topological-level) verification of transaction DAGs on the card
(counterpart of corda_tpu/parallel/wavefront.py).

The reference system resolves a back-chain by download, topological sort,
then one full transaction verification at a time
(ResolveTransactionsFlow.kt:38-105). Here the order-free work of a whole
window of levels goes to the card at once:

  1. the Merkle id of every transaction, recomputed from its component
     bytes and checked against the id the chain claims
     (``ops/txid.py::dispatch_check_ids``: kernels C and D);
  2. every signature, in one scheme-bucketed batch through the shared
     ``DeviceScheduler`` (kernel A, then the tier's ladder, B or G);

and the order-dependent remainder runs on the host, level by level:
input resolution, the running consumed set that rejects a double spend
inside the DAG, and contract semantics batched per window through
``verify_ledger_batch``.

Each window is traced as a ``wavefront.window`` span under the caller's
context (enqueue, device, walk), its signature batch's ``serving.*`` spans
beneath it, and its id sweep is fed to devicemon as a ``DispatchProbe`` on
the window's ordinal, settled when the sweep is collected (``ok=False``
when it fails or the window is abandoned).
"""

from __future__ import annotations

import dataclasses
from collections import deque

from ..crypto import SecureHash
from ..device import resolve_device
from ..ledger import StateRef, verify_ledger_batch
from ..observability import SPAN_WAVEFRONT_WINDOW, tracer
from ..observability.devicemon import active_devicemon
from ..ops.ed25519 import Ed25519Tier
from ..ops.txid import dispatch_check_ids
from ..serving import SERVICE, FuturePending, ServingError, device_scheduler
from ..verifier import dispatch_transactions


class DagVerificationError(Exception):
    pass


class DoubleSpendInDagError(DagVerificationError):
    def __init__(self, ref: StateRef, tx_id: SecureHash):
        self.ref = ref
        self.tx_id = tx_id
        super().__init__(f"state {ref} consumed twice (second spend in {tx_id})")


class UnresolvedStateError(DagVerificationError):
    def __init__(self, ref: StateRef, tx_id: SecureHash):
        self.ref = ref
        self.tx_id = tx_id
        super().__init__(f"tx {tx_id} references unresolvable state {ref}")


def topological_levels(deps: dict) -> list[list]:
    """Kahn's algorithm by level: ``deps[node]`` is the set of the node's
    parents (edges to nodes outside ``deps`` are dropped). Returns the
    levels root first; raises on a cycle. The levels stay explicit because
    each is a unit of the device batches."""
    remaining = {n: {d for d in ds if d in deps} for n, ds in deps.items()}
    levels: list[list] = []
    while remaining:
        ready = [n for n, ds in remaining.items() if not ds]
        if not ready:
            raise DagVerificationError("dependency cycle in transaction DAG")
        levels.append(ready)
        for n in ready:
            del remaining[n]
        ready_set = set(ready)
        for ds in remaining.values():
            ds -= ready_set
    return levels


@dataclasses.dataclass
class DagVerifyResult:
    order: list          # tx ids in verified order (level-major)
    levels: list[list]   # tx ids per wavefront level
    n_sigs: int          # total signatures checked
    consumed: set        # every StateRef consumed inside the DAG


def _walk_levels(win_levels, stxs, consumed, outputs, order, resolve,
                 check_contracts) -> list:
    """The order-dependent walk of one window, level by level: the
    consumed set (a double spend inside the DAG raises), every input
    resolved, then the level's outputs published for the next. Returns
    the window's ledger transactions when ``check_contracts``."""
    ltx_batch: list = []
    for level in win_levels:
        for tid in level:
            for ref in stxs[tid].inputs:
                if ref in consumed:
                    raise DoubleSpendInDagError(ref, tid)
                consumed.add(ref)
        # structural resolution is not optional: every input must resolve,
        # inside the DAG or through resolve_external, even without contracts
        for tid in level:
            stx = stxs[tid]
            for ref in stx.inputs:
                resolve(ref, tid)
            if check_contracts:
                ltx_batch.append(stx.tx.to_ledger_transaction(
                    lambda ref, t=tid: resolve(ref, t)))
        for tid in level:
            for i, ts in enumerate(stxs[tid].tx.outputs):
                outputs[StateRef(tid, i)] = ts
        order.extend(level)
    return ltx_batch


def verify_transaction_dag(
    stxs: dict,
    resolve_external=None,
    allowed_missing_fn=None,
    *,
    use_device: bool = True,
    max_workers: int = 8,
    check_contracts: bool = True,
    recompute_ids: bool = True,
    window: int = 256,
    depth: int = 3,
    use_scheduler: bool = True,
    device=None,
    tier: Ed25519Tier | None = None,
    batch_rlc: bool = True,
) -> DagVerifyResult:
    """Verify ``stxs`` ({tx id: SignedTransaction}, interdependent) wavefront
    by wavefront on ``device`` (the card unless ``device="cpu"``).

    ``resolve_external(ref)`` supplies states created outside the DAG (None
    when it has none); an input naming a transaction of the DAG resolves
    from that transaction's outputs. ``allowed_missing_fn(stx)`` names the
    keys allowed to be missing (the notary's, say); none by default.
    ``tier`` and ``batch_rlc`` pick the ed25519 ladder and the full
    buckets' rule, as ``BatchedNotaryService`` takes them. ``max_workers``
    is the reference's argument and has no use here: the walk batches
    contracts per window.

    With ``use_device`` and ``recompute_ids`` every id is recomputed from
    the component bytes and checked against the claimed one: a forged
    chain link raises at its window, and the verified ids stay primed.

    The levels are cut into windows of at least ``window`` transactions
    (whole levels), and a two-stage pipeline keeps up to ``depth`` windows
    in flight:

    - dispatch: the claimed ids primed (so the signature rows flatten with
      no host hashing), the id sweep and the signature batch enqueued with
      no readback. The batch rides the shared scheduler in the SERVICE
      class (the direct dispatch when it refuses), its pad bucket pinned
      to the largest window's signature count so far;
    - walk, at the front of the queue: the id check collected (a mismatch
      raises here), the verdicts collected, then ``_walk_levels`` and the
      window's contracts through ``verify_ledger_batch``.

    The id sweep and the signatures run on ``device`` and nowhere else: the
    reference's gate that moves them to the host over a slow link is not
    ported. Any failure raises, and drops the claimed ids of every window
    still in flight. On success: order, levels, signatures
    checked and the consumed set."""
    device = resolve_device(device)

    deps: dict = {}
    for tid, stx in stxs.items():
        deps[tid] = {ref.txhash for ref in stx.inputs if ref.txhash in stxs}
    levels = topological_levels(deps)

    # level-aligned windows of >= `window` transactions
    windows: list[list[list]] = []
    cur: list[list] = []
    cnt = 0
    for level in levels:
        cur.append(level)
        cnt += len(level)
        if cnt >= window:
            windows.append(cur)
            cur, cnt = [], 0
    if cur:
        windows.append(cur)

    def allowed_for(s):
        return allowed_missing_fn(s) if allowed_missing_fn else set()

    check_ids = recompute_ids and use_device

    outputs: dict = {}  # StateRef -> TransactionState of verified transactions
    consumed: set = set()
    order: list = []
    n_sigs = 0

    def resolve(ref: StateRef, tid: SecureHash):
        if ref in outputs:
            return outputs[ref]
        if resolve_external is not None:
            st = resolve_external(ref)
            if st is not None:
                return st
        raise UnresolvedStateError(ref, tid)

    # grows to the largest window's signature count: one pad bucket for
    # every window, the ragged last one included
    pin_bucket = 0

    trc = tracer()
    resolve_ctx = trc.current()
    ordinal = device.index if device.index is not None else 0

    def dispatch_window(win_levels):
        """Enqueue a window's order-free work: (window span, pending id
        check or None, pending signature check, devicemon probe or None)."""
        tids = [tid for lvl in win_levels for tid in lvl]
        span = trc.start(SPAN_WAVEFRONT_WINDOW, resolve_ctx,
                         attrs={"txs": len(tids), "levels": len(win_levels)})
        pending_ids = None
        probe = None
        try:
            if check_ids:
                # prime each claimed id, so the signable payloads below need
                # no host hashing; the walk raises a mismatch before any
                # verdict that rests on a claim is used
                for tid in tids:
                    object.__getattribute__(stxs[tid].tx, "__dict__")["_id"] = tid
                pending_ids = dispatch_check_ids({tid: stxs[tid] for tid in tids}, device)
                # the window's own device work is the id sweep (the
                # signature batch is attributed by its scheduler)
                span.set_attr("device", ordinal)
                mon = active_devicemon()
                if mon is not None:
                    probe = mon.probe(ordinal, len(tids))
            return span, pending_ids, dispatch_sigs(tids, span), probe
        except BaseException as e:
            # this window's claimed ids were never checked
            if probe is not None:
                probe.settle(ok=False)
            if pending_ids is not None:
                pending_ids.abort()
            elif check_ids:
                for tid in tids:
                    object.__getattribute__(stxs[tid].tx, "__dict__").pop("_id", None)
            span.set_error(e)
            span.finish()
            raise

    def dispatch_sigs(tids, span):
        nonlocal pin_bucket
        win_stxs = [stxs[tid] for tid in tids]
        allowed = [allowed_for(s) for s in win_stxs]
        pin_bucket = max(pin_bucket, sum(len(s.sigs) for s in win_stxs))
        if use_scheduler:
            try:
                return FuturePending(device_scheduler(device, tier, batch_rlc).submit_transactions(
                    win_stxs, allowed, priority=SERVICE, use_device=use_device,
                    min_bucket=pin_bucket, trace=span))
            except ServingError:
                pass  # saturated or shut down: dispatch directly, same verdicts
        return dispatch_transactions(
            win_stxs, allowed, use_device=use_device,
            min_bucket=pin_bucket if use_device else None, device=device, tier=tier,
            batch_rlc=batch_rlc)

    def walk_window(win_levels, staged):
        span, pending_ids, pending, probe = staged
        with span:
            walk_window_inner(win_levels, pending_ids, pending, probe)

    def walk_window_inner(win_levels, pending_ids, pending, probe):
        nonlocal n_sigs
        if pending_ids is not None:
            # a forged chain link raises at its own window; the probe
            # settles either way
            try:
                pending_ids.collect()
            except BaseException:
                if probe is not None:
                    probe.settle(ok=False)
                raise
            if probe is not None:
                probe.settle()
        report = pending.collect()
        report.raise_first()
        n_sigs += report.n_sigs
        ltx_batch = _walk_levels(win_levels, stxs, consumed, outputs, order, resolve,
                                 check_contracts)
        # a window's outputs feed later windows only if none of its
        # contracts failed
        if check_contracts:
            for err in verify_ledger_batch(ltx_batch):
                if err is not None:
                    raise err

    in_flight: deque = deque()  # (window's levels, (span, pending ids, pending sigs, probe))
    try:
        for win_levels in windows:
            in_flight.append((win_levels, dispatch_window(win_levels)))
            if len(in_flight) >= depth:
                walk_window(*in_flight.popleft())
        while in_flight:
            walk_window(*in_flight.popleft())
    except BaseException as e:
        # the abandoned windows' claimed ids were never checked; their spans
        # close with the failure that aborted the resolve
        for _win_levels, (span, pending_ids, _pending, probe) in in_flight:
            if probe is not None:
                probe.settle(ok=False)
            if pending_ids is not None:
                pending_ids.abort()
            span.set_error(e)
            span.finish()
        raise

    return DagVerifyResult(order, levels, n_sigs, consumed)
