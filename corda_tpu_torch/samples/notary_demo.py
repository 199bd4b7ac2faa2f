"""Notary demo: drive single-node, Raft and BFT notary configurations
(counterpart of corda_tpu/samples/notary_demo.py).

Capability parity with the reference's notary demo
(samples/notary-demo/.../{Single,Raft,BFT}NotaryCordform.kt + Notarise.kt:
issue N states, notarise N move transactions against the chosen cluster,
print the signatures collected). The ``batched-raft`` mode runs the
batched notary on ``device`` (the card unless ``device="cpu"``); the
sequential modes run the host's ``ValidatingNotaryService``, as the
reference's do.
"""

from __future__ import annotations

import random
import time

from ..crypto import TransactionSignature, generate_keypair
from ..device import resolve_device
from ..ledger import CordaX500Name, Party
from ..messaging import InMemoryMessagingNetwork
from ..notary import (
    BatchedNotaryService,
    BFTUniquenessProvider,
    InMemoryUniquenessProvider,
    NotaryError,
    RaftUniquenessProvider,
    ValidatingNotaryService,
)
from ..testing import GeneratedLedger


def _notarise_all(service, gen: GeneratedLedger, txs) -> tuple[int, int]:
    ok = conflicts = 0
    for stx in txs:
        if not stx.inputs:
            continue  # issues need no notarisation
        try:
            sig = service.process(
                stx, resolve_state=lambda ref: gen.transactions[
                    ref.txhash
                ].tx.outputs[ref.index], caller_name="demo",
            )
            sig.verify(stx.id)
            ok += 1
        except NotaryError:
            conflicts += 1
    return ok, conflicts


def run_demo(n_txs: int = 20,
             modes=("single", "raft", "bft", "batched-raft"),
             verbose: bool = True, device=None) -> dict:
    dev = resolve_device(device)
    results = {}
    for mode in modes:
        kp = generate_keypair()
        notary_party = Party(
            CordaX500Name(f"{mode.title()} Notary", "Zurich", "CH"), kp.public
        )
        net = InMemoryMessagingNetwork()
        net.start_pumping()
        cluster_stoppers = []
        try:
            if mode == "single":
                uniqueness = InMemoryUniquenessProvider()
            elif mode in ("raft", "batched-raft"):
                providers = RaftUniquenessProvider.make_cluster(
                    [f"{mode}-{i}" for i in range(3)], net
                )
                cluster_stoppers = [p.node.stop for p in providers]
                uniqueness = providers[0]
            elif mode == "bft":
                replicas, client_factory = BFTUniquenessProvider.make_cluster(
                    4, net
                )
                cluster_stoppers = [r.stop for r in replicas]
                uniqueness = client_factory("demo-client")
            else:
                raise ValueError(mode)

            service = ValidatingNotaryService(notary_party, kp, uniqueness)
            # the reference's DAG shape for seed 42; keys and salts from
            # a second seeded source
            gen = GeneratedLedger(
                seed=42, notary=notary_party, notary_keypair=kp, device=dev,
                entropy=random.Random(f"notary-demo:{mode}"),
            )
            # signatures on deps must NOT include the notary sig yet (the
            # notary itself notarises), so generate without it, then feed
            # the whole DAG in topological (generation) order
            txs = list(gen.generate(n_txs, with_notary_sig=False).values())
            t0 = time.time()
            if mode == "batched-raft":
                # windows of transactions settle as ONE consensus round
                # each through the batched notary on the device
                batched = BatchedNotaryService(
                    notary_party, kp, uniqueness,
                    validating=True, max_batch=8, device=dev,
                )
                resolve = lambda ref: gen.transactions[  # noqa: E731
                    ref.txhash
                ].tx.outputs[ref.index]
                moves = [s for s in txs if s.inputs]
                chunks = [
                    [(s, resolve, "demo") for s in moves[i:i + 8]]
                    for i in range(0, len(moves), 8)
                ]
                try:
                    out = batched.process_stream(chunks, depth=2)
                finally:
                    batched.shutdown()
                ok = sum(
                    1 for batch in out for r in batch
                    if isinstance(r, TransactionSignature)
                )
                conflicts = sum(len(b) for b in out) - ok
            else:
                ok, conflicts = _notarise_all(service, gen, txs)
            elapsed = time.time() - t0
            # a double-spend attempt must be rejected by every tier
            moves = [s for s in txs if s.inputs]
            rejected = False
            if moves:
                victim = moves[0]
                try:
                    service.uniqueness.commit(
                        list(victim.inputs),
                        gen.transactions[
                            next(iter(gen.transactions))
                        ].id,  # different tx id -> conflict
                        "attacker",
                    )
                except NotaryError:
                    rejected = True
            results[mode] = {
                "notarised": ok,
                "conflicts": conflicts,
                "double_spend_rejected": rejected,
                "elapsed_s": round(elapsed, 3),
            }
        finally:
            for stop in cluster_stoppers:
                stop()
            net.stop_pumping()
    if verbose:
        for mode, r in results.items():
            print(f"notary-demo[{mode}]: {r}")
    return results


if __name__ == "__main__":
    run_demo()
