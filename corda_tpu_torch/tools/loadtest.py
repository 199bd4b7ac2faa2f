"""Load-test harness (counterpart of corda_tpu/tools/loadtest.py).

Capability parity with the reference's loadtest tool
(tools/loadtest/.../LoadTest.kt:37-69): a load test is four functions —

- ``generate(state, parallelism)`` → list of commands to inject,
- ``interpret(state, command)`` → the expected next state,
- ``execute(command)`` → perform it against the cluster,
- ``gather()`` → observed state, checked against the interpreted one —

run for N generations with a bounded injector pool, optionally under
*disruptions* (kill/restart a node mid-run — Disruption.kt's
kill/restart/strain model) to prove the invariants hold through failures.

The reference drives a deployed cluster over SSH; here the cluster handle
is any object exposing the same operations (an in-process
``MockNetworkNodes`` ensemble or RPC connections to real node processes).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoadTest:
    """One test definition (reference: LoadTest<T, S>)."""

    name: str
    generate: Callable[[Any, int], list]       # (state, parallelism) -> cmds
    interpret: Callable[[Any, Any], Any]       # (state, cmd) -> state'
    execute: Callable[[Any], None]             # cmd -> effect on cluster
    gather: Callable[[], Any]                  # () -> observed state
    initial_state: Any = None


@dataclasses.dataclass
class RunParameters:
    """(reference: LoadTest.RunParameters :61)."""

    parallelism: int = 4
    generate_count: int = 10
    execution_frequency_hz: float | None = 20.0   # None = as fast as possible
    gather_frequency: int = 5                     # check every N generations


@dataclasses.dataclass
class Disruption:
    """A failure injected while load runs (reference: Disruption.kt)."""

    name: str
    apply: Callable[[], Callable[[], None] | None]  # returns undo (or None)
    at_generation: int = 1


class LoadTestError(AssertionError):
    pass


class LoadTestRunner:
    def __init__(self, test: LoadTest, params: RunParameters | None = None,
                 disruptions: list[Disruption] | None = None,
                 rng: random.Random | None = None):
        self.test = test
        self.params = params or RunParameters()
        self.disruptions = list(disruptions or [])
        self.rng = rng or random.Random(0)
        self._metrics_lock = threading.Lock()
        self.metrics = {"executed": 0, "failed": 0, "gathers": 0,
                        "disruptions": 0}

    def run(self) -> dict:
        """Run the test. The returned metrics carry a ``walls`` section
        timing each stage SEPARATELY — ``generate_s`` (command generation
        + model interpretation), ``execute_s`` (submit of the first
        command to resolution of the last future, per generation),
        ``gather_s`` (state collection + divergence check) — plus
        ``executed_per_s`` computed against the execute wall alone.
        Closed-loop harnesses classically overstate latency and
        understate capacity by folding generator and checker time into
        the measured window (coordinated omission's sibling); splitting
        the walls keeps the throughput figure honest. Pool/disruption
        setup is excluded from all three. The open-loop (Poisson arrival)
        harness, the reference's ``tools/loadharness.py``, is not ported
        yet (ROADMAP.md, Queue 1 step 4b)."""
        state = self.test.initial_state
        undos: list = []
        interval = (
            1.0 / self.params.execution_frequency_hz
            if self.params.execution_frequency_hz else 0.0
        )
        # setup (pool spin-up, disruption bookkeeping) stays outside the
        # timed stages
        pool = ThreadPoolExecutor(max_workers=self.params.parallelism)
        gen_wall = exec_wall = gather_wall = 0.0
        try:
            for generation in range(self.params.generate_count):
                for d in self.disruptions:
                    if d.at_generation == generation:
                        logger.info("injecting disruption %r", d.name)
                        undo = d.apply()
                        if undo:
                            undos.append(undo)
                        with self._metrics_lock:
                            self.metrics["disruptions"] += 1
                t0 = time.monotonic()
                commands = self.test.generate(state, self.params.parallelism)
                # interpret first: expected state is defined by the model,
                # not by what happened to succeed
                for cmd in commands:
                    state = self.test.interpret(state, cmd)
                t1 = time.monotonic()
                gen_wall += t1 - t0
                futures = []
                for cmd in commands:
                    futures.append(pool.submit(self._execute_one, cmd))
                    if interval:
                        time.sleep(interval)
                for f in futures:
                    f.result()
                exec_wall += time.monotonic() - t1
                if (generation + 1) % self.params.gather_frequency == 0:
                    t2 = time.monotonic()
                    self._gather_and_check(state)
                    gather_wall += time.monotonic() - t2
            t2 = time.monotonic()
            self._gather_and_check(state)
            gather_wall += time.monotonic() - t2
        finally:
            for undo in undos:
                try:
                    undo()
                except Exception:
                    logger.exception("disruption undo failed")
            pool.shutdown(wait=True)
        executed = self.metrics["executed"]
        return dict(
            self.metrics,
            final_state=state,
            walls={
                "generate_s": gen_wall,
                "execute_s": exec_wall,
                "gather_s": gather_wall,
                "total_s": gen_wall + exec_wall + gather_wall,
            },
            executed_per_s=(executed / exec_wall) if exec_wall > 0 else 0.0,
        )

    def _execute_one(self, cmd) -> None:
        try:
            self.test.execute(cmd)
            with self._metrics_lock:
                self.metrics["executed"] += 1
        except Exception:
            logger.exception("command execution failed")
            with self._metrics_lock:
                self.metrics["failed"] += 1

    def _gather_and_check(self, expected) -> None:
        observed = self.test.gather()
        with self._metrics_lock:
            self.metrics["gathers"] += 1
        if observed != expected:
            raise LoadTestError(
                f"{self.test.name}: observed state diverged.\n"
                f"  expected: {expected}\n  observed: {observed}"
            )


# ------------------------------------------------- built-in test shapes

def self_issue_test(nodes: dict, notary, amounts=(100, 1000)) -> LoadTest:
    """Every command issues cash on a random node; the model tracks each
    node's expected balance (reference: SelfIssueTest.kt)."""
    from ..finance import CashIssueFlow, CashState

    rng = random.Random(7)
    names = sorted(nodes)

    def generate(state, parallelism):
        return [
            (rng.choice(names), rng.randrange(*amounts))
            for _ in range(parallelism)
        ]

    def interpret(state, cmd):
        name, qty = cmd
        state = dict(state)
        state[name] = state.get(name, 0) + qty
        return state

    def execute(cmd):
        name, qty = cmd
        nodes[name].run_flow(CashIssueFlow(qty, "GBP", b"\x11", notary))

    def gather():
        return {
            name: sum(
                sr.state.data.amount.quantity
                for sr in node.services.vault_service.unconsumed_states(
                    CashState
                )
            )
            for name, node in nodes.items()
        }

    return LoadTest(
        name="SelfIssue",
        generate=generate, interpret=interpret, execute=execute,
        gather=gather, initial_state={},
    )


def notary_service_storm_test(
    service, stxs: list, resolve, chunk: int = 64
) -> LoadTest:
    """Drive a ``BatchedNotaryService``'s async request path at full rate —
    the service-level notary storm (reference: NotaryTest.kt:22-50 floods
    the notary with issue+move pairs; here the pre-built move transactions
    submit through ``service.request`` and the model checks every one
    committed exactly once).

    ``generate`` hands out chunks of pre-built transactions, ``execute``
    fire-and-forgets them into the batching window (throughput comes from
    the service's pipeline, not from injector threads blocking on
    futures), and ``gather`` drains all futures and reads the committed-tx
    count off the uniqueness provider.
    """
    futures: list = []

    def generate(state, parallelism):
        cmds = []
        start = state
        for _ in range(parallelism):
            part = stxs[start : start + chunk]
            if not part:
                break
            cmds.append(part)
            start += len(part)
        return cmds

    def interpret(state, cmd):
        return state + len(cmd)

    def execute(cmd):
        for stx in cmd:
            futures.append(service.request(stx, resolve, "loadtest"))

    def gather():
        for f in list(futures):
            f.result(timeout=120)
        return service.uniqueness.committed_txs()

    return LoadTest(
        name="NotaryServiceStorm",
        generate=generate, interpret=interpret, execute=execute,
        gather=gather, initial_state=0,
    )


def notarisation_storm_test(nodes: dict, notary_party) -> LoadTest:
    """Issue+move pairs through FinalityFlow — the notary-storm shape
    (reference: NotaryTest.kt:22-50). The model counts notarised moves;
    gather reads the notary's committed-state count."""
    from ..finance import CashIssueFlow, CashPaymentFlow

    rng = random.Random(13)
    names = sorted(nodes)

    def generate(state, parallelism):
        out = []
        for _ in range(parallelism):
            a, b = rng.sample(names, 2)
            out.append((a, b, rng.randrange(10, 100)))
        return out

    def interpret(state, cmd):
        return state + 1

    def execute(cmd):
        src, dst, qty = cmd
        nodes[src].run_flow(
            CashIssueFlow(qty, "GBP", b"\x12", notary_party)
        )
        nodes[src].run_flow(
            CashPaymentFlow(qty, "GBP", nodes[dst].party)
        )

    def gather():
        # moves notarised so far == model count (issues skip the notary)
        notary_node = next(
            n for n in nodes.values()
            if n.services.notary_service is not None
        )
        return notary_node.services.notary_service.uniqueness.committed_txs()

    return LoadTest(
        name="NotarisationStorm",
        generate=generate, interpret=interpret, execute=execute,
        gather=gather, initial_state=0,
    )
