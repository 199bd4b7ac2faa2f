"""Developer-facing flow API
(counterpart of corda_tpu/flows/api.py, copied whole).

Parity with the reference's ``FlowLogic`` / ``FlowSession`` / annotations
(core/.../flows/FlowLogic.kt, FlowSession.kt, @InitiatingFlow/@InitiatedBy)
— re-based on deterministic replay (see package docstring) instead of
Quasar fibers. A flow:

    @dataclasses.dataclass
    class PayFlow(FlowLogic):
        counterparty: Party
        amount: int
        def call(self):
            session = self.initiate_flow(self.counterparty)
            session.send(self.amount)
            receipt = session.receive(Receipt).unwrap(lambda r: r)
            return receipt

    @InitiatedBy(PayFlow)
    class PayResponder(FlowLogic):
        def __init__(self, session): self.session = session
        def call(self):
            amount = self.session.receive(int).unwrap(lambda a: a)
            self.session.send(Receipt(amount))

``call()`` must be deterministic given the op-log: wall clocks, randomness
and key generation go through ``self.entropy`` / ``self.record`` so replay
after a crash reproduces the exact same path.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from ..ledger import Party


# FlowException subclasses auto-register so a propagated error re-raises as
# the same type on the counterparty (the reference serializes the actual
# exception object across sessions; we carry "ClassName: message")
_FLOW_EXCEPTION_TYPES: dict[str, type] = {}


class FlowException(Exception):
    """Errors that propagate across sessions to the counterparty
    (reference: core/.../flows/FlowException.kt)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _FLOW_EXCEPTION_TYPES[cls.__name__] = cls


_FLOW_EXCEPTION_TYPES["FlowException"] = FlowException


def rehydrate_flow_exception(message: str) -> FlowException:
    """Rebuild the typed FlowException a counterparty propagated."""
    name, sep, rest = message.partition(": ")
    cls = _FLOW_EXCEPTION_TYPES.get(name)
    if sep and cls is not None:
        return cls(rest)
    return FlowException(message)


class UntrustworthyData:
    """Wrapper forcing explicit validation of peer-supplied data
    (reference: core/.../utilities/UntrustworthyData.kt)."""

    def __init__(self, data):
        self._data = data

    def unwrap(self, validator: Callable[[Any], Any]):
        return validator(self._data)


class ProgressTracker:
    """Hierarchical progress steps streamed to observers (reference:
    core/.../utilities/ProgressTracker.kt — the RPC/shell progress feed)."""

    @dataclasses.dataclass(frozen=True)
    class Step:
        label: str

    def __init__(self, *steps: "ProgressTracker.Step"):
        self.steps = list(steps)
        self.current: ProgressTracker.Step | None = None
        self._observers: list[Callable] = []
        self._children: dict = {}

    def set_current(self, step: "ProgressTracker.Step"):
        self.current = step
        for obs in list(self._observers):
            obs(step)

    def subscribe(self, observer: Callable):
        self._observers.append(observer)

    def set_child(self, step, child: "ProgressTracker"):
        self._children[step] = child
        for obs in self._observers:
            child.subscribe(obs)


def class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def load_class(path: str) -> type:
    mod, _, qual = path.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


# flow_name (initiator class path) -> responder class
_RESPONDERS: dict[str, type] = {}


def InitiatedBy(initiator: "type | str"):
    """Register the decorated class as the responder spawned when a peer
    initiates ``initiator`` against us (reference: @InitiatedBy). The
    responder's constructor receives the opened FlowSession."""

    name = initiator if isinstance(initiator, str) else class_path(initiator)

    def deco(cls):
        _RESPONDERS[name] = cls
        cls._responds_to = name
        return cls

    return deco


def responder_for(flow_name: str) -> type | None:
    return _RESPONDERS.get(flow_name)


class FlowLogic:
    """Base class for flows. Subclasses implement ``call()``; suspending and
    effectful helpers below route through the executor so they are replayed
    deterministically. ``self.services`` (a ServiceHub) and
    ``self.our_identity`` are injected by the state machine manager."""

    _executor = None          # _FlowExecutor, injected
    services = None           # ServiceHub, injected
    our_identity: Party | None = None
    progress_tracker: ProgressTracker | None = None

    # -------------------------------------------------------------- to impl
    def call(self):
        raise NotImplementedError

    # ------------------------------------------------------------ suspending
    def initiate_flow(self, party: Party) -> "FlowSession":
        return self._executor.open_session(self, party)

    def sub_flow(self, flow: "FlowLogic"):
        """Run another flow inline, sharing our op log (reference:
        FlowLogic.subFlow)."""
        flow._executor = self._executor
        flow.services = self.services
        flow.our_identity = self.our_identity
        if self.progress_tracker and flow.progress_tracker:
            self.progress_tracker.set_child(
                self.progress_tracker.current, flow.progress_tracker
            )
        return flow.call()

    def sleep(self, seconds: float) -> None:
        self._executor.op_sleep(seconds)

    def entropy(self, n: int = 32) -> bytes:
        """Recorded randomness — replay-safe."""
        return self._executor.op_entropy(n)

    def record(self, fn: Callable[[], Any], replay: Callable[[Any], Any] | None = None):
        """Run an arbitrary nondeterministic/effectful host function once,
        recording its (CBE-serializable) result for replay.

        ``replay(recorded)`` — when given — runs on every REPLAY of this op
        (crash restore or park/resume) to re-establish host-side state the
        original call created and the unwind may have dropped: vault soft
        locks are the canonical case (a park runs the flow's ``finally``,
        releasing them; the replay hook re-reserves the recorded refs)."""
        return self._executor.op_record(fn, replay)

    def sign_builder(self, builder) -> "Any":
        """Sign a TransactionBuilder replay-safely: the SIGNED transaction
        is a recorded op, so a replay (crash restore or park/resume) yields
        the bit-identical transaction — a re-built one would draw a fresh
        privacy salt and change the id, orphaning signatures already sent.
        Every flow that builds a transaction must sign it through this (or
        wrap the build in ``record``)."""
        return self.record(
            lambda: self.services.sign_initial_transaction(builder)
        )

    def wait_for_ledger_commit(self, tx_id):
        """Suspend until the transaction is recorded locally (reference:
        FlowLogic.waitForLedgerCommit)."""
        return self._executor.op_wait_ledger_commit(tx_id)

    def commit_pin(self) -> None:
        """Mark this flow's point of no return (docs/OVERLOAD.md): a
        durable side effect is about to happen (or may already have
        happened) on another node — notarisation is the canonical case —
        so an end-to-end deadline must no longer abandon the flow.
        Abandoning between the notary's commit and the local vault
        record poisons the spent states: the vault re-selects them and
        every later spend double-spends forever. From the pin on, the
        deadline sheds only at admission/queue doors ahead of the
        commit; the flow itself runs to completion."""
        self._executor.op_commit_pin()

    # ------------------------------------------------------------ metadata
    @property
    def flow_id(self) -> str:
        return self._executor.flow_id

    # serialization of the flow itself (checkpoint identity)
    def flow_fields(self) -> dict:
        if dataclasses.is_dataclass(self):
            return {
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
            }
        raise NotImplementedError(
            f"{type(self).__name__} is not a dataclass: override "
            "flow_fields()/from_flow_fields() for checkpointing"
        )

    @classmethod
    def from_flow_fields(cls, fields: dict) -> "FlowLogic":
        return cls(**fields)


class FlowSession:
    """A channel to one counterparty flow (reference: FlowSession.kt).
    send/receive payloads are CBE-serialized objects."""

    def __init__(self, executor, local_sid: int, counterparty: Party):
        self._executor = executor
        self.local_sid = local_sid
        self.counterparty = counterparty

    def send(self, obj) -> None:
        self._executor.op_send(self.local_sid, obj)

    def receive(self, expected_type: type | None = None) -> UntrustworthyData:
        obj = self._executor.op_receive(self.local_sid)
        if expected_type is not None and not isinstance(obj, expected_type):
            raise FlowException(
                f"expected {expected_type.__name__}, peer sent {type(obj).__name__}"
            )
        return UntrustworthyData(obj)

    def send_and_receive(
        self, expected_type: type | None, obj
    ) -> UntrustworthyData:
        self.send(obj)
        return self.receive(expected_type)

    def close(self) -> None:
        self._executor.op_end_session(self.local_sid, "")

    def __repr__(self):
        return f"FlowSession(sid={self.local_sid}, peer={self.counterparty.name})"
