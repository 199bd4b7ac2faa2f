"""Session wire messages
(counterpart of corda_tpu/flows/sessions.py, copied whole).

Parity with the reference's SessionMessage hierarchy
(node/.../services/statemachine/SessionMessage.kt via
StateMachineManager.kt:288-353): Init opens a session against a registered
responder flow, Confirm/Reject answer it, Data carries CBE payloads, End
closes. All travel topic ``platform.session`` on the messaging layer.
"""

from __future__ import annotations

import dataclasses

from ..serialization import register_custom

SESSION_TOPIC = "platform.session"


@dataclasses.dataclass(frozen=True)
class SessionInit:
    initiator_session_id: int
    flow_name: str            # registered initiating flow name
    first_payload: bytes      # optional piggybacked first send (b"" if none)
    # trace propagation (docs/OBSERVABILITY.md): "<trace_id>:<span_id>" of
    # the initiating flow's active span, "" when the flow is unsampled —
    # the responder parents its own flow span under this context, so one
    # trace spans initiator, notary, and broadcast recipients. Carried on
    # Init only: Data/End ride an established session whose responder
    # already joined the trace.
    trace: str = ""
    # end-to-end deadline propagation (docs/OVERLOAD.md): absolute
    # wall-clock epoch seconds by which the initiating flow's caller
    # stops caring, 0.0 when none. Wall-clock on purpose — the deadline
    # crosses nodes, and monotonic clocks do not travel. The responder
    # binds it so ITS downstream submits (serving, notary) shed work
    # that is already dead. Carried on Init only, like trace.
    deadline: float = 0.0


@dataclasses.dataclass(frozen=True)
class SessionConfirm:
    initiator_session_id: int
    responder_session_id: int


@dataclasses.dataclass(frozen=True)
class SessionReject:
    initiator_session_id: int
    error: str


@dataclasses.dataclass(frozen=True)
class SessionData:
    recipient_session_id: int
    payload: bytes
    # per-session delivery order (docs/OVERLOAD.md): 1-based position of
    # this message among everything the peer flow sent on this session,
    # 0 = unsequenced (pre-sequencing peer). The receiver delivers
    # sequenced messages strictly in order, parking gaps until the
    # retransmit fills them — without it, a delayed/dropped Data can be
    # overtaken by a later Data (protocol desync) or by the SessionEnd
    # (the flow dies on "peer ended session" while the payload it needed
    # is still in flight — fatal after a notary commit).
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class SessionEnd:
    recipient_session_id: int
    error: str                # "" = normal end
    seq: int = 0              # ordered after every Data (see SessionData)


@dataclasses.dataclass(frozen=True)
class SessionAck:
    """Session-level delivery acknowledgement for Data/End messages,
    carrying the LOGICAL message id (the deterministic flow-op id, with
    any retransmission suffix stripped). The sender's retransmit buffer
    drops the entry on receipt; dedupe on both ends makes the
    retransmit/ack exchange idempotent, so flows make progress over a
    transport that drops, duplicates, or reorders (fault-injection
    hardening — the reference leans on Artemis durability for this)."""

    msg_id: str


register_custom(
    SessionInit, "flows.SessionInit",
    # deadline is omitted when unset so flows without one (and nodes
    # with overload protection off) put zero extra bytes on the wire
    to_fields=lambda m: {
        "sid": m.initiator_session_id, "flow": m.flow_name,
        "first": m.first_payload, "trace": m.trace,
        **({"deadline": m.deadline} if m.deadline else {}),
    },
    # .get: Inits serialized before the trace/deadline fields existed
    # decode fine
    from_fields=lambda d: SessionInit(
        d["sid"], d["flow"], d["first"], d.get("trace", ""),
        d.get("deadline", 0.0),
    ),
)
register_custom(
    SessionConfirm, "flows.SessionConfirm",
    to_fields=lambda m: {
        "isid": m.initiator_session_id, "rsid": m.responder_session_id,
    },
    from_fields=lambda d: SessionConfirm(d["isid"], d["rsid"]),
)
register_custom(
    SessionReject, "flows.SessionReject",
    to_fields=lambda m: {"sid": m.initiator_session_id, "error": m.error},
    from_fields=lambda d: SessionReject(d["sid"], d["error"]),
)
register_custom(
    SessionData, "flows.SessionData",
    # seq omitted when 0 so unsequenced senders (and pre-sequencing
    # captures) keep their exact byte shape; .get on decode for the
    # same reason
    to_fields=lambda m: {
        "sid": m.recipient_session_id, "payload": m.payload,
        **({"seq": m.seq} if m.seq else {}),
    },
    from_fields=lambda d: SessionData(
        d["sid"], d["payload"], d.get("seq", 0)
    ),
)
register_custom(
    SessionEnd, "flows.SessionEnd",
    to_fields=lambda m: {
        "sid": m.recipient_session_id, "error": m.error,
        **({"seq": m.seq} if m.seq else {}),
    },
    from_fields=lambda d: SessionEnd(d["sid"], d["error"], d.get("seq", 0)),
)
register_custom(
    SessionAck, "flows.SessionAck",
    to_fields=lambda m: {"msg_id": m.msg_id},
    from_fields=lambda d: SessionAck(d["msg_id"]),
)
