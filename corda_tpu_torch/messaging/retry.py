"""Retry policy: exponential backoff with jitter and a hard deadline
(counterpart of corda_tpu/messaging/retry.py, copied whole).

One shared primitive for every layer that retries over an unreliable
medium — flow-session retransmission (flows/engine.py) and
notary-cluster submission (notary/raft.py); the fabric's reconnect loop
keeps its own two-knob config for constructor-compatibility but follows
the same jittered-exponential shape. The deadline is the
propagated budget: a caller that has already burned part of its budget
passes the *remaining* deadline down, so nested retries never outlive the
operation that contains them (the reference leans on Artemis redelivery +
flow hospital timers for the same effect)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule: attempt n sleeps ``min(base * multiplier**n,
    max_backoff)`` scaled by ``1 + jitter * u`` with u drawn from the
    caller's RNG (callers seed it for reproducible chaos runs).
    ``deadline_s`` bounds the whole retry window from first attempt."""

    base_s: float = 0.1
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25
    deadline_s: float = 60.0

    def backoff_s(self, attempt: int, rng=None) -> float:
        raw = min(
            self.base_s * (self.multiplier ** max(0, attempt)),
            self.max_backoff_s,
        )
        if rng is not None and self.jitter:
            raw *= 1.0 + self.jitter * rng.random()
        return raw

    def with_deadline(self, deadline_s: float) -> "RetryPolicy":
        """Propagate a tighter remaining budget (never a looser one)."""
        return dataclasses.replace(
            self, deadline_s=min(self.deadline_s, deadline_s)
        )
