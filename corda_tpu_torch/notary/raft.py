"""Raft-replicated uniqueness provider (CFT notary cluster; counterpart of
corda_tpu/notary/raft.py, with its names, wire messages and command bytes).

Role parity with the reference's Copycat-based tier
(node/.../services/transactions/RaftUniquenessProvider.kt:4-17 +
DistributedImmutableMap.kt — a replicated put-all-or-report-conflicts map
of consumed states; RaftValidatingNotaryService / RaftNonValidatingNotary-
Service wrap it). Re-implemented from the Raft paper over this framework's
messaging layer (leader election with randomized timeouts, log replication,
majority commit, state-machine apply), because the JVM dependency is the
engine the reference outsources — here it's a first-class component.

The replicated state machine is the uniqueness map: a committed log entry
is a (states, tx_id, caller) commit request; apply() settles it against
the local map, deterministically identical on every replica.

Durability (parity with Copycat's on-disk log + snapshots): with a
``RaftStorage`` attached, term/vote persist before any reply that promises
them, log entries persist before acknowledgement, apply is atomic with the
applied-index marker, and the log COMPACTS against the durable state
machine (which is its own snapshot) — a lagging follower past the
compaction horizon receives the map itself (InstallSnapshot). Without
storage the node is a volatile test replica (full log, no compaction).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError

# Future.result(timeout=) raises concurrent.futures.TimeoutError, which is
# NOT the builtin TimeoutError before Python 3.11 — catching only the
# builtin silently disabled every submit-timeout retry on 3.10 (the
# mid-election resubmit path the chaos soak exercises).
_TIMEOUT_ERRORS = (TimeoutError, FutureTimeoutError)

from ..messaging import auto_ack
from ..serialization import deserialize, serialize

from .raft_storage import RaftStorage
from .uniqueness import (
    InMemoryUniquenessProvider,
    NotaryError,
    UniquenessProvider,
)

T_VOTE = "raft.vote"
T_VOTE_REPLY = "raft.vote-reply"
T_APPEND = "raft.append"
T_APPEND_REPLY = "raft.append-reply"
T_SNAPSHOT = "raft.snapshot"
T_SUBMIT = "raft.submit"
T_SUBMIT_REPLY = "raft.submit-reply"


@dataclasses.dataclass(frozen=True)
class LogEntry:
    term: int
    command: bytes  # serialized (states, tx_id, caller)


class RaftLog:
    """The replicated log with a compacted prefix.

    ``entries[0]`` sits at absolute index ``base``; everything below is
    folded into the state machine (the snapshot). ``snap_term`` is the term
    of entry ``base - 1`` — needed for the AppendEntries consistency check
    at the compaction boundary."""

    __slots__ = ("base", "snap_term", "entries")

    def __init__(self, base: int = 0, snap_term: int = 0, entries=None):
        self.base = base
        self.snap_term = snap_term
        self.entries: list[LogEntry] = list(entries or [])

    def last_index(self) -> int:
        return self.base + len(self.entries) - 1

    def last_term(self) -> int:
        return self.entries[-1].term if self.entries else self.snap_term

    def term_at(self, abs_idx: int) -> int | None:
        """Term of the entry at abs_idx; snap_term at the boundary, None
        for compacted (< base-1) or out-of-range indices."""
        if abs_idx == -1:
            return 0
        if abs_idx == self.base - 1:
            return self.snap_term
        pos = abs_idx - self.base
        if 0 <= pos < len(self.entries):
            return self.entries[pos].term
        return None

    def get(self, abs_idx: int) -> LogEntry:
        return self.entries[abs_idx - self.base]

    def slice_from(self, abs_idx: int) -> list[LogEntry]:
        return self.entries[max(0, abs_idx - self.base):]

    def append(self, e: LogEntry) -> int:
        self.entries.append(e)
        return self.last_index()

    def truncate_from(self, abs_idx: int) -> None:
        del self.entries[abs_idx - self.base:]

    def compact_to(self, abs_idx: int) -> None:
        """Drop entries ≤ abs_idx (must be ≤ applied)."""
        term = self.term_at(abs_idx)
        del self.entries[: abs_idx - self.base + 1]
        self.base = abs_idx + 1
        self.snap_term = term


class NotLeaderError(Exception):
    def __init__(self, leader: str | None):
        self.leader = leader
        super().__init__(f"not leader; known leader: {leader}")


def _retryable_submit_error(e: Exception) -> bool:
    """Leadership churn is retryable, in EVERY wrapping: a direct
    NotLeaderError, a submit timeout, or a "not leader" that travelled as
    a generic error-string reply (older peers / any wrap path). The
    substring contract with _on_submit_reply's error wrap lives here and
    only here."""
    if isinstance(e, (NotLeaderError, *_TIMEOUT_ERRORS)):
        return True
    return "not leader" in str(e)


class RaftNode:
    """One Raft replica. ``apply_fn(command_bytes, abs_index) ->
    result_bytes`` is the deterministic state machine."""

    FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

    def __init__(
        self, name: str, peers: list[str], messaging, apply_fn,
        election_timeout_s: tuple[float, float] = (0.15, 0.3),
        heartbeat_s: float = 0.05,
        rng: random.Random | None = None,
        storage: RaftStorage | None = None,
        compact_every: int = 512,
        install_map_fn=None,
    ):
        self.name = name
        self.peers = [p for p in peers if p != name]
        self._messaging = messaging
        self._apply_fn = apply_fn
        self._timeout_range = election_timeout_s
        self._heartbeat_s = heartbeat_s
        self._rng = rng or random.Random(name)
        self._storage = storage
        self._compact_every = compact_every
        self._install_map_fn = install_map_fn

        self._lock = threading.RLock()
        self.role = RaftNode.FOLLOWER
        # bounded election-storm backoff: each consecutive election that
        # fails to produce a leader doubles the next timeout draw (cap
        # ELECTION_BACKOFF_CAP×); hearing from a real leader resets it.
        # Under a partition or heavy message loss this stops the cluster
        # burning terms (and bandwidth) at the base cadence, and spreads
        # candidacies so the first heal round elects instead of splitting.
        self._elections_since_leader = 0
        self.current_term = 0
        self.voted_for: str | None = None
        self.log = RaftLog()
        self.commit_index = -1
        self.last_applied = -1
        self.leader: str | None = None
        if storage is not None:
            # restart: resume with the persisted term/vote/log; everything
            # at or below the applied marker is already in the state machine
            st = storage.load()
            self.current_term = st["term"]
            self.voted_for = st["voted_for"]
            self.log = RaftLog(
                st["base"], st["snap_term"],
                [LogEntry(t, c) for (t, c) in st["entries"]],
            )
            self.last_applied = st["applied"]
            self.commit_index = st["applied"]
        # leader volatile state
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._votes: set[str] = set()
        # client futures waiting on an index we proposed; the entry object
        # is kept alongside so a truncate-and-replace at the same index
        # after a leadership change fails the waiter instead of handing it
        # another command's result
        self._waiters: dict[int, tuple[LogEntry, Future]] = {}
        # remote submissions we're waiting on, by correlation id
        self._pending_remote: dict[str, Future] = {}
        self._corr = 0

        self._deadline = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        for topic, handler in (
            (T_VOTE, self._on_vote), (T_VOTE_REPLY, self._on_vote_reply),
            (T_APPEND, self._on_append), (T_APPEND_REPLY, self._on_append_reply),
            (T_SNAPSHOT, self._on_snapshot),
            (T_SUBMIT, self._on_submit),
            (T_SUBMIT_REPLY, self._on_submit_reply),
        ):
            messaging.add_handler(topic, auto_ack(handler))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        with self._lock:
            self._reset_timer_locked()
        self._thread = threading.Thread(
            target=self._tick_loop, daemon=True, name=f"raft-{self.name}"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    ELECTION_BACKOFF_CAP = 8.0

    def _election_backoff(self) -> float:
        # cap the EXPONENT, not just the result: the counter grows without
        # bound during a long partition and 2.0**1024 overflows, which
        # would kill the tick thread
        return min(2.0 ** min(self._elections_since_leader, 6),
                   RaftNode.ELECTION_BACKOFF_CAP)

    def _reset_timer_locked(self) -> None:
        self._deadline = time.monotonic() + (
            self._rng.uniform(*self._timeout_range) * self._election_backoff()
        )

    def _tick_loop(self) -> None:
        while not self._stop.wait(0.01):
            with self._lock:
                now = time.monotonic()
                if self.role == RaftNode.LEADER:
                    if now >= self._deadline:
                        self._deadline = now + self._heartbeat_s
                        self._broadcast_append()
                elif now >= self._deadline:
                    self._start_election_locked()

    def _persist_term_vote(self) -> None:
        """Raft's persistence contract: term/vote are on disk BEFORE any
        message promising them leaves this replica."""
        if self._storage is not None:
            self._storage.save_term_vote(self.current_term, self.voted_for)

    # ------------------------------------------------------------ election

    def _start_election_locked(self) -> None:
        self.role = RaftNode.CANDIDATE
        self._elections_since_leader += 1
        self.current_term += 1
        self.voted_for = self.name
        self._persist_term_vote()
        self._votes = {self.name}
        self.leader = None
        self._reset_timer_locked()
        req = {"term": self.current_term, "candidate": self.name,
               "last_log_index": self.log.last_index(),
               "last_log_term": self.log.last_term()}
        for p in self.peers:
            self._messaging.send(p, T_VOTE, serialize(req))
        self._maybe_win_locked()  # single-node cluster wins immediately

    def _on_vote(self, msg) -> None:
        req = deserialize(msg.payload)
        with self._lock:
            self._observe_term_locked(req["term"])
            grant = False
            if req["term"] >= self.current_term and self.voted_for in (None, req["candidate"]):
                up_to_date = (req["last_log_term"], req["last_log_index"]) >= (
                    self.log.last_term(), self.log.last_index(),
                )
                if up_to_date:
                    grant = True
                    self.voted_for = req["candidate"]
                    self._persist_term_vote()
                    self._reset_timer_locked()
            self._messaging.send(
                msg.sender, T_VOTE_REPLY,
                serialize({"term": self.current_term, "granted": grant,
                           "voter": self.name}),
            )

    def _on_vote_reply(self, msg) -> None:
        rep = deserialize(msg.payload)
        with self._lock:
            self._observe_term_locked(rep["term"])
            if self.role != RaftNode.CANDIDATE or rep["term"] != self.current_term:
                return
            if rep["granted"]:
                self._votes.add(rep["voter"])
                self._maybe_win_locked()

    def _maybe_win_locked(self) -> None:
        if self.role == RaftNode.CANDIDATE and len(self._votes) * 2 > len(self.peers) + 1:
            self.role = RaftNode.LEADER
            self.leader = self.name
            self._elections_since_leader = 0
            n = self.log.last_index() + 1
            self._next_index = {p: n for p in self.peers}
            self._match_index = {p: -1 for p in self.peers}
            self._deadline = 0.0  # heartbeat immediately
            self._broadcast_append()

    def _observe_term_locked(self, term: int) -> None:
        if term > self.current_term:
            self.current_term = term
            self.role = RaftNode.FOLLOWER
            self.voted_for = None
            self._votes = set()
            self._persist_term_vote()

    # ------------------------------------------------------------ replication

    def _broadcast_append(self) -> None:
        for p in self.peers:
            self._send_append(p)

    def _send_append(self, peer: str) -> None:
        nxt = self._next_index.get(peer, self.log.last_index() + 1)
        if nxt < self.log.base:
            # the entries this follower needs are compacted: ship the state
            # machine itself (InstallSnapshot)
            self._send_snapshot(peer)
            return
        prev_idx = nxt - 1
        prev_term = self.log.term_at(prev_idx) or 0
        entries = [(e.term, e.command) for e in self.log.slice_from(nxt)]
        req = {
            "term": self.current_term, "leader": self.name,
            "prev_log_index": prev_idx, "prev_log_term": prev_term,
            "entries": entries, "leader_commit": self.commit_index,
        }
        self._messaging.send(peer, T_APPEND, serialize(req))

    def _send_snapshot(self, peer: str) -> None:
        assert self._storage is not None, "compaction requires storage"
        req = {
            "term": self.current_term, "leader": self.name,
            "last_idx": self.log.base - 1, "last_term": self.log.snap_term,
            "rows": self._storage.dump_map(),
        }
        self._messaging.send(peer, T_SNAPSHOT, serialize(req))

    def _on_snapshot(self, msg) -> None:
        req = deserialize(msg.payload)
        with self._lock:
            self._observe_term_locked(req["term"])
            if req["term"] != self.current_term:
                return
            installer = (
                self._storage.install_snapshot
                if self._storage is not None
                else self._install_map_fn
            )
            if installer is None:
                # no way to apply a snapshot on this replica: say so (a
                # silent drop would have the leader re-shipping the map
                # every heartbeat forever)
                self._messaging.send(
                    msg.sender, T_APPEND_REPLY,
                    serialize({"term": self.current_term, "ok": False,
                               "follower": self.name, "match_index": -1}),
                )
                return
            self.role = RaftNode.FOLLOWER
            self.leader = req["leader"]
            self._elections_since_leader = 0
            self._reset_timer_locked()
            last_idx = req["last_idx"]
            if last_idx > self.last_applied:
                installer(req["rows"], last_idx, req["last_term"])
                self.log = RaftLog(last_idx + 1, req["last_term"])
                self.last_applied = last_idx
                self.commit_index = max(self.commit_index, last_idx)
            self._messaging.send(
                msg.sender, T_APPEND_REPLY,
                serialize({"term": self.current_term, "ok": True,
                           "follower": self.name,
                           "match_index": max(last_idx, self.last_applied)}),
            )

    def _on_append(self, msg) -> None:
        req = deserialize(msg.payload)
        with self._lock:
            self._observe_term_locked(req["term"])
            ok = False
            match_index = -1
            if req["term"] == self.current_term:
                self.role = RaftNode.FOLLOWER
                self.leader = req["leader"]
                self._elections_since_leader = 0  # live leader: no storm
                self._reset_timer_locked()
                prev_idx = req["prev_log_index"]
                entries = req["entries"]
                if prev_idx < self.log.base - 1:
                    # our snapshot already covers a prefix of these
                    # entries; everything ≤ base-1 is committed+applied, so
                    # it matches any legitimate leader's log by Raft safety
                    skip = (self.log.base - 1) - prev_idx
                    entries = entries[skip:]
                    prev_idx = self.log.base - 1
                    prev_ok = True
                else:
                    prev_term = self.log.term_at(prev_idx)
                    prev_ok = prev_term is not None and prev_term == req["prev_log_term"]
                if prev_ok:
                    ok = True
                    idx = prev_idx + 1
                    first_change: int | None = None
                    for term, cmd in entries:
                        have = self.log.term_at(idx)
                        if have is not None and have != term:
                            self.log.truncate_from(idx)
                            self._fail_waiters_from_locked(idx)
                            have = None
                        if have is None and idx > self.log.last_index():
                            self.log.append(LogEntry(term, cmd))
                            if first_change is None:
                                first_change = idx
                        idx += 1
                    if first_change is not None and self._storage is not None:
                        # persist the changed suffix BEFORE acknowledging
                        self._storage.replace_suffix(
                            first_change,
                            [(e.term, e.command)
                             for e in self.log.slice_from(first_change)],
                        )
                    match_index = prev_idx + len(entries)
                    if req["leader_commit"] > self.commit_index:
                        self.commit_index = min(
                            req["leader_commit"], self.log.last_index()
                        )
                        self._apply_committed_locked()
            self._messaging.send(
                msg.sender, T_APPEND_REPLY,
                serialize({"term": self.current_term, "ok": ok,
                           "follower": self.name, "match_index": match_index}),
            )

    def _on_append_reply(self, msg) -> None:
        rep = deserialize(msg.payload)
        with self._lock:
            self._observe_term_locked(rep["term"])
            if self.role != RaftNode.LEADER or rep["term"] != self.current_term:
                return
            p = rep["follower"]
            if rep["ok"]:
                self._match_index[p] = max(self._match_index.get(p, -1),
                                           rep["match_index"])
                self._next_index[p] = self._match_index[p] + 1
                self._advance_commit_locked()
            else:
                self._next_index[p] = max(0, self._next_index.get(p, 1) - 1)
                self._send_append(p)

    def _advance_commit_locked(self) -> None:
        n = len(self.peers) + 1
        for idx in range(self.log.last_index(), self.commit_index, -1):
            if self.log.term_at(idx) != self.current_term:
                continue
            votes = 1 + sum(1 for p in self.peers if self._match_index.get(p, -1) >= idx)
            if votes * 2 > n:
                self.commit_index = idx
                self._apply_committed_locked()
                break

    def _fail_waiters_from_locked(self, idx: int) -> None:
        """A truncation invalidated every proposal at >= idx."""
        for i in [i for i in self._waiters if i >= idx]:
            _entry, fut = self._waiters.pop(i)
            if not fut.done():
                fut.set_exception(NotLeaderError(self.leader))

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self.log.get(self.last_applied)
            result = self._apply_fn(entry.command, self.last_applied)
            waiter = self._waiters.pop(self.last_applied, None)
            if waiter is not None:
                proposed, fut = waiter
                if fut.done():
                    pass
                elif proposed is entry:
                    fut.set_result(result)
                else:  # a different command landed at our index
                    fut.set_exception(NotLeaderError(self.leader))
        if (
            self._storage is not None
            and self.last_applied - self.log.base + 1 >= self._compact_every
        ):
            term = self.log.term_at(self.last_applied)
            self._storage.compact(self.last_applied, term)
            self.log.compact_to(self.last_applied)

    # ------------------------------------------------------------ client API

    def submit(self, command: bytes) -> Future:
        """Leader-only: append + replicate; future completes with the
        state-machine apply result once committed."""
        with self._lock:
            if self.role != RaftNode.LEADER:
                raise NotLeaderError(self.leader)
            entry = LogEntry(self.current_term, command)
            idx = self.log.append(entry)
            if self._storage is not None:
                # the leader's own log write must be durable before it can
                # count toward the majority
                self._storage.append(idx, entry.term, entry.command)
            fut: Future = Future()
            self._waiters[idx] = (entry, fut)
            if not self.peers:  # single-node cluster commits immediately
                self.commit_index = idx
                self._apply_committed_locked()
            else:
                self._broadcast_append()
            return fut

    def _on_submit(self, msg) -> None:
        """Remote client submission (any replica accepts; forwards result
        or redirect)."""
        req = deserialize(msg.payload)
        with self._lock:
            is_leader = self.role == RaftNode.LEADER
            leader = self.leader
        if not is_leader:
            self._messaging.send(
                msg.sender, T_SUBMIT_REPLY,
                serialize({"corr": req["corr"], "redirect": leader}),
            )
            return
        try:
            fut = self.submit(req["command"])
        except NotLeaderError as e:
            # lost leadership between the check above and the append (a
            # mid-election race): answer with a REDIRECT, not a generic
            # error — clients treat redirects as retryable, while an
            # error string would propagate as a terminal NotaryError)
            self._messaging.send(
                msg.sender, T_SUBMIT_REPLY,
                serialize({"corr": req["corr"], "redirect": e.leader}),
            )
            return

        def done(f, corr=req["corr"], sender=msg.sender):
            try:
                self._messaging.send(
                    sender, T_SUBMIT_REPLY,
                    serialize({"corr": corr, "result": f.result()}),
                )
            except NotLeaderError as e:
                # the entry was displaced by a leadership change while
                # replicating — retryable: redirect, don't error
                self._messaging.send(
                    sender, T_SUBMIT_REPLY,
                    serialize({"corr": corr, "redirect": e.leader}),
                )
            except Exception as e:
                self._messaging.send(
                    sender, T_SUBMIT_REPLY,
                    serialize({"corr": corr, "error": str(e)}),
                )

        fut.add_done_callback(done)

    def _on_submit_reply(self, msg) -> None:
        rep = deserialize(msg.payload)
        with self._lock:
            fut = self._pending_remote.pop(rep["corr"], None)
        if fut is None or fut.done():
            return
        if "result" in rep:
            fut.set_result(rep["result"])
        elif "redirect" in rep:
            fut.set_exception(NotLeaderError(rep["redirect"]))
        else:
            fut.set_exception(NotaryError(rep.get("error", "submit failed")))

    def submit_anywhere(self, command: bytes) -> Future:
        """Submit locally when leader, else forward to the known leader (or
        probe a peer) over messaging — the CopycatClient role."""
        with self._lock:
            if self.role == RaftNode.LEADER:
                return self.submit(command)
            target = self.leader
            if target is None and self.peers:
                target = self.peers[self._corr % len(self.peers)]
            self._corr += 1
            corr = f"{self.name}-{self._corr}"
            fut: Future = Future()
            self._pending_remote[corr] = fut
        if target is None:
            fut.set_exception(NotLeaderError(None))
            return fut
        self._messaging.send(
            target, T_SUBMIT, serialize({"corr": corr, "command": command})
        )
        return fut


class RaftUniquenessProvider(UniquenessProvider):
    """UniquenessProvider face over a RaftNode whose state machine is a
    local uniqueness map (reference: RaftUniquenessProvider +
    DistributedImmutableMap). Use ``RaftUniquenessProvider.make_cluster``
    to build co-located replicas for tests/demos; pass ``storage_dir`` for
    durable replicas that survive full-cluster restarts."""

    def __init__(self, node: RaftNode):
        self.node = node
        # retry window covers one election cycle
        self._retry_s = 2.0
        # leader-change retries back off exponentially with jitter —
        # fixed-cadence retries from many clients re-synchronized into
        # the same election window are their own little storm. Seeded by
        # replica name so chaos runs reproduce.
        from ..messaging.retry import RetryPolicy

        self._retry_policy = RetryPolicy(
            base_s=0.02, multiplier=2.0, max_backoff_s=0.4, jitter=0.5
        )
        self._retry_rng = random.Random(f"retry:{node.name}")

    @staticmethod
    def state_machine(base: UniquenessProvider | None = None):
        """Volatile state machine over an in-memory uniqueness map.

        Commands come in two shapes: a single (states, tx_id, caller)
        request, or ``("batch", [request, ...])`` — one log entry settling
        a whole notary window (apply order is the log order on every
        replica, so batch results are deterministic)."""
        base = base or InMemoryUniquenessProvider()

        def apply(command: bytes, _abs_idx: int) -> bytes:
            cmd = deserialize(command)
            if cmd[0] == "batch":
                return serialize(base.commit_batch(
                    [(s, t, c) for s, t, c in cmd[1]]
                ))
            states, tx_id, caller = cmd
            try:
                base.commit(states, tx_id, caller)
                return serialize(None)
            except NotaryError as e:
                return serialize(e.conflict)

        return apply, base

    @staticmethod
    def storage_state_machine(storage: RaftStorage):
        """Durable state machine: apply lands in the same transaction as
        the applied-index marker (exactly-once across restarts)."""

        def apply(command: bytes, abs_idx: int) -> bytes:
            cmd = deserialize(command)
            if cmd[0] == "batch":
                return serialize(storage.apply_commit_batch(
                    abs_idx, [(list(s), t, c) for s, t, c in cmd[1]]
                ))
            states, tx_id, caller = cmd
            return serialize(
                storage.apply_commit(abs_idx, list(states), tx_id, caller)
            )

        return apply

    def _submit_retrying(self, command: bytes):
        """Submit through whichever replica currently leads, riding out one
        election cycle; re-submission after an ambiguous timeout is safe —
        the state machine is idempotent per tx_id. Retries back off
        exponentially with jitter under the overall ``_retry_s`` deadline
        (the propagated budget — no attempt outlives it)."""
        from ..flows.overload import active_overload, remaining_deadline

        budget = self._retry_s
        rem = remaining_deadline()
        if rem is not None:
            # the propagated end-to-end deadline tightens the submit
            # budget: a consensus round for a dead flow is wasted work
            # (docs/OVERLOAD.md). Small floor so an on-the-edge submit
            # fails with a timeout, not a zero-wait raise.
            budget = min(budget, max(0.05, rem))
        deadline = time.monotonic() + budget
        ov = active_overload()
        edge = str(getattr(self.node, "name", "raft"))
        if ov is not None:
            ov.note_send("raft.submit", edge)
        attempt = 0
        while True:
            try:
                fut = self.node.submit_anywhere(command)
                remaining = max(0.05, deadline - time.monotonic())
                return deserialize(
                    fut.result(timeout=min(self._retry_s, remaining))
                )
            except (NotLeaderError, *_TIMEOUT_ERRORS, NotaryError) as e:
                if not _retryable_submit_error(e):
                    raise
                if time.monotonic() > deadline:
                    raise
                if ov is not None and not ov.allow_retry("raft.submit", edge):
                    # retry budget exhausted (token bucket per layer+edge,
                    # docs/OVERLOAD.md): under a submit storm, resubmits
                    # must stay a bounded fraction of fresh submits
                    raise NotaryError(
                        "raft submit retry budget exhausted"
                    ) from e
                pause = self._retry_policy.backoff_s(attempt, self._retry_rng)
                attempt += 1
                time.sleep(min(pause, max(0.0, deadline - time.monotonic())))

    def commit(self, states, tx_id, caller_name) -> None:
        result = self._submit_retrying(
            serialize((list(states), tx_id, caller_name))
        )
        if result is not None:
            raise NotaryError(
                f"input states of {tx_id} already consumed", result
            )

    def commit_batch(self, requests):
        """N requests, ONE consensus round: the whole batch travels as one
        log entry and settles in one state-machine apply (the base-class
        loop would be one full Raft round per transaction;
        DistributedImmutableMap.putAll batches per tx, this batches per
        notary window)."""
        return self.commit_batch_async(requests).collect()

    def commit_batch_async(self, requests):
        """Put the window's consensus round IN FLIGHT and return. The log
        entry is appended and replicating while the caller settles other
        windows — consecutive windows' entries pipeline through the same
        AppendEntries stream (the leader batches outstanding entries per
        send), so replication latency overlaps device verification instead
        of serializing after it.
        ``collect()`` falls back to the retrying sync path on leader
        change — safe, the state machine is idempotent per tx_id."""
        from .uniqueness import PendingCommit

        if not requests:
            return PendingCommit([])
        command = serialize(
            ("batch", [(list(s), t, c) for (s, t, c) in requests])
        )
        try:
            fut = self.node.submit_anywhere(command)
        except NotLeaderError:
            fut = None
        provider = self

        class _PendingRaftCommit:
            def collect(_self):
                if fut is not None:
                    try:
                        return list(deserialize(
                            fut.result(timeout=provider._retry_s)
                        ))
                    except (NotLeaderError, *_TIMEOUT_ERRORS, NotaryError) as e:
                        if not _retryable_submit_error(e):
                            raise
                return list(provider._submit_retrying(command))

        return _PendingRaftCommit()

    @staticmethod
    def _state_machine_parts(storage_path: str | None):
        """(storage, apply_fn, install_fn) for one replica: durable when a
        storage path is given, else the in-memory map with a snapshot-
        install hook (a durable peer compacted past this replica's log
        replaces the map wholesale). Shared by every construction path —
        co-located clusters and node-embedded replicas must run identical
        state-machine wiring."""
        if storage_path is not None:
            storage = RaftStorage(storage_path)
            return (
                storage,
                RaftUniquenessProvider.storage_state_machine(storage),
                None,
            )
        apply_fn, base = RaftUniquenessProvider.state_machine()

        def install_fn(rows, _last_idx, _last_term, base=base):
            from ..crypto import SecureHash

            from .uniqueness import ConsumedStateDetails

            with base._lock:
                base._map = {
                    bytes(k): ConsumedStateDetails(
                        SecureHash(bytes(t)), i, c
                    )
                    for (k, t, i, c) in rows
                }

        return None, apply_fn, install_fn

    @staticmethod
    def make_node(
        name: str, names: list[str], network, storage_dir: str | None = None,
        compact_every: int = 512,
    ) -> "RaftUniquenessProvider":
        """Build (or REBUILD after a crash — state restores from storage)
        one replica."""
        storage, apply_fn, install_fn = (
            RaftUniquenessProvider._state_machine_parts(
                f"{storage_dir}/{name}.db" if storage_dir else None
            )
        )
        node = RaftNode(
            name, list(names), network.create_node(name), apply_fn,
            storage=storage, compact_every=compact_every,
            install_map_fn=install_fn,
        )
        return RaftUniquenessProvider(node)

    def close(self) -> None:
        self.node.stop()

    @staticmethod
    def make_node_on_endpoint(
        name: str, names: list[str], endpoint,
        storage_path: str | None = None, compact_every: int = 512,
        election_timeout_s: tuple[float, float] = (1.0, 2.0),
        heartbeat_s: float = 0.25,
    ) -> "RaftUniquenessProvider":
        """One replica sharing an EXISTING messaging endpoint — the
        multi-process cluster shape, each replica inside its own node
        process talking ``raft.*`` topics over the node fabric (the
        reference runs its Copycat cluster out-of-process over dedicated
        ports, NodeConfiguration.kt:45). Raft traffic coexists with
        session traffic because topics are dispatched independently.
        Default timings are scaled for the polled file broker's ~0.5 s
        worst-case delivery (failover ≈ one election cycle ≈ 2-3 s);
        co-located in-memory clusters keep ``make_cluster``'s fast
        timings. The caller owns start/stop (``provider.node.start()`` /
        ``provider.close()``)."""
        storage, apply_fn, install_fn = (
            RaftUniquenessProvider._state_machine_parts(storage_path)
        )
        node = RaftNode(
            name, list(names), endpoint, apply_fn,
            election_timeout_s=election_timeout_s, heartbeat_s=heartbeat_s,
            storage=storage, compact_every=compact_every,
            install_map_fn=install_fn,
        )
        provider = RaftUniquenessProvider(node)
        # the submit retry window must ride out one full (slowed-down)
        # election cycle, or a mid-failover commit would surface as a
        # notary error instead of completing on the new leader
        provider._retry_s = max(2.0, 3.0 * election_timeout_s[1])
        return provider

    @staticmethod
    def make_cluster(
        names: list[str], network, storage_dir: str | None = None,
        compact_every: int = 512,
    ) -> "list[RaftUniquenessProvider]":
        """Co-located cluster over an InMemoryMessagingNetwork (the
        reference's cluster-of-3-in-one-JVM driver test shape)."""
        providers = [
            RaftUniquenessProvider.make_node(
                name, names, network, storage_dir, compact_every
            )
            for name in names
        ]
        for p in providers:
            p.node.start()
        return providers
