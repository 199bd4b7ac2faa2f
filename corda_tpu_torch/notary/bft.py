"""BFT-replicated uniqueness (Byzantine fault-tolerant notary cluster;
counterpart of corda_tpu/notary/bft.py, with its names, wire messages,
reply and share bytes).

Role parity with the reference's BFT-SMaRt tier
(node/.../services/transactions/BFTSMaRt.kt:55+ — ``Client`` does
total-order submission and gathers signed replica replies;
``BFTNonValidatingNotaryService.Replica.executeCommand`` verifies and
commits, replying with a per-replica signature over the outcome; the client
accepts on a cluster signature quorum). The consensus engine the reference
outsources to the BFT-SMaRt jar is implemented here as PBFT-style
three-phase total-order broadcast (pre-prepare / prepare / commit with
2f+1 quorums over n = 3f+1 replicas) on this framework's messaging layer.

View changes (liveness under primary failure — BFT-SMaRt's leader-change
regency protocol): primary of view v is ``names[v % n]``. A replica whose
pending requests stall past the suspicion timeout broadcasts a SIGNED
VIEW-CHANGE carrying its prepared certificates; replicas join a view
change once f+1 peers demand one (so a single faulty replica cannot force
view churn); the new primary installs the view with a NEW-VIEW containing
2f+1 signed view-change messages and re-proposes every prepared entry —
by quorum intersection any entry committed at an honest replica appears in
at least one certificate of any 2f+1 set, so committed state is never
lost. Unordered pending requests are re-proposed by the new primary (the
client broadcasts every request to all replicas), restoring liveness.

Trust model note: phase messages ride authenticated channels (the
transport identifies senders); VIEW-CHANGE/NEW-VIEW are additionally
signed with the replica keys, so a new-view certificate is
non-repudiable. Prepare certificates inside a view-change are the
collector's claim (MAC-PBFT posture) — sufficient for crash faults and
for Byzantine replicas that cannot forge channel identities.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError

from ..crypto import (
    KeyPair,
    PublicKey,
    sign as host_sign,
    is_valid as host_verify,
)
from ..messaging import auto_ack
from ..serialization import deserialize, serialize

from .uniqueness import (
    InMemoryUniquenessProvider,
    NotaryError,
    UniquenessProvider,
)

T_REQUEST = "bft.request"
T_PREPREPARE = "bft.preprepare"
T_PREPARE = "bft.prepare"
T_COMMIT = "bft.commit"
T_REPLY = "bft.reply"
T_VIEWCHANGE = "bft.viewchange"
T_NEWVIEW = "bft.newview"

_NULL_DIGEST = b""  # gap-filling no-op slot installed by a new view


def _digest(command: bytes) -> bytes:
    import hashlib

    return hashlib.sha256(command).digest()


class BFTReplica:
    """One PBFT replica executing a deterministic uniqueness state machine.

    ``names`` fixes the cluster membership; the view rotates the primary
    over it. f = (n - 1) // 3 replicas may be faulty.
    """

    def __init__(self, name: str, names: list[str], messaging, keypair: KeyPair,
                 base: UniquenessProvider | None = None,
                 replica_keys: dict[str, PublicKey] | None = None,
                 view_timeout_s: float = 1.0,
                 bls_keypair: tuple[bytes, bytes] | None = None):
        self.name = name
        self.names = list(names)
        self.n = len(names)
        self.f = (self.n - 1) // 3
        self._messaging = messaging
        self._keypair = keypair
        # optional (public 48B, private 32B) BLS share key: when present,
        # every reply additionally carries a BLS12-381 signature share
        # over the outcome so the client can settle the round with ONE
        # aggregate quorum certificate (docs/BATCH_VERIFY.md). The
        # ed25519 reply signature stays — it is the per-reply
        # authenticity check and the QC-less fallback.
        self._bls_keypair = bls_keypair
        self._replica_keys = dict(replica_keys or {})
        self.base = base or InMemoryUniquenessProvider()
        self._lock = threading.RLock()
        self.view = 0
        self._seq = 0                     # primary: next sequence number
        self._commands: dict[bytes, bytes] = {}   # digest -> command
        self._client_of: dict[bytes, str] = {}    # digest -> requesting client
        # (view, seq) -> digest accepted from that view's primary
        self._preprepared: dict[tuple[int, int], bytes] = {}
        # quorum tallies keyed by (view, seq, digest): votes for different
        # commands at one sequence — or from different views — must never
        # be conflated, or an equivocating primary could split honest
        # replicas onto divergent uniqueness maps
        self._prepares: dict[tuple[int, int, bytes], set[str]] = defaultdict(set)
        self._commits: dict[tuple[int, int, bytes], set[str]] = defaultdict(set)
        self._next_exec = 0               # execute strictly in sequence order
        self._exec_queue: dict[int, bytes] = {}
        # recently-executed digests (bounded): a late/duplicate T_REQUEST
        # for an already-executed command must not re-insert _commands
        # entries that nothing will ever prune
        self._executed_digests: deque = deque(maxlen=4096)
        self._executed_set: set[bytes] = set()
        # digest -> signed reply of the executed command (same bound/
        # eviction as _executed_digests): a client RETRYING an executed
        # command — its reply was lost, or it re-submits after a crash —
        # gets the cached attestation instead of silence (the reference's
        # BFT-SMaRt replies from its request log the same way)
        self._executed_replies: dict[bytes, bytes] = {}
        # ----- view-change state
        self._view_timeout_s = view_timeout_s
        self._pending_since: dict[bytes, float] = {}  # digest -> arrival time
        self._vc_msgs: dict[int, dict[str, tuple[bytes, bytes]]] = defaultdict(dict)
        self._vc_sent_for = 0             # highest view we demanded
        self._vc_last_sent = 0.0
        self._stop = threading.Event()
        self._timer: threading.Thread | None = None
        for topic, h in (
            (T_REQUEST, self._on_request), (T_PREPREPARE, self._on_preprepare),
            (T_PREPARE, self._on_prepare), (T_COMMIT, self._on_commit),
            (T_VIEWCHANGE, self._on_viewchange), (T_NEWVIEW, self._on_newview),
        ):
            messaging.add_handler(topic, auto_ack(h))
        self._start_timer()

    # ------------------------------------------------------------ lifecycle

    def _start_timer(self) -> None:
        self._timer = threading.Thread(
            target=self._timer_loop, daemon=True, name=f"bft-timer-{self.name}"
        )
        self._timer.start()

    def stop(self) -> None:
        self._stop.set()
        if self._timer is not None:
            self._timer.join(timeout=2)

    def primary_of(self, view: int) -> str:
        return self.names[view % self.n]

    @property
    def is_primary(self) -> bool:
        return self.name == self.primary_of(self.view)

    MAX_PENDING_COMMANDS = 10_000

    def _bound_pending_locked(self) -> None:
        """Cap _commands/_client_of (caller holds the lock): requests the
        primary never orders (primary down, client gave up) must not grow
        memory forever. Evicts oldest-inserted first; a legitimately
        pending command that gets evicted is restored by the client's
        retry broadcast."""
        while len(self._commands) > self.MAX_PENDING_COMMANDS:
            oldest = next(iter(self._commands))
            self._commands.pop(oldest, None)
            self._client_of.pop(oldest, None)
            self._pending_since.pop(oldest, None)

    def _multicast(self, topic: str, obj) -> None:
        payload = serialize(obj)
        for peer in self.names:
            if peer != self.name:
                self._messaging.send(peer, topic, payload)

    # ------------------------------------------------------------ phases

    def _on_request(self, msg) -> None:
        req = deserialize(msg.payload)
        command = req["command"]
        d = _digest(command)
        with self._lock:
            if d in self._executed_set:
                # duplicate of an EXECUTED command: re-send the cached
                # signed reply — the client is retrying because its
                # original replies were lost, and silence here would
                # strand an idempotent resubmission forever
                reply = self._executed_replies.get(d)
                if reply is not None:
                    self._messaging.send(req["client"], T_REPLY, reply)
                return
            self._commands[d] = command
            self._client_of[d] = req["client"]
            self._pending_since.setdefault(d, time.monotonic())
            self._bound_pending_locked()
            if not self.is_primary:
                return
            view = self.view
            seq = self._seq
            self._seq += 1
            self._preprepared[(view, seq)] = d
            self._prepares[(view, seq, d)].add(self.name)
        self._multicast(T_PREPREPARE, {"view": view, "seq": seq, "digest": d,
                                       "command": command,
                                       "client": req["client"]})
        self._check_prepared(view, seq)

    def _on_preprepare(self, msg) -> None:
        pp = deserialize(msg.payload)
        view, seq, d = pp["view"], pp["seq"], pp["digest"]
        if msg.sender != self.primary_of(view):
            return  # only that view's primary may pre-prepare
        if _digest(pp["command"]) != d:
            return  # Byzantine primary: digest mismatch
        with self._lock:
            if view < self.view or seq < self._next_exec:
                return  # stale view, or already executed and pruned
            existing = self._preprepared.get((view, seq))
            if existing is not None and existing != d:
                return  # primary equivocation: keep the first
            self._preprepared[(view, seq)] = d
            self._commands[d] = pp["command"]
            self._client_of[d] = pp["client"]
            self._pending_since.setdefault(d, time.monotonic())
            self._prepares[(view, seq, d)].add(self.name)
            self._prepares[(view, seq, d)].add(msg.sender)
        self._multicast(T_PREPARE, {"view": view, "seq": seq, "digest": d})
        self._check_prepared(view, seq)

    def _on_prepare(self, msg) -> None:
        p = deserialize(msg.payload)
        view, seq, d = p["view"], p["seq"], p["digest"]
        with self._lock:
            if view < self.view or seq < self._next_exec:
                return
            # future-view votes are tallied too: after a NEW-VIEW installs
            # that view, the early votes count instead of being lost
            self._prepares[(view, seq, d)].add(msg.sender)
        self._check_prepared(view, seq)

    def _check_prepared(self, view: int, seq: int) -> None:
        with self._lock:
            # prepared: our pre-prepare's digest gathered 2f+1 prepares
            # (incl. own); then cast our commit vote once
            d = self._preprepared.get((view, seq))
            if (d is not None
                    and len(self._prepares[(view, seq, d)]) >= 2 * self.f + 1
                    and self.name not in self._commits[(view, seq, d)]):
                self._commits[(view, seq, d)].add(self.name)
            else:
                return
        self._multicast(T_COMMIT, {"view": view, "seq": seq, "digest": d})
        self._check_committed(view, seq)

    def _on_commit(self, msg) -> None:
        c = deserialize(msg.payload)
        view, seq, d = c["view"], c["seq"], c["digest"]
        with self._lock:
            if view < self.view or seq < self._next_exec:
                return
            self._commits[(view, seq, d)].add(msg.sender)
        self._check_prepared(view, seq)
        self._check_committed(view, seq)

    def _check_committed(self, view: int, seq: int) -> None:
        with self._lock:
            d = self._preprepared.get((view, seq))
            if (d is not None
                    and len(self._commits[(view, seq, d)]) >= 2 * self.f + 1
                    and seq >= self._next_exec
                    and seq not in self._exec_queue):
                self._exec_queue[seq] = d
            to_run = []
            while self._next_exec in self._exec_queue:
                seq_i = self._next_exec
                d_i = self._exec_queue.pop(seq_i)
                # a client retry can order the same digest under two
                # sequence numbers; the first execution pruned the command,
                # so the duplicate slot is a no-op (commit is idempotent
                # per tx anyway). Null slots (view-change gap fill) skip.
                command_i = (
                    self._commands.get(d_i) if d_i != _NULL_DIGEST else None
                )
                if command_i is not None:
                    to_run.append((seq_i, d_i, command_i,
                                   self._client_of.get(d_i)))
                self._next_exec += 1
                # prune per-sequence protocol state (bounded memory at
                # sustained notarisation rates)
                for key in [k for k in self._preprepared if k[1] == seq_i]:
                    del self._preprepared[key]
                for store in (self._prepares, self._commits):
                    for key in [k for k in store if k[1] == seq_i]:
                        del store[key]
                self._commands.pop(d_i, None)
                self._client_of.pop(d_i, None)
                self._pending_since.pop(d_i, None)
                if d_i != _NULL_DIGEST and d_i not in self._executed_set:
                    if (len(self._executed_digests)
                            == self._executed_digests.maxlen):
                        evicted = self._executed_digests[0]
                        self._executed_set.discard(evicted)
                        self._executed_replies.pop(evicted, None)
                    self._executed_digests.append(d_i)
                    self._executed_set.add(d_i)
        for seq_i, d_i, command, client in to_run:
            self._execute(seq_i, d_i, command, client)

    def _execute(self, seq: int, d: bytes, command: bytes,
                 client: str | None) -> None:
        """Apply to the uniqueness map and reply to the client with a
        signature over the outcome (reference: Replica.verifyAndCommitTx +
        sign over the tx id, BFTNonValidatingNotaryService.kt:136-158).

        A ``("batch", [request, ...])`` command settles a whole notary
        window in this one totally-ordered slot; the outcome (the per-
        request conflict list) is deterministic across replicas because
        requests apply in batch order."""
        cmd = deserialize(command)
        if cmd[0] == "batch":
            requests = [(s, t, c) for s, t, c in cmd[1]]
            conflicts = self.base.commit_batch(requests)
            outcome = serialize({"batch": True, "conflicts": conflicts})
            sig = host_sign(self._keypair.private, outcome)
            client = client or (requests[0][2] if requests else None)
            reply = self._make_reply(d, outcome, sig)
            # _execute runs OUTSIDE _check_committed's locked region (it
            # does slow work: commit + sign + send); the reply cache it
            # feeds is read/evicted under the lock, so the write takes it
            with self._lock:
                self._executed_replies[d] = reply
            self._messaging.send(client, T_REPLY, reply)
            return
        states, tx_id, caller = cmd
        try:
            self.base.commit(states, tx_id, caller)
            conflict = None
        except NotaryError as e:
            conflict = e.conflict
        outcome = serialize({"tx_id": tx_id, "conflict": conflict})
        sig = host_sign(self._keypair.private, outcome)
        client = client or caller
        reply = self._make_reply(d, outcome, sig)
        with self._lock:
            self._executed_replies[d] = reply
        self._messaging.send(client, T_REPLY, reply)

    def _make_reply(self, d: bytes, outcome: bytes, sig) -> bytes:
        """The signed reply payload. A BLS-keyed replica adds its
        aggregate-signature SHARE over the outcome; the reply stays a
        dict on the wire, so decoders predating quorum certificates
        simply ignore the extra keys — old and new replicas interoperate
        in place and per-signer attestation blobs keep decoding
        (``batchverify.qc.decode_attestation``)."""
        reply = {"digest": d, "replica": self.name, "outcome": outcome,
                 "sig": sig, "key": self._keypair.public}
        if self._bls_keypair is not None:
            from ..batchverify import bls

            reply["bls_sig"] = bls.sign(self._bls_keypair[1], outcome)
            reply["bls_v"] = 2
        return serialize(reply)

    # ------------------------------------------------------- view change

    def _timer_loop(self) -> None:
        """Suspicion timer: pending requests that stall past the timeout
        indict the current primary."""
        while not self._stop.wait(0.05):
            with self._lock:
                if not self._pending_since:
                    continue
                oldest = min(self._pending_since.values())
                now = time.monotonic()
                stalled = now - oldest > self._view_timeout_s
                resend_ok = now - self._vc_last_sent > self._view_timeout_s
                if stalled and resend_ok:
                    target = max(self.view + 1, self._vc_sent_for + 1)
                else:
                    continue
            self._send_viewchange(target)

    def _prepared_certs(self) -> list:
        """(view, seq, digest, command) for every slot this replica has
        PREPARED (2f+1 prepare votes) but not yet executed — what must
        survive into the new view (caller holds the lock). The view rides
        along so conflicting same-seq certs from different views resolve
        deterministically (highest view wins, PBFT's selection rule)."""
        certs = []
        for (view, seq), d in self._preprepared.items():
            if seq < self._next_exec or d == _NULL_DIGEST:
                continue
            if len(self._prepares[(view, seq, d)]) >= 2 * self.f + 1:
                cmd = self._commands.get(d)
                if cmd is not None:
                    certs.append((view, seq, d, cmd))
        return certs

    def _newview_preps(self, vcs) -> list:
        """Recompute the new view's re-proposals from the 2f+1 SIGNED
        view-change messages — every replica derives this list itself and
        NEVER trusts a primary-supplied one, so a Byzantine new primary
        cannot drop or overwrite a committed entry (any entry committed at
        an honest replica is prepared at ≥ f+1 honest replicas, hence
        certified inside every 2f+1 view-change set by quorum
        intersection). Per slot the highest-view certificate wins; gaps
        below the top fill with null no-ops. Caller holds the lock."""
        union: dict[int, tuple[int, bytes, bytes]] = {}
        for body, _sig in vcs.values():
            parsed = deserialize(body)
            for view, seq, d, cmd in parsed["certs"]:
                cur = union.get(seq)
                if cur is None or view > cur[0]:
                    union[seq] = (view, d, cmd)
        top = max(union) if union else self._next_exec - 1
        preps = []
        for seq in range(self._next_exec, top + 1):
            hit = union.get(seq)
            if hit is None:
                preps.append((seq, _NULL_DIGEST, b""))
            else:
                preps.append((seq, hit[1], hit[2]))
        return preps

    def _send_viewchange(self, target_view: int) -> None:
        with self._lock:
            if target_view <= self.view or self._vc_sent_for >= target_view:
                return
            self._vc_sent_for = target_view
            self._vc_last_sent = time.monotonic()
            body = serialize({
                "view": target_view, "sender": self.name,
                "last_exec": self._next_exec - 1,
                "certs": self._prepared_certs(),
            })
            sig = host_sign(self._keypair.private, body)
            self._vc_msgs[target_view][self.name] = (body, sig)
        self._multicast(T_VIEWCHANGE, {"body": body, "sig": sig})
        self._maybe_install_view(target_view)

    def _vc_valid(self, sender: str, body: bytes, sig: bytes) -> bool:
        key = self._replica_keys.get(sender)
        if key is None:
            # no key directory configured: fall back to channel identity
            return True
        try:
            return host_verify(key, sig, body)
        except Exception:
            return False

    def _on_viewchange(self, msg) -> None:
        vc = deserialize(msg.payload)
        body, sig = vc["body"], vc["sig"]
        parsed = deserialize(body)
        target = parsed["view"]
        sender = parsed["sender"]
        if sender != msg.sender or not self._vc_valid(sender, body, sig):
            return
        with self._lock:
            if target <= self.view:
                return
            self._vc_msgs[target][sender] = (body, sig)
            # join rule: once f+1 peers demand a higher view, a correct
            # replica joins the SMALLEST such view — one faulty replica
            # alone can never force churn
            joinable = sorted(
                v for v, msgs in self._vc_msgs.items()
                if v > self.view and len(msgs) >= self.f + 1
            )
        if joinable and self._vc_sent_for < joinable[0]:
            self._send_viewchange(joinable[0])
        self._maybe_install_view(target)

    def _maybe_install_view(self, target: int) -> None:
        """The would-be primary of ``target`` installs it once 2f+1 signed
        view-change messages (incl. its own) are in hand."""
        with self._lock:
            if (self.primary_of(target) != self.name
                    or target <= self.view
                    or len(self._vc_msgs[target]) < 2 * self.f + 1):
                return
            vcs = dict(self._vc_msgs[target])
            preps = self._newview_preps(vcs)
            newview = {"view": target, "vcs": vcs}
        self._multicast(T_NEWVIEW, newview)
        self._install_view(target, preps, as_primary=True)

    def _on_newview(self, msg) -> None:
        nv = deserialize(msg.payload)
        target = nv["view"]
        if msg.sender != self.primary_of(target):
            return
        with self._lock:
            if target <= self.view:
                return
        # validate the certificate: 2f+1 distinct signed view-changes
        valid_vcs = {}
        for sender, (body, sig) in nv["vcs"].items():
            parsed = deserialize(body)
            if parsed["sender"] == sender and parsed["view"] == target \
                    and self._vc_valid(sender, body, sig):
                valid_vcs[sender] = (body, sig)
        if len(valid_vcs) < 2 * self.f + 1:
            return
        # derive the re-proposals from the signed VCs OURSELVES — the
        # primary's own list is never trusted
        with self._lock:
            preps = self._newview_preps(valid_vcs)
        self._install_view(target, preps, as_primary=False)

    def _install_view(self, target: int, preps, as_primary: bool) -> None:
        with self._lock:
            if target <= self.view:
                return
            self.view = target
            self._vc_sent_for = max(self._vc_sent_for, target)
            for v in [v for v in self._vc_msgs if v <= target]:
                del self._vc_msgs[v]
            # give the new primary a full timeout before suspecting it
            now = time.monotonic()
            for d in self._pending_since:
                self._pending_since[d] = now
            max_seq = self._next_exec - 1
            installs = []
            for seq, d, cmd in preps:
                if seq < self._next_exec:
                    continue
                max_seq = max(max_seq, seq)
                self._preprepared[(target, seq)] = d
                if d != _NULL_DIGEST:
                    self._commands[d] = cmd
                    self._client_of.setdefault(d, "")
                    self._pending_since.setdefault(d, now)
                self._prepares[(target, seq, d)].add(self.name)
                self._prepares[(target, seq, d)].add(self.primary_of(target))
                installs.append((seq, d))
            if as_primary:
                self._seq = max_seq + 1
                # liveness: re-propose pending requests that never got a
                # sequence in the old view (clients broadcast to all
                # replicas, so the new primary holds them already)
                reproposals = []
                ordered = set(self._preprepared.values())
                for d, cmd in list(self._commands.items()):
                    if d in ordered or d in self._executed_set:
                        continue
                    seq = self._seq
                    self._seq += 1
                    self._preprepared[(target, seq)] = d
                    self._prepares[(target, seq, d)].add(self.name)
                    reproposals.append(
                        (seq, d, cmd, self._client_of.get(d, ""))
                    )
        for seq, d in installs:
            self._multicast(T_PREPARE, {"view": target, "seq": seq, "digest": d})
            self._check_prepared(target, seq)
        if as_primary:
            for seq, d, cmd, client in reproposals:
                self._multicast(T_PREPREPARE, {
                    "view": target, "seq": seq, "digest": d,
                    "command": cmd, "client": client,
                })
                self._check_prepared(target, seq)


class BFTClusterClient:
    """The client side (reference: BFTSMaRt.Client): broadcast the request,
    accept when f+1 replicas sign the *same* outcome. Retries the broadcast
    once per view-timeout so requests arriving during a view change are
    re-seeded into the new view."""

    def __init__(self, name: str, messaging, replica_names: list[str],
                 replica_keys: dict[str, PublicKey], timeout_s: float = 5.0,
                 retry_every_s: float = 1.5,
                 bls_keys: dict[str, bytes] | None = None):
        self.name = name
        self._messaging = messaging
        self._replicas = list(replica_names)
        self._keys = dict(replica_keys)
        self.f = (len(replica_names) - 1) // 3
        self._timeout_s = timeout_s
        self._retry_every_s = retry_every_s
        self._lock = threading.Lock()
        # digest -> {outcome_bytes: {replica: sig}}
        self._replies: dict[bytes, dict[bytes, dict[str, bytes]]] = {}
        self._futures: dict[bytes, Future] = {}
        # quorum certificates (docs/BATCH_VERIFY.md): with the cluster's
        # BLS membership known (name -> 48B public key, PoP-registered;
        # ``make_cluster(..., bls_qc=False)``, the reference's
        # CORDA_TPU_BLS_QC=0, gives none), a settled round carries ONE
        # aggregate signature + signer bitmap instead of f+1 ed25519
        # attestations. The bitmap indexes ``replica_names`` order — the
        # cluster's canonical membership ordering.
        self._bls_keys = dict(bls_keys or {})
        self._use_qc = bool(self._bls_keys)
        # digest -> {outcome_bytes: {replica: bls share}}
        self._bls_shares: dict[bytes, dict[bytes, dict[str, bytes]]] = {}
        self._qc_building: set[bytes] = set()
        messaging.add_handler(T_REPLY, auto_ack(self._on_reply))

    @property
    def bls_member_keys(self) -> list:
        """The cluster's BLS public keys in canonical (bitmap) order —
        what ``QuorumCertificate.verify`` consumes downstream."""
        if not self._bls_keys:
            return []
        return [self._bls_keys.get(r) for r in self._replicas]

    def _settle_locked(self, d: bytes, fut: Future | None = None) -> None:
        """Drop all per-digest state. Runs when the quorum resolves the
        future (the normal path), from collect()'s finally, and from the
        pending object's finalizer — so an abandoned pending (a pipelined
        window unwound before collect()) cannot leak its future and keep
        accumulating stray replica replies for the process lifetime.
        With ``fut`` given, settles only while that future is still the
        registered one — a retry of the same command re-registers the
        digest, and a stale finalizer/collect must not tear the retry's
        live future down."""
        if fut is not None and self._futures.get(d) is not fut:
            return
        self._futures.pop(d, None)
        self._replies.pop(d, None)
        self._bls_shares.pop(d, None)
        self._qc_building.discard(d)

    def _on_reply(self, msg) -> None:
        rep = deserialize(msg.payload)
        replica, outcome, sig = rep["replica"], rep["outcome"], rep["sig"]
        key = self._keys.get(replica)
        if key is None or rep["key"] != key:
            return
        try:
            if not host_verify(key, sig, outcome):
                return
        except Exception:
            return
        d = rep["digest"]
        build = None
        with self._lock:
            fut = self._futures.get(d)
            if fut is None:
                # late reply for an already-settled (or unknown) request —
                # don't recreate reply buckets for it (unbounded growth)
                return
            bucket = self._replies.setdefault(d, {}).setdefault(outcome, {})
            bucket[replica] = sig
            share = rep.get("bls_sig")
            if share is not None and replica in self._bls_keys:
                self._bls_shares.setdefault(d, {}).setdefault(
                    outcome, {}
                )[replica] = share
            if fut.done() or len(bucket) < self.f + 1:
                return
            if d in self._qc_building:
                # another reply thread is already assembling this
                # round's certificate; it will resolve the future
                return
            if self._use_qc:
                shares = dict(self._bls_shares.get(d, {}).get(outcome, {}))
                if len(shares) >= self.f + 1:
                    self._qc_building.add(d)
                    build = (dict(bucket), shares)
            if build is None:
                fut.set_result((outcome, dict(bucket), None))
                # quorum reached: state cleanup rides the resolution, not
                # a collect() that may never come
                self._settle_locked(d)
                return
        # certificate assembly runs OUTSIDE the lock: one aggregation +
        # ONE pairing-priced aggregate verify — far too slow for the
        # reply handler's locked region
        qc = self._try_build_qc(outcome, build[1])
        with self._lock:
            if self._futures.get(d) is fut and not fut.done():
                fut.set_result((outcome, build[0], qc))
                self._settle_locked(d)
            else:
                self._qc_building.discard(d)

    def _try_build_qc(self, outcome: bytes, shares: dict):
        """Aggregate f+1 BLS shares into a verified quorum certificate,
        or None — a garbage share (Byzantine replica) or an injected
        fault at ``notary.aggregate`` degrades the round to the legacy
        per-signer ed25519 attestations, never to a lost future."""
        from ..batchverify import bls
        from ..batchverify.qc import QuorumCertificate
        from ..faultinject import check_site
        from ..node.monitoring import node_metrics

        try:
            check_site("notary.aggregate")
            picked = sorted(
                (self._replicas.index(name), share)
                for name, share in shares.items()
            )
            bitmap = 0
            for i, _share in picked:
                bitmap |= 1 << i
            cert = QuorumCertificate(
                message=outcome,
                agg_sig=bls.aggregate([share for _i, share in picked]),
                bitmap=bitmap,
                n=len(self._replicas),
            )
            node_metrics().counter("notary.qc.aggregated").inc()
            if not cert.verify(self.bls_member_keys):
                raise ValueError("aggregate quorum signature rejected")
            node_metrics().counter("notary.qc.verified").inc()
            return cert
        except Exception:
            import logging

            node_metrics().counter("notary.qc.fallback").inc()
            logging.getLogger(__name__).warning(
                "quorum-certificate aggregation failed; round falls back "
                "to per-signer attestations"
            )
            return None

    def submit(self, states, tx_id, caller: str):
        """Returns (conflict_or_None, {replica: sig}) after quorum."""
        outcome, sigs, _qc = self._submit_command(
            serialize((list(states), tx_id, caller))
        )
        return outcome["conflict"], sigs

    def submit_batch(self, requests):
        """N requests in ONE total-order slot: returns (conflicts, sigs)
        where conflicts is the per-request list, after f+1 matching
        replies (matching = identical serialized conflict list, so the
        quorum certifies the whole batch outcome)."""
        outcome, sigs, _qc = self._submit_command(serialize(
            ("batch", [(list(s), t, c) for (s, t, c) in requests])
        ))
        return list(outcome["conflicts"]), sigs

    def _submit_command(self, command: bytes):
        return self._submit_command_async(command).collect()

    def _submit_command_async(self, command: bytes):
        """Broadcast the request and return a pending; ``collect()`` waits
        for the f+1 quorum, re-broadcasting once per view-timeout. The
        broadcast goes out NOW, so the cluster's three-phase rounds for
        consecutive notary windows pipeline (phases are per-sequence-slot)
        while the caller settles other windows."""
        d = _digest(command)
        fut: Future = Future()
        with self._lock:
            self._futures[d] = fut
        payload = serialize({"command": command, "client": self.name})
        from ..flows.overload import active_overload

        ov = active_overload()
        if ov is not None:
            # the whole-cluster broadcast is ONE fresh send for budget
            # purposes: re-broadcasts below spend against it
            ov.note_send("bft.submit", self.name)
        for r in self._replicas:
            self._messaging.send(r, T_REQUEST, payload)
        client = self

        class _PendingSubmit:
            def collect(_self):
                # the quorum-wait budget starts HERE, not at dispatch: a
                # pipelined caller may dwell several windows between
                # dispatch and collect, and that dwell must not consume
                # the timeout (the slot has been replicating meanwhile)
                from ..flows.overload import (
                    active_overload,
                    remaining_deadline,
                )

                budget = client._timeout_s
                rem = remaining_deadline()
                if rem is not None:
                    # propagated end-to-end deadline bounds the quorum
                    # wait: a round for a dead flow is not worth waiting
                    # out the full view timeout (docs/OVERLOAD.md)
                    budget = min(budget, max(0.05, rem))
                deadline = time.monotonic() + budget
                ov = active_overload()
                try:
                    while True:
                        try:
                            outcome_bytes, sigs, qc = fut.result(
                                timeout=min(
                                    client._retry_every_s,
                                    max(0.01, deadline - time.monotonic()),
                                )
                            )
                            break
                        except (TimeoutError, FutureTimeoutError):
                            # both spellings: concurrent.futures raises its
                            # own TimeoutError before Python 3.11 — the
                            # re-broadcast retry must fire on either
                            if time.monotonic() >= deadline:
                                raise
                            if ov is not None and not ov.allow_retry(
                                    "bft.submit", client.name):
                                # retry budget exhausted: skip this
                                # round's re-broadcast and keep waiting —
                                # the original request may still land a
                                # quorum, and the hard deadline bounds us
                                continue
                            for r in client._replicas:
                                client._messaging.send(r, T_REQUEST, payload)
                finally:
                    with client._lock:
                        client._settle_locked(d, fut)
                return deserialize(outcome_bytes), sigs, qc

        pending = _PendingSubmit()
        # lifecycle-tied cleanup: a pending abandoned WITHOUT collect()
        # (an earlier window's failure unwinding a pipelined caller) drops
        # its digest state when the object is garbage-collected. A time
        # horizon would be wrong here — a pipelined caller may legally
        # dwell many windows between dispatch and collect.
        import weakref

        def _abandoned(client=self, d=d, fut=fut):
            with client._lock:
                client._settle_locked(d, fut)

        weakref.finalize(pending, _abandoned)
        return pending


class BFTUniquenessProvider(UniquenessProvider):
    """UniquenessProvider face over a BFT cluster client."""

    def __init__(self, client: BFTClusterClient):
        self.client = client
        # the quorum certificate of the most recently COLLECTED round,
        # consumed exactly once by the notary service's take_qc() —
        # windows collect strictly in order (the pipeline settles window
        # N before window N+1), so one slot is enough
        self._last_qc = None

    @property
    def bls_member_keys(self) -> list:
        return self.client.bls_member_keys

    def take_qc(self):
        """Hand over (and clear) the last collected round's quorum
        certificate, or None for a QC-less round."""
        qc, self._last_qc = self._last_qc, None
        return qc

    def commit(self, states, tx_id, caller_name) -> None:
        outcome, _sigs, qc = self.client._submit_command(
            serialize((list(states), tx_id, caller_name))
        )
        self._last_qc = qc
        conflict = outcome["conflict"]
        if conflict is not None:
            raise NotaryError(
                f"input states of {tx_id} already consumed", conflict
            )

    def commit_batch(self, requests):
        """One total-order broadcast for the whole window; the f+1 quorum
        certifies the per-request conflict list."""
        return self.commit_batch_async(requests).collect()

    def commit_batch_async(self, requests):
        """Put the window's total-order slot in flight and return — the
        three-phase broadcast for window N replicates while the notary
        pipeline verifies window N+1 on device (same stall fix as the
        Raft provider's commit_batch_async)."""
        from .uniqueness import PendingCommit

        if not requests:
            return PendingCommit([])
        pending = self.client._submit_command_async(serialize(
            ("batch", [(list(s), t, c) for (s, t, c) in requests])
        ))
        provider = self

        class _PendingBFTCommit:
            def collect(_self):
                outcome, _sigs, qc = pending.collect()
                provider._last_qc = qc
                return list(outcome["conflicts"])

        return _PendingBFTCommit()

    @staticmethod
    def make_cluster(n: int, network, prefix: str = "bft-replica",
                     view_timeout_s: float = 1.0, bls_qc: bool = True):
        """n = 3f+1 co-located replicas + a client factory.

        With ``bls_qc`` (where the reference also reads its
        CORDA_TPU_BLS_QC switch; the port reads no environment switch),
        each replica also gets a BLS share key so rounds settle with one
        aggregate quorum certificate. The BLS keys derive DETERMINISTICALLY from
        the replica names: proof-of-possession verification is
        pairing-priced, and the deterministic derivation lets the
        process-wide PoP registry memoize it across the many in-process
        clusters a test session builds."""
        from ..crypto import generate_keypair

        names = [f"{prefix}-{i}" for i in range(n)]
        keypairs = {name: generate_keypair() for name in names}
        keys = {name: kp.public for name, kp in keypairs.items()}
        bls_keypairs: dict = {}
        bls_keys: dict = {}
        if bls_qc:
            from ..batchverify import bls

            for name in names:
                pk, sk = bls.derive_keypair_from_entropy(name.encode())
                if not bls.is_registered(pk):
                    bls.register_pop(pk, bls.prove_possession(sk))
                bls_keypairs[name] = (pk, sk)
                bls_keys[name] = pk
        replicas = [
            BFTReplica(name, names, network.create_node(name), keypairs[name],
                       replica_keys=keys, view_timeout_s=view_timeout_s,
                       bls_keypair=bls_keypairs.get(name))
            for name in names
        ]

        def make_client(client_name: str) -> BFTUniquenessProvider:
            client = BFTClusterClient(
                client_name, network.create_node(client_name), names, keys,
                bls_keys=bls_keys or None,
            )
            return BFTUniquenessProvider(client)

        return replicas, make_client
