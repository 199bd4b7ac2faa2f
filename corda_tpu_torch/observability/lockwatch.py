"""lockwatch — the runtime lock-order sanitizer (tpu-lint's dynamic half).

(Counterpart of corda_tpu/observability/lockwatch.py, copied with its import root
changed.)

The static passes in ``corda_tpu/analysis`` can prove a guarded
attribute is always mutated under its lock; they cannot see the ORDER
two threads acquire two locks in — the lockdep problem. This module is
the linux-lockdep idea in miniature: every watched lock records, per
thread, the set of locks already held when it is acquired; each
``(held → acquiring)`` pair becomes an edge in a process-global
acquisition graph, and a cycle in that graph is a potential deadlock
EVEN IF the run never actually deadlocked — the A→B / B→A interleaving
only has to be possible, not observed simultaneously.

Opt-in and test-facing (enabled by the analyzer's test suite and the
seeded-chaos soak; never in production paths):

- ``install()`` monkeypatches ``threading.Lock``/``RLock``/``Condition``
  so every lock constructed AFTER it is watched, named by its
  allocation site (``file:line``) — all instances born at one site
  share a name, so the graph is over lock *classes*, which is what an
  ordering discipline is defined over. ``uninstall()`` restores the
  real factories (existing watched locks keep working).
- ``WatchedLock(name=…)`` / ``watched_condition(name=…)`` construct
  explicitly-named instances for targeted tests.
- ``cycle_report()`` returns the cycles found so far (list of edge
  chains with the acquisition stacks that created them);
  ``reset()`` clears the graph between scenarios.

Same-site instance pairs (two queue locks allocated at one line,
nested) would self-edge the graph; those are recorded but EXCLUDED
from cycles unless ``strict=True`` — per-instance ordering inside one
allocation site needs an order key the watcher cannot guess, and the
codebase's idiom (one ``self._lock`` per subsystem object, never two
peers nested) makes the lenient default the honest one.
"""

from __future__ import annotations

import threading
import traceback

__all__ = [
    "WatchedLock",
    "cycle_report",
    "install",
    "installed",
    "lockwatch_edges",
    "reset",
    "uninstall",
    "watched_condition",
]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# ---------------------------------------------------------------- registry

_graph_lock = _REAL_LOCK()
# edge (from_name, to_name) → {"count": int, "stack": str, "cross_instance":
# bool} — cross_instance False means the edge was ONLY ever seen between
# two distinct locks of the same allocation site (the self-edge case)
_edges: dict[tuple[str, str], dict] = {}
_held = threading.local()   # per-thread list of (name, id(lock)) in order
_installed = False
_strict = False


def _held_stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _note_acquire(name: str, lock_id: int) -> None:
    """Record (held → acquiring) edges, then push. Reentrant holds
    (same lock id already on the stack) add no edge — an RLock
    re-acquire is not an ordering event."""
    stack = _held_stack()
    if any(lid == lock_id for _n, lid in stack):
        stack.append((name, lock_id))
        return
    if stack:
        # one traceback render serves every edge this acquire creates
        tb = "".join(traceback.format_stack(limit=12)[:-2])
        with _graph_lock:
            for held_name, held_id in stack:
                key = (held_name, name)
                e = _edges.get(key)
                if e is None:
                    _edges[key] = {
                        "count": 1,
                        "stack": tb,
                        "distinct_instance": held_id != lock_id,
                    }
                else:
                    e["count"] += 1
    stack.append((name, lock_id))


def _note_release(name: str, lock_id: int) -> None:
    stack = _held_stack()
    # release the INNERMOST matching hold (reentrancy pops one level)
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == lock_id:
            del stack[i]
            return


class WatchedLock:
    """A threading.Lock/RLock wrapper feeding the acquisition graph.
    Duck-types the full lock surface Condition needs (``_is_owned`` etc.
    delegate), so it can sit under a Condition transparently."""

    def __init__(self, name: str | None = None, *, reentrant: bool = False,
                 _inner=None):
        self._inner = _inner if _inner is not None else (
            _REAL_RLOCK() if reentrant else _REAL_LOCK()
        )
        self.name = name or _allocation_site()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self.name, id(self))
        return got

    def release(self):
        _note_release(self.name, id(self))
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else False

    def _at_fork_reinit(self):
        # stdlib modules call this at import time via os.register_at_fork
        # (concurrent.futures.thread does on its module-level lock) — a
        # watched lock must honor the full duck-typed surface
        self._inner._at_fork_reinit()
        _held.stack = []

    def __getattr__(self, name):
        # anything else the stdlib expects of a lock delegates straight
        # to the real one (defined methods above keep the bookkeeping)
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __repr__(self):
        return f"<WatchedLock {self.name!r} wrapping {self._inner!r}>"

    # Condition's duck-typed fast-path hooks: delegate when the inner
    # lock has them (RLock), with hold-stack bookkeeping mirrored —
    # Condition.wait() RELEASES the lock via _release_save and takes it
    # back via _acquire_restore, and the watcher must agree it is not
    # held while waiting (otherwise every wake-up edge is inverted).
    def _release_save(self):
        _note_release(self.name, id(self))
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        _note_acquire(self.name, id(self))

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock heuristic (same one threading.Condition uses)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def watched_condition(name: str | None = None):
    """A Condition over a WatchedLock (the scheduler/engine idiom)."""
    return _REAL_CONDITION(
        WatchedLock(name or _allocation_site(), reentrant=True)
    )


def _allocation_site() -> str:
    """file:line of the frame that constructed the lock, skipping the
    instrumentation's own frames (this module and contention.py, which
    shares the naming scheme) — the lock's "class" name in the graph."""
    for frame in reversed(traceback.extract_stack(limit=16)[:-1]):
        fn = frame.filename
        base = fn.rsplit("/", 1)[-1]
        if base not in ("lockwatch.py", "contention.py") \
                and "threading" not in fn:
            return f"{base}:{frame.lineno}"
    return "<unknown>"


# ------------------------------------------------------------ install hook

def install(strict: bool = False) -> None:
    """Monkeypatch the threading lock factories so every lock built
    after this call is watched. Test-scoped: pair with ``uninstall()``
    in a finally. ``strict`` includes same-allocation-site
    distinct-instance edges in cycle detection."""
    global _installed, _strict
    _strict = strict
    if _installed:
        return
    threading.Lock = lambda: WatchedLock()            # type: ignore
    threading.RLock = lambda: WatchedLock(reentrant=True)  # type: ignore

    def condition(lock=None):
        return _REAL_CONDITION(
            lock if lock is not None else WatchedLock(reentrant=True)
        )

    threading.Condition = condition                   # type: ignore
    _installed = True


def uninstall() -> None:
    global _installed
    threading.Lock = _REAL_LOCK           # type: ignore
    threading.RLock = _REAL_RLOCK         # type: ignore
    threading.Condition = _REAL_CONDITION  # type: ignore
    _installed = False


def installed() -> bool:
    return _installed


def reset() -> None:
    with _graph_lock:
        _edges.clear()


def lockwatch_edges() -> dict:
    """Snapshot of the acquisition graph: (from, to) → count."""
    with _graph_lock:
        return {k: v["count"] for k, v in _edges.items()}


# ------------------------------------------------------------------ cycles

def cycle_report(strict: bool | None = None) -> list[dict]:
    """Cycles in the acquisition graph — each a potential deadlock.

    Returns ``[{"cycle": [name, ...], "edges": [{"from", "to",
    "count", "stack"}, ...]}, ...]``; empty list = no inversion ever
    observed. Unless ``strict``, edges seen ONLY between two instances
    from the same allocation site are ignored (see module docstring).
    """
    if strict is None:
        strict = _strict
    with _graph_lock:
        edges = {
            k: dict(v) for k, v in _edges.items()
            if strict or k[0] != k[1] or v["distinct_instance"] is False
        }
    # drop pure self-loops unless strict (same lock reentrancy never
    # records an edge, so a self-loop here is the same-site pair case)
    adj: dict[str, set[str]] = {}
    for (a, b) in edges:
        if a == b and not strict:
            continue
        adj.setdefault(a, set()).add(b)

    # iterative DFS cycle enumeration over the (small) class graph
    cycles: list[list[str]] = []
    seen_cycles: set[tuple] = set()

    def dfs(start: str):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start and len(path) > 1 or (
                    nxt == start and len(path) == 1 and
                    (start, start) in edges
                ):
                    canon = tuple(sorted(path))
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(path + [start])
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))

    for n in sorted(adj):
        dfs(n)

    out = []
    for cyc in cycles:
        cyc_edges = []
        for a, b in zip(cyc, cyc[1:]):
            e = edges.get((a, b), {})
            cyc_edges.append({
                "from": a, "to": b,
                "count": e.get("count", 0),
                "stack": e.get("stack", ""),
            })
        out.append({"cycle": cyc, "edges": cyc_edges})
    return out
