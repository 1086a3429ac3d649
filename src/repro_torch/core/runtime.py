"""SlotRuntime: the slot-table serving substrate (``repro.core.runtime``).

Quegel's execution model — a table of C slots, each holding one in-flight
query, advanced together one superstep per super-round — lives here
exactly once; a front end (the engine) keeps only its device-side half
behind the small ``SlotProgram`` protocol:

    slot_validate(query) -> None | (status, result)   pre-admission reject
    slot_round(admitted) -> RoundOutcome              ONE fused round
    slot_collect(slots)  -> [result, ...]             extract retirees
    slot_evict(slots)                                 kill device liveness
    slot_observe()                                    per-round diagnostics

The runtime never touches the device: admission is served from a host
liveness mirror, and everything it learns about a round comes from the
``RoundOutcome`` the program distilled from its single device->host sync.
On top it adds admission schedulers (fifo/priority/sjf/deadline),
per-query superstep budgets with TIMEOUT eviction, an opt-in result cache,
and the open-loop ``pump``/``poll`` face, and:

* **Preemptive scheduling** (``preemptive=True``, the paper's console
  *suspend*): at a round boundary, a waiting query that beats the
  worst-ranked running query by ``preempt_margin`` triggers
  ``slot_suspend`` — the victim's resumable state is copied to the host,
  its slot freed, and it re-enters the queue as a *resume ticket* that
  batched admission later restores with its step and budget accounting
  intact.  Suspension is observationally equivalent to never having been
  admitted, modulo steps already charged; it also lets more queries be in
  flight than there are slots (``SlotStats.max_inflight``).
* **Crash tolerance**: an append-only ``QueryJournal`` logs every submit
  and retirement (sha256-prefixed JSON lines, fsynced, byte-compatible
  with the JAX package's), and ``snapshot()`` / ``snapshot_every=N``
  journal the live slots' resumable state through the same
  ``slot_suspend`` path, so ``launch/supervise.py`` can replay the
  journal after a crash and resume with identical results.  A result with
  non-finite floats is quarantined: fresh re-admission with exponential
  backoff up to ``max_retries``, then the terminal status ``POISONED``.
"""
from __future__ import annotations

import base64
import collections
import dataclasses
import hashlib
import heapq
import json
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

# Terminal query statuses (``SlotRuntime.status[qid]``).
DONE = "DONE"          # voted done; result extracted
TIMEOUT = "TIMEOUT"    # superstep budget exhausted; evicted with partial result
REJECTED = "REJECTED"  # failed slot_validate; never admitted
POISONED = "POISONED"  # non-finite slot state survived max_retries re-runs


class QueryTimeoutError(RuntimeError):
    """An interactive query did not finish within its round allowance."""


# ------------------------------------------------------------- tree helpers
def tree_leaves(tree) -> list:
    """Leaves of a pytree of dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A pytree of ``like``'s structure holding ``leaves`` in
    ``tree_leaves`` order (sorted keys)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of one or more same-structure pytrees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _treedef(tree) -> str:
    """The structure of a pytree as JAX's ``repr(treedef)`` spells it
    (``PyTreeDef({'a': *, 'b': (*, None)})``), so that query hashes, and
    the replica placement derived from them, agree across packages."""

    def spell(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spell(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(spell(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(spell(v) for v in t) + "]"
        return "*"

    return f"PyTreeDef({spell(tree)})"


def to_numpy(x) -> np.ndarray:
    """A host copy that never aliases ``x``: a CPU tensor's ``.numpy()``
    shares its memory, and slot tensors are updated in place."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


# --------------------------------------------------------------------- stats
@dataclasses.dataclass
class SlotStats:
    """Lifecycle counters every slot-table front end shares.

    ``rounds`` counts executed super-rounds (== barriers: one sync per
    round by construction); ``supersteps_total`` accumulates the
    per-query superstep counters of retired queries, so slot sharing
    never changes it (paper §3.1).
    """

    rounds: int = 0
    queries_done: int = 0
    timeouts: int = 0
    rejected: int = 0
    cache_hits: int = 0
    supersteps_total: int = 0
    # preemption: suspensions, resume re-admissions, and the high-water
    # mark of in-flight queries (live slots + suspended), which exceeds
    # the capacity once a query is suspended while every slot stays busy
    preemptions: int = 0
    resumes: int = 0
    max_inflight: int = 0
    # fault tolerance: journal snapshots taken, retired queries replayed
    # from the journal, poison re-admissions and POISONED retirements,
    # rounds abandoned to an exception, rounds flagged as stragglers
    snapshots: int = 0
    replayed: int = 0
    poison_retries: int = 0
    poisoned: int = 0
    round_failures: int = 0
    straggler_rounds: int = 0
    round_times: list = dataclasses.field(default_factory=list)
    # per-query submit->result latency, split at the first admission into
    # queue wait and service (appended in lockstep, DONE only)
    query_latencies: list = dataclasses.field(default_factory=list)
    queue_waits: list = dataclasses.field(default_factory=list)
    service_times: list = dataclasses.field(default_factory=list)
    # live slots per executed round
    slot_occupancy: list = dataclasses.field(default_factory=list)
    # cached results dropped because a graph mutation made their version's
    # content unreachable, and the time the invalidation took
    cache_invalidations: int = 0
    cache_invalidation_ms: float = 0.0

    @property
    def wall_time(self) -> float:
        return float(sum(self.round_times))

    @staticmethod
    def _pct(xs: list, q: float) -> float:
        if not xs:
            return float("nan")
        return float(np.percentile(xs, q))

    def latency_percentile(self, q: float) -> float:
        return self._pct(self.query_latencies, q)

    def queue_wait_percentile(self, q: float) -> float:
        return self._pct(self.queue_waits, q)

    def service_percentile(self, q: float) -> float:
        return self._pct(self.service_times, q)


# ----------------------------------------------------------------- scheduler
@dataclasses.dataclass
class Ticket:
    """One queued query plus its scheduling attributes."""

    qid: int
    query: Any
    priority: int = 0         # lower = admitted sooner (priority scheduler)
    deadline: float = math.inf  # earliest-deadline-first key
    budget: int = 0           # declared superstep budget; 0 = unlimited.
    # Doubles as the sjf job-size estimate and the TIMEOUT eviction bound.
    submit_t: float = 0.0
    # wall time of the FIRST slot admission (0.0 = never admitted); kept
    # across suspend/resume so queue_wait is measured once
    admit_t: float = 0.0
    seq: int = 0              # submission order; ties break FIFO
    # supersteps already charged (nonzero only for a resume ticket): sjf
    # ranks by remaining work, and the TIMEOUT bound keeps counting
    steps_done: int = 0
    # resumable state from ``slot_suspend`` (None = fresh query)
    resume: Any = None
    attempts: int = 0         # poison-quarantine re-admissions consumed


class Scheduler:
    """Admission-order policy over queued tickets: only the pop order
    differs between implementations.

    Key-ordered schedulers also expose a *preemption rank*
    (``running_key``): the key a RUNNING query would queue with after the
    supersteps it has consumed.  ``SlotRuntime(preemptive=True)`` compares
    the best waiting keys against the worst running ranks at every round
    boundary and suspends the losers."""

    name = "base"
    # FIFO has no rank to compare a waiting query against a running one
    supports_preemption = False

    def push(self, ticket: Ticket) -> None:
        raise NotImplementedError

    def pop(self) -> Ticket:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def waiting_keys(self, n: int) -> list:
        """The ``n`` best queued keys in pop order (preemptive only)."""
        raise NotImplementedError

    def running_key(self, ticket: Ticket, steps: int):
        """Rank of a RUNNING query after ``steps`` consumed supersteps,
        comparable against ``waiting_keys`` (preemptive only)."""
        raise NotImplementedError


class FIFOScheduler(Scheduler):
    """Submission order — the paper's admission rule, and the default."""

    name = "fifo"

    def __init__(self):
        self._q: collections.deque[Ticket] = collections.deque()

    def push(self, t: Ticket) -> None:
        self._q.append(t)

    def pop(self) -> Ticket:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)


class _HeapScheduler(Scheduler):
    """Key-ordered admission (O(log n)); FIFO among equal keys."""

    supports_preemption = True

    def __init__(self):
        self._h: list[tuple] = []

    def key(self, t: Ticket):
        raise NotImplementedError

    def push(self, t: Ticket) -> None:
        heapq.heappush(self._h, (self.key(t), t.seq, t))

    def pop(self) -> Ticket:
        return heapq.heappop(self._h)[-1]

    def __len__(self) -> int:
        return len(self._h)

    def waiting_keys(self, n: int) -> list:
        return [k for k, _, _ in heapq.nsmallest(n, self._h)]

    def running_key(self, t: Ticket, steps: int):
        return self.key(dataclasses.replace(t, steps_done=steps))


class PriorityScheduler(_HeapScheduler):
    """User-supplied levels; lower ``priority`` is admitted first."""

    name = "priority"

    def key(self, t: Ticket):
        return t.priority


class SJFScheduler(_HeapScheduler):
    """Shortest-job-first by declared remaining superstep budget
    (``budget - steps_done``: SRPT for resume tickets and running ranks);
    undeclared (budget=0) queries sort last."""

    name = "sjf"

    def key(self, t: Ticket):
        return t.budget - t.steps_done if t.budget > 0 else math.inf


class DeadlineScheduler(_HeapScheduler):
    """Earliest-deadline-first."""

    name = "deadline"

    def key(self, t: Ticket):
        return t.deadline


SCHEDULERS = {
    c.name: c
    for c in (FIFOScheduler, PriorityScheduler, SJFScheduler, DeadlineScheduler)
}


def make_scheduler(spec) -> Scheduler:
    """'fifo' | 'priority' | 'sjf' | 'deadline', a Scheduler subclass, or a
    ready instance."""
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, type) and issubclass(spec, Scheduler):
        return spec()
    if isinstance(spec, str) and spec in SCHEDULERS:
        return SCHEDULERS[spec]()
    raise ValueError(
        f"unknown scheduler {spec!r}: expected one of {sorted(SCHEDULERS)}, "
        "a Scheduler subclass, or an instance"
    )


# -------------------------------------------------------------- result cache
def default_cache_key(query) -> str:
    """Canonicalize a query pytree: structure + per-leaf dtype/shape/bytes."""
    h = hashlib.sha1(_treedef(query).encode())
    for leaf in tree_leaves(query):
        if leaf is None:  # a node without leaves, as in JAX
            continue
        arr = to_numpy(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


_MISS = object()


class ResultCache:
    """LRU of extracted results keyed by canonicalized query hash.

    Keys are ``<content-hash>:<query-hash>`` (the engine prefixes every
    key with the graph version's content hash), so beside the LRU order
    the cache buckets keys by that prefix: version invalidation after a
    mutation (``invalidate_except``) pops whole buckets, O(dropped), not
    O(cache size).  Unprefixed keys share the '' bucket.
    """

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("result cache size must be >= 1")
        self.size = int(size)
        self._d: collections.OrderedDict[str, Any] = collections.OrderedDict()
        self._buckets: dict[str, set] = {}

    @staticmethod
    def _prefix(key: str) -> str:
        key = str(key)
        return key.split(":", 1)[0] if ":" in key else ""

    def _remove(self, key: str) -> None:
        del self._d[key]
        p = self._prefix(key)
        b = self._buckets.get(p)
        if b is not None:
            b.discard(key)
            if not b:
                del self._buckets[p]

    def get(self, key: str):
        if key not in self._d:
            return _MISS
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: str, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        self._buckets.setdefault(self._prefix(key), set()).add(key)
        while len(self._d) > self.size:
            self._remove(next(iter(self._d)))

    def invalidate(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred``; returns the count
        (the general sweep: version invalidation uses ``invalidate_except``)."""
        doomed = [k for k in self._d if pred(k)]
        for k in doomed:
            self._remove(k)
        return len(doomed)

    def invalidate_except(self, prefix: str) -> int:
        """Drop every entry whose key prefix differs from ``prefix``;
        returns the count.  One dict pop per doomed bucket."""
        prefix = str(prefix)
        n = 0
        for p in [p for p in self._buckets if p != prefix]:
            keys = self._buckets.pop(p)
            n += len(keys)
            for k in keys:
                del self._d[k]
        return n

    def __len__(self) -> int:
        return len(self._d)


# ------------------------------------------------------------- query journal
def _journal_enc(obj):
    """Pytree -> JSON-able, tagged so decoding is exact: arrays carry
    dtype/shape/base64 bytes, tuples stay tuples, and plain dataclasses
    record their class by name.  The tags, dtype names and bytes are the
    JAX package's, so either package reads the other's journal.  Arrays
    arrive as numpy: a torch tensor here is a caller's fault."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        raise TypeError("journal records hold numpy arrays, not torch tensors: "
                        "copy to the host with runtime.to_numpy first")
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise ValueError("journal records need string dict keys")
        return {"t": "d", "v": {k: _journal_enc(v) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "l" if isinstance(obj, list) else "t",
                "v": [_journal_enc(v) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {"t": "dc", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "v": {f.name: _journal_enc(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    arr = np.asarray(obj)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return {"t": "a", "dtype": str(arr.dtype), "shape": list(arr.shape),
            "b64": base64.b64encode(arr.tobytes()).decode("ascii")}


def _journal_dec(obj):
    if not isinstance(obj, dict):
        return obj
    t = obj["t"]
    if t == "d":
        return {k: _journal_dec(v) for k, v in obj["v"].items()}
    if t == "l":
        return [_journal_dec(v) for v in obj["v"]]
    if t == "t":
        return tuple(_journal_dec(v) for v in obj["v"])
    if t == "a":
        buf = base64.b64decode(obj["b64"])
        return np.frombuffer(buf, dtype=np.dtype(obj["dtype"])).reshape(
            obj["shape"]).copy()
    if t == "dc":
        from repro_torch.core.store import _resolve_class

        cls = _resolve_class(obj["cls"])
        return cls(**{k: _journal_dec(v) for k, v in obj["v"].items()})
    raise ValueError(f"unknown journal node type {t!r}")


def _digest(enc) -> str:
    return hashlib.sha256(
        json.dumps(enc, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def result_hash(result) -> str:
    """Stable digest of a result pytree (journaled at retirement so a
    recovered run can be audited against the uninterrupted one)."""
    return _digest(_journal_enc(result))


class QueryJournal:
    """Append-only write-ahead log of the query lifecycle.

    One JSON record per line, prefixed with its own sha256 — replay stops
    at the first torn or corrupt line, so a crash mid-append loses at most
    the record being written.  Record types:

      submit   {qid, seq, priority, deadline, budget, query}
      retire   {qid, status, steps, result, result_hash}
      snapshot {qid, seq, priority, deadline, budget, steps, payload}
               (in-flight state via ``slot_suspend``; the newest snapshot
               per qid wins on replay)
      mutation {version, parent_hash, content_hash, adds, add_w, dels}
               (a graph delta, written by ``QuegelEngine.apply_delta``
               after the snapshots that pin the pre-mutation version;
               recovery replays it through ``apply_delta_record``)

    ``fsync=True`` (default) makes every append durable before the runtime
    proceeds — the crash-safety contract.  ``write=False`` opens nothing
    and records nothing: the journal of a mesh rank other than 0, whose
    runtime must take the same journaled decisions (snapshot cadence) as
    rank 0's without writing the file twice.
    """

    def __init__(self, path: str, *, fsync: bool = True, write: bool = True):
        self.path = str(path)
        self.fsync = bool(fsync)
        self._f = None
        if write:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "ab")
        self.records_written = 0

    def append(self, rec: dict) -> None:
        if self._f is None:
            return
        body = json.dumps(rec, separators=(",", ":"))
        digest = hashlib.sha256(body.encode()).hexdigest()
        self._f.write(f"{digest} {body}\n".encode())
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.records_written += 1

    def submit(self, qid: int, query, *, priority: int, deadline: float,
               budget: int, seq: int) -> None:
        self.append({
            "type": "submit", "qid": int(qid), "seq": int(seq),
            "priority": int(priority),
            "deadline": None if math.isinf(deadline) else float(deadline),
            "budget": int(budget), "query": _journal_enc(query),
        })

    def retire(self, qid: int, status: str, steps: int, result) -> None:
        enc = _journal_enc(result)
        self.append({
            "type": "retire", "qid": int(qid), "status": str(status),
            "steps": int(steps), "result": enc, "result_hash": _digest(enc),
        })

    def snapshot(self, ticket: Ticket) -> None:
        self.append({
            "type": "snapshot", "qid": int(ticket.qid), "seq": int(ticket.seq),
            "priority": int(ticket.priority),
            "deadline": (None if math.isinf(ticket.deadline)
                         else float(ticket.deadline)),
            "budget": int(ticket.budget), "steps": int(ticket.steps_done),
            "payload": _journal_enc(ticket.resume),
        })

    def mutation(self, *, version: int, parent_hash: str, content_hash: str,
                 adds, add_w, dels) -> None:
        """Log one graph delta: ``adds``/``dels`` are (k, 2) (src, dst)
        pair arrays; the parent/content hashes chain the versions."""
        self.append({
            "type": "mutation", "version": int(version),
            "parent_hash": str(parent_hash),
            "content_hash": str(content_hash),
            "adds": _journal_enc(np.asarray(adds, np.int32).reshape(-1, 2)),
            "add_w": _journal_enc(np.asarray(add_w)),
            "dels": _journal_enc(np.asarray(dels, np.int32).reshape(-1, 2)),
        })

    def close(self) -> None:
        if self._f is not None:
            self._f.close()

    @property
    def bytes_written(self) -> int:
        if self._f is None:
            return 0
        self._f.flush()
        return os.path.getsize(self.path)

    @staticmethod
    def replay(path: str) -> list[dict]:
        """Decoded records in append order, stopping at the first line that
        is torn or fails its checksum (everything before it is intact by
        construction).  A missing file replays as empty."""
        if not os.path.exists(path):
            return []
        out = []
        with open(path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", errors="replace")
                digest, _, body = line.rstrip("\n").partition(" ")
                if not body or not raw.endswith(b"\n"):
                    break
                if hashlib.sha256(body.encode()).hexdigest() != digest:
                    break
                rec = json.loads(body)
                for key in ("query", "result", "payload", "adds", "add_w", "dels"):
                    if key in rec:
                        rec[key] = _journal_dec(rec[key])
                if rec.get("deadline") is None and rec["type"] in (
                    "submit", "snapshot"
                ):
                    rec["deadline"] = math.inf
                out.append(rec)
        return out


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass
class RoundOutcome:
    """What one executed round reports back — both arrays come from the
    program's single device->host sync."""

    done: np.ndarray   # (C,) bool — live slots that finished this round
    steps: np.ndarray  # (C,) int — cumulative supersteps of each slot's query


@dataclasses.dataclass
class ResumeAdmission:
    """A suspended query re-entering through batched admission: instead of
    a fresh query to ``init``, ``slot_round``'s admitted dict carries the
    original query plus the ``slot_suspend`` payload and the superstep
    counter to restore."""

    query: Any
    payload: Any  # whatever slot_suspend returned for this query
    steps: int    # cumulative supersteps already charged


class SlotProgram:
    """Device-side half of the slot lifecycle (see module docstring)."""

    def slot_validate(self, query) -> Optional[tuple[str, Any]]:
        """None to admit; (status, result) to reject without a slot."""
        return None

    def slot_round(self, admitted: dict[int, Any]) -> RoundOutcome:
        raise NotImplementedError

    def slot_collect(self, slots: list[int]) -> list[Any]:
        raise NotImplementedError

    def slot_evict(self, slots: list[int]) -> None:
        """Clear device-side liveness for budget-evicted slots.  State must
        survive until ``slot_collect`` (partial results)."""
        return None

    def slot_suspend(self, slots: list[int]) -> list[Any]:
        """Copy each live slot's full resumable state to the host and leave
        the slot inert (as after ``slot_evict``).  Returns one payload per
        slot; the runtime hands it back through admission as a
        ``ResumeAdmission``.  Resuming from the payload must be
        observationally equivalent to never having been suspended."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement slot_suspend: "
            "preemptive scheduling needs a program that can extract and "
            "restore per-slot state"
        )

    def slot_register_resume(self, payload) -> None:
        """A journal-replayed suspend payload re-entered the queue
        (``SlotRuntime.restore_pending``): check that it can be resumed."""
        return None

    def slot_observe(self) -> None:
        return None

    def cache_key(self, query) -> str:
        return default_cache_key(query)

    def cache_key_for_slot(self, query, slot: int) -> str:
        return self.cache_key(query)


# ------------------------------------------------------------------- runtime
class SlotRuntime:
    """Owns the query queue, admission, round loop, retirement and stats
    for one slot table; the program owns the device."""

    def __init__(
        self,
        program: SlotProgram,
        capacity: int,
        *,
        scheduler: Any = "fifo",
        stats: Optional[SlotStats] = None,
        cache_size: Optional[int] = None,
        preemptive: bool = False,
        preempt_margin: float = 0.0,
        journal: Optional[QueryJournal] = None,
        snapshot_every: int = 0,
        straggler: Any = None,
        max_retries: int = 2,
    ):
        """``journal`` logs every submit/retire (and snapshot);
        ``snapshot_every=N`` journals all live slots' resumable state every
        N executed rounds (0 = only on explicit ``snapshot()``);
        ``straggler`` is a ``train/fault.py::StragglerMonitor`` fed
        per-round wall time; ``max_retries`` bounds fresh re-admissions of
        a query whose extracted result carries non-finite floats before it
        retires as ``POISONED``."""
        self.program = program
        self.capacity = int(capacity)
        self.scheduler = make_scheduler(scheduler)
        self.preemptive = bool(preemptive)
        self.preempt_margin = float(preempt_margin)
        self.journal = journal
        self.snapshot_every = int(snapshot_every)
        self.straggler = straggler
        self.max_retries = int(max_retries)
        if self.preemptive and not self.scheduler.supports_preemption:
            raise ValueError(
                f"scheduler '{self.scheduler.name}' cannot drive preemption: "
                "it has no rank to compare waiting against running queries "
                "(use priority/sjf/deadline, or a Scheduler with "
                "supports_preemption)"
            )
        self.stats = stats if stats is not None else SlotStats()
        self.results: dict[int, Any] = {}
        self.status: dict[int, str] = {}
        self.steps: dict[int, int] = {}
        # Host mirror of slot liveness: updated from the same RoundOutcome
        # every round already pays, so admission never touches the device.
        self.live = np.zeros(self.capacity, dtype=bool)
        self.cache = ResultCache(cache_size) if cache_size else None
        self._slot_ticket: dict[int, Ticket] = {}
        self._qid_key: dict[int, str] = {}
        # per-slot cumulative supersteps from the LAST RoundOutcome — what a
        # suspension at this round boundary charges the victim with
        self._last_steps = np.zeros(self.capacity, dtype=np.int64)
        self._n_suspended = 0
        self._next_qid = 0
        self._seq = 0
        # poison-quarantine backoff: (release_tick, ticket) pairs
        self._retry_q: list[tuple[int, Ticket]] = []
        self._ticks = 0
        # completions that retire off the round path (cache hits,
        # rejections), reported once by ``pump()``
        self._pump_buf: list[tuple[int, Any, str]] = []

    # ------------------------------------------------------------- client
    def submit(self, query, *, qid: Optional[int] = None, priority: int = 0,
               deadline: float = math.inf, budget: int = 0) -> int:
        """Queue a query.  ``budget`` is the declared superstep budget: the
        sjf size estimate AND the TIMEOUT eviction bound (0 = unlimited)."""
        if qid is None:
            qid = self._next_qid
            self._next_qid += 1
        self._next_qid = max(self._next_qid, qid + 1)
        t = time.perf_counter()
        if self.cache is not None:
            key = self.program.cache_key(query)
            hit = self.cache.get(key)
            if hit is not _MISS:
                self.results[qid] = hit
                self.status[qid] = DONE
                self.steps[qid] = 0
                self.stats.cache_hits += 1
                self.stats.queries_done += 1
                elapsed = time.perf_counter() - t
                self.stats.query_latencies.append(elapsed)
                self.stats.queue_waits.append(0.0)
                self.stats.service_times.append(elapsed)
                self._pump_buf.append((qid, hit, DONE))
                if self.journal is not None:
                    # the full lifecycle even for a cache hit, so replay
                    # needs no cache state
                    self.journal.submit(qid, query, priority=priority,
                                        deadline=deadline, budget=budget,
                                        seq=self._seq)
                    self.journal.retire(qid, DONE, 0, hit)
                return qid
            self._qid_key[qid] = key
        if self.journal is not None:
            self.journal.submit(qid, query, priority=priority,
                                deadline=deadline, budget=budget, seq=self._seq)
        self.scheduler.push(
            Ticket(qid, query, int(priority), float(deadline), int(budget),
                   submit_t=t, seq=self._seq)
        )
        self._seq += 1
        return qid

    def pending(self) -> int:
        return len(self.scheduler) + len(self._retry_q)

    def slot_of(self, qid: int) -> Optional[int]:
        """The live slot running ``qid`` (None if not live)."""
        for s, tk in self._slot_ticket.items():
            if tk.qid == qid and self.live[s]:
                return s
        return None

    def inflight(self) -> int:
        """Queries holding state: live slots + suspended.  Can exceed
        ``capacity`` under preemption."""
        return int(self.live.sum()) + self._n_suspended

    def suspend(self, slots: list[int]) -> None:
        """Suspend live slots at this round boundary: copy their resumable
        state to the host (``slot_suspend``), free the slots, and re-queue
        the queries as resume tickets carrying their cumulative superstep
        count (the paper's console suspend; preemption uses it too)."""
        slots = [int(s) for s in slots]
        for s in slots:
            if not (0 <= s < self.capacity) or not self.live[s]:
                raise ValueError(f"cannot suspend slot {s}: not live")
        self.stats.preemptions += len(self._suspend_into_queue(slots))

    def _suspend_into_queue(self, slots: list[int]) -> list[Ticket]:
        """Shared core of ``suspend`` and ``snapshot``; returns the pushed
        tickets (payload attached) so callers can journal them."""
        payloads = self.program.slot_suspend(slots)
        pushed = []
        for s, payload in zip(slots, payloads):
            tk = self._slot_ticket.pop(s)
            self.live[s] = False
            tk = dataclasses.replace(
                tk, resume=payload, steps_done=int(self._last_steps[s]))
            self.scheduler.push(tk)
            self._n_suspended += 1
            pushed.append(tk)
        return pushed

    def snapshot(self) -> int:
        """Journal a resumable snapshot of every live slot and re-queue
        them as resume tickets.  It reuses the suspend path, so by the
        suspend/resume parity invariant a snapshot never changes any
        query's result, status or step count; on recovery the journaled
        payload re-enters admission directly.  Returns the number of slots
        snapshotted."""
        live = [s for s in range(self.capacity) if self.live[s]]
        if not live:
            return 0
        for tk in self._suspend_into_queue(live):
            if self.journal is not None:
                self.journal.snapshot(tk)
        self.stats.snapshots += 1
        return len(live)

    def _admit_from_queue(self, free: list[int], admitted: dict) -> None:
        """Pop tickets into free slots.  Resume tickets skip validation
        (they were validated at first admission) and re-enter as
        ``ResumeAdmission`` so the program restores state instead of
        running ``init``."""
        while free and len(self.scheduler):
            tk = self.scheduler.pop()
            if tk.resume is None:
                rej = self.program.slot_validate(tk.query)
                if rej is not None:
                    status, res = rej
                    self.results[tk.qid] = res
                    self.status[tk.qid] = status
                    self.steps[tk.qid] = 0
                    self.stats.rejected += 1
                    self._qid_key.pop(tk.qid, None)
                    if self.journal is not None:
                        self.journal.retire(tk.qid, status, 0, res)
                    self._pump_buf.append((tk.qid, res, status))
                    continue
            slot = free.pop()
            if tk.admit_t == 0.0:
                tk = dataclasses.replace(tk, admit_t=time.perf_counter())
            if tk.resume is None:
                admitted[slot] = tk.query
            else:
                admitted[slot] = ResumeAdmission(tk.query, tk.resume, tk.steps_done)
                self._n_suspended -= 1
                self.stats.resumes += 1
                tk = dataclasses.replace(tk, resume=None)  # payload handed off
            self._slot_ticket[slot] = tk
            self._last_steps[slot] = tk.steps_done
            self.live[slot] = True

    def _preempt(self, admitted: dict) -> None:
        """Round-boundary preemption: pair the best waiting keys against
        the worst-ranked running queries; every pairing the waiting side
        wins by more than ``preempt_margin`` suspends the running query
        and hands its slot to the queue.  Freshly admitted slots are never
        victims."""
        sched = self.scheduler
        running = [s for s in range(self.capacity)
                   if self.live[s] and s not in admitted]
        if not running or not len(sched):
            return
        rank = {s: sched.running_key(self._slot_ticket[s], int(self._last_steps[s]))
                for s in running}
        # worst first; among equals prefer the later-submitted victim
        running.sort(key=lambda s: (rank[s], self._slot_ticket[s].seq), reverse=True)
        victims = []
        for wkey, s in zip(sched.waiting_keys(len(running)), running):
            if wkey < rank[s] - self.preempt_margin:
                victims.append(s)
            else:
                break
        if victims:
            self.suspend(victims)
            self._admit_from_queue(victims, admitted)

    @staticmethod
    def _has_nonfinite(result) -> bool:
        """True when any float leaf of ``result`` holds NaN/Inf (the int
        lanes saturate at the finite ``semiring.INF`` sentinel, so
        non-finite floats are unambiguous corruption)."""
        for leaf in tree_leaves(result):
            arr = to_numpy(leaf)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return True
        return False

    def _abandon_live_slots(self) -> None:
        """An exception escaped the program mid-round: mark all live slots
        dead, best-effort clear device liveness, and re-queue their tickets
        as FRESH admissions (a deterministic program recomputes the same
        result, and the step meter restarts at 0)."""
        live = [s for s in range(self.capacity) if self.live[s]]
        if not live:
            return
        try:
            self.program.slot_evict(live)
        except Exception:
            pass  # the device may be gone entirely; host cleanup still runs
        for s in live:
            tk = self._slot_ticket.pop(s)
            self.live[s] = False
            self.scheduler.push(dataclasses.replace(tk, resume=None, steps_done=0))
        self.stats.round_failures += 1

    def _release_retries(self) -> None:
        ready = [(rt, tk) for rt, tk in self._retry_q if rt <= self._ticks]
        if not ready:
            return
        self._retry_q = [(rt, tk) for rt, tk in self._retry_q
                         if rt > self._ticks]
        for _, tk in ready:
            self.scheduler.push(tk)

    def run_round(self) -> Optional[list[tuple[int, Any, str]]]:
        """Admit (+ preempt) + one program round + retire.  Returns the
        retired [(qid, result, status)] — empty if the round completed
        nothing — or None when there was nothing to run."""
        t0 = time.perf_counter()
        self._ticks += 1
        self._release_retries()
        admitted: dict[int, Any] = {}
        free = [i for i in range(self.capacity) if not self.live[i]]
        self._admit_from_queue(free, admitted)
        if self.preemptive:
            self._preempt(admitted)
        if not self.live.any():
            return None
        self.stats.max_inflight = max(self.stats.max_inflight, self.inflight())
        occupancy = int(self.live.sum())
        try:
            out = self.program.slot_round(admitted)
            t_done = time.perf_counter()
            done = np.asarray(out.done)
            steps = np.asarray(out.steps)
            # live slots only: a free slot's device counter is stale
            self._last_steps[self.live] = steps[self.live]
            finished = [int(s) for s in np.nonzero(done & self.live)[0]]
            evicted = [
                s
                for s in range(self.capacity)
                if self.live[s]
                and not done[s]
                and self._slot_ticket[s].budget > 0
                and int(steps[s]) >= self._slot_ticket[s].budget
            ]
            if evicted:
                self.program.slot_evict(evicted)
            retiring = finished + evicted
            collected = (
                self.program.slot_collect(retiring) if retiring else []
            )
        except Exception:
            self._abandon_live_slots()
            raise
        completed: list[tuple[int, Any, str]] = []
        for slot, res in zip(retiring, collected):
            tk = self._slot_ticket.pop(slot)
            self.live[slot] = False
            if self._has_nonfinite(res):
                # Poison quarantine: retry from scratch with exponential
                # backoff, and only after max_retries give up as POISONED.
                if tk.attempts < self.max_retries:
                    retry = dataclasses.replace(
                        tk, resume=None, steps_done=0, attempts=tk.attempts + 1)
                    self._retry_q.append((self._ticks + 2 ** tk.attempts, retry))
                    self.stats.poison_retries += 1
                    continue
                self.results[tk.qid] = res
                self.status[tk.qid] = POISONED
                self.steps[tk.qid] = int(steps[slot])
                self.stats.poisoned += 1
                self._qid_key.pop(tk.qid, None)
                if self.journal is not None:
                    self.journal.retire(tk.qid, POISONED, int(steps[slot]), res)
                completed.append((tk.qid, res, POISONED))
                continue
            status = DONE if slot in finished else TIMEOUT
            self.results[tk.qid] = res
            self.status[tk.qid] = status
            self.steps[tk.qid] = int(steps[slot])
            self.stats.supersteps_total += int(steps[slot])
            if status == DONE:
                self.stats.queries_done += 1
                self.stats.query_latencies.append(t_done - tk.submit_t)
                admit = tk.admit_t if tk.admit_t > 0.0 else tk.submit_t
                self.stats.queue_waits.append(max(0.0, admit - tk.submit_t))
                self.stats.service_times.append(
                    (t_done - tk.submit_t) - max(0.0, admit - tk.submit_t))
                key = self._qid_key.pop(tk.qid, None)
                if self.cache is not None and key is not None:
                    self.cache.put(
                        self.program.cache_key_for_slot(tk.query, slot), res)
            else:
                self.stats.timeouts += 1
                self._qid_key.pop(tk.qid, None)
            if self.journal is not None:
                self.journal.retire(tk.qid, status, int(steps[slot]), res)
            completed.append((tk.qid, res, status))
        self.stats.rounds += 1
        self.stats.slot_occupancy.append(occupancy)
        self.program.slot_observe()
        dt = time.perf_counter() - t0
        self.stats.round_times.append(dt)
        if self.straggler is not None and self.straggler.record(self.stats.rounds, dt):
            self.stats.straggler_rounds += 1
        if (self.snapshot_every > 0 and self.journal is not None
                and self.stats.rounds % self.snapshot_every == 0):
            self.snapshot()
        return completed

    # ------------------------------------------------------------ open loop
    def pump(self) -> list[tuple[int, Any, str]]:
        """Non-blocking open-loop step: flush off-round completions, then —
        only if there is admissible or live work — advance exactly one
        round.  Returns every terminal ``(qid, result, status)`` since the
        last pump; each qid is reported exactly once."""
        out: list[tuple[int, Any, str]] = []
        if self._pump_buf:
            out.extend(self._pump_buf)
            self._pump_buf.clear()
        if self.pending() or self.live.any():
            out.extend(self.run_round() or [])
            if self._pump_buf:
                out.extend(self._pump_buf)
                self._pump_buf.clear()
        return out

    def poll(self, qid: int) -> Optional[tuple[str, Any]]:
        """``(status, result)`` once ``qid`` is terminal, else None."""
        st = self.status.get(qid)
        if st is None:
            return None
        return st, self.results.get(qid)

    # ------------------------------------------------------------ recovery
    def restore_retired(self, qid: int, status: str, result, steps: int) -> None:
        """Install a journal-replayed terminal query without re-running it
        (launch/supervise.py).  Counters advance as the original run did."""
        self.results[qid] = result
        self.status[qid] = status
        self.steps[qid] = int(steps)
        self.stats.replayed += 1
        if status == DONE:
            self.stats.queries_done += 1
            self.stats.supersteps_total += int(steps)
        elif status == TIMEOUT:
            self.stats.timeouts += 1
            self.stats.supersteps_total += int(steps)
        elif status == REJECTED:
            self.stats.rejected += 1
        elif status == POISONED:
            self.stats.poisoned += 1
        self._next_qid = max(self._next_qid, qid + 1)

    def restore_pending(self, qid: int, query, *, priority: int = 0,
                        deadline: float = math.inf, budget: int = 0,
                        seq: Optional[int] = None, payload: Any = None,
                        steps_done: int = 0) -> None:
        """Re-enter a journal-replayed in-flight query: with a snapshot
        ``payload`` it resumes through batched admission like a suspended
        query (steps charged so far intact); without one it re-runs from
        scratch under its original scheduling attributes and qid.  Does
        NOT journal: the original submit record is already in the log."""
        seq = self._seq if seq is None else int(seq)
        tk = Ticket(int(qid), query, int(priority), float(deadline),
                    int(budget), submit_t=time.perf_counter(), seq=seq,
                    steps_done=int(steps_done), resume=payload)
        self.scheduler.push(tk)
        if payload is not None:
            # _admit_from_queue decrements the count when it re-enters
            self._n_suspended += 1
            self.program.slot_register_resume(payload)
        self._next_qid = max(self._next_qid, qid + 1)
        self._seq = max(self._seq, seq + 1)

    def run_until_drained(self, max_rounds: int = 100_000) -> dict[int, Any]:
        """Batch-querying mode (paper scenario ii)."""
        rounds = 0
        while (self.pending() or self.live.any()) and rounds < max_rounds:
            self.run_round()
            rounds += 1
        return dict(self.results)
