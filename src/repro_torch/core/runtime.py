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
non-finite quarantine, and the open-loop ``pump``/``poll`` face.

Preemption, the query journal and snapshots are not ported yet
(ROADMAP.md §1, *Preemption* and *Store, journal and recovery*); their
arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import heapq
import math
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


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of one or more same-structure pytrees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__ + "(" + ",".join(_treedef(v) for v in tree) + ")"
    return "*"


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
    max_inflight: int = 0
    poison_retries: int = 0
    poisoned: int = 0
    round_failures: int = 0
    round_times: list = dataclasses.field(default_factory=list)
    # per-query submit->result latency, split at the first admission into
    # queue wait and service (appended in lockstep, DONE only)
    query_latencies: list = dataclasses.field(default_factory=list)
    queue_waits: list = dataclasses.field(default_factory=list)
    service_times: list = dataclasses.field(default_factory=list)
    # live slots per executed round
    slot_occupancy: list = dataclasses.field(default_factory=list)

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
    admit_t: float = 0.0      # wall time of the first slot admission
    seq: int = 0              # submission order; ties break FIFO
    steps_done: int = 0       # supersteps already charged
    attempts: int = 0         # poison-quarantine re-admissions consumed


class Scheduler:
    """Admission-order policy over queued tickets: only the pop order
    differs between implementations."""

    name = "base"

    def push(self, ticket: Ticket) -> None:
        raise NotImplementedError

    def pop(self) -> Ticket:
        raise NotImplementedError

    def __len__(self) -> int:
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


class PriorityScheduler(_HeapScheduler):
    """User-supplied levels; lower ``priority`` is admitted first."""

    name = "priority"

    def key(self, t: Ticket):
        return t.priority


class SJFScheduler(_HeapScheduler):
    """Shortest-job-first by declared remaining superstep budget;
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
        arr = to_numpy(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


_MISS = object()


class ResultCache:
    """LRU of extracted results keyed by canonicalized query hash
    (``<graph content hash>:<query hash>`` for the engine).  Invalidation
    by graph version comes with the mutation slice (ROADMAP.md §1,
    *Mutable graphs*)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("result cache size must be >= 1")
        self.size = int(size)
        self._d: collections.OrderedDict[str, Any] = collections.OrderedDict()

    def get(self, key: str):
        if key not in self._d:
            return _MISS
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: str, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.size:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


# Runtime options of the JAX package that later slices port, with the title
# of the ROADMAP.md §1 queue item that carries each.
_NOT_PORTED = {"preemptive": "Preemption", "journal": "Store, journal and recovery",
               "snapshot_every": "Store, journal and recovery"}


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass
class RoundOutcome:
    """What one executed round reports back — both arrays come from the
    program's single device->host sync."""

    done: np.ndarray   # (C,) bool — live slots that finished this round
    steps: np.ndarray  # (C,) int — cumulative supersteps of each slot's query


@dataclasses.dataclass
class ResumeAdmission:
    """A suspended query re-entering through batched admission (the
    preemption path, not ported yet: ROADMAP.md §1, *Preemption*)."""

    query: Any
    payload: Any
    steps: int


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
        max_retries: int = 2,
        preemptive: bool = False,
        journal: Any = None,
        snapshot_every: int = 0,
    ):
        """``max_retries`` bounds fresh re-admissions of a query whose
        extracted result carries non-finite floats before it retires as
        ``POISONED``."""
        for name, val in (("preemptive", preemptive), ("journal", journal),
                          ("snapshot_every", snapshot_every)):
            if val:
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP.md §1, *{_NOT_PORTED[name]}*")
        self.program = program
        self.capacity = int(capacity)
        self.scheduler = make_scheduler(scheduler)
        self.max_retries = int(max_retries)
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
                return qid
            self._qid_key[qid] = key
        self.scheduler.push(
            Ticket(qid, query, int(priority), float(deadline), int(budget),
                   submit_t=t, seq=self._seq)
        )
        self._seq += 1
        return qid

    def pending(self) -> int:
        return len(self.scheduler) + len(self._retry_q)

    def inflight(self) -> int:
        return int(self.live.sum())

    def _admit_from_queue(self, free: list[int], admitted: dict) -> None:
        while free and len(self.scheduler):
            tk = self.scheduler.pop()
            rej = self.program.slot_validate(tk.query)
            if rej is not None:
                status, res = rej
                self.results[tk.qid] = res
                self.status[tk.qid] = status
                self.steps[tk.qid] = 0
                self.stats.rejected += 1
                self._qid_key.pop(tk.qid, None)
                self._pump_buf.append((tk.qid, res, status))
                continue
            slot = free.pop()
            if tk.admit_t == 0.0:
                tk = dataclasses.replace(tk, admit_t=time.perf_counter())
            admitted[slot] = tk.query
            self._slot_ticket[slot] = tk
            self.live[slot] = True

    @staticmethod
    def _has_nonfinite(result) -> bool:
        """True when any float leaf of ``result`` holds NaN/Inf."""
        for leaf in tree_leaves(result):
            arr = to_numpy(leaf)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return True
        return False

    def _abandon_live_slots(self) -> None:
        """An exception escaped the program mid-round: mark all live slots
        dead, best-effort clear device liveness, and re-queue their tickets
        as fresh admissions."""
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
            self.scheduler.push(dataclasses.replace(tk, steps_done=0))
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
        """Admit + one program round + retire.  Returns the retired
        [(qid, result, status)] — empty if the round completed nothing —
        or None when there was nothing to run."""
        t0 = time.perf_counter()
        self._ticks += 1
        self._release_retries()
        admitted: dict[int, Any] = {}
        free = [i for i in range(self.capacity) if not self.live[i]]
        self._admit_from_queue(free, admitted)
        if not self.live.any():
            return None
        self.stats.max_inflight = max(self.stats.max_inflight, self.inflight())
        occupancy = int(self.live.sum())
        try:
            out = self.program.slot_round(admitted)
            t_done = time.perf_counter()
            done = np.asarray(out.done)
            steps = np.asarray(out.steps)
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
                        tk, steps_done=0, attempts=tk.attempts + 1)
                    self._retry_q.append((self._ticks + 2 ** tk.attempts, retry))
                    self.stats.poison_retries += 1
                    continue
                self.results[tk.qid] = res
                self.status[tk.qid] = POISONED
                self.steps[tk.qid] = int(steps[slot])
                self.stats.poisoned += 1
                self._qid_key.pop(tk.qid, None)
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
            completed.append((tk.qid, res, status))
        self.stats.rounds += 1
        self.stats.slot_occupancy.append(occupancy)
        self.program.slot_observe()
        self.stats.round_times.append(time.perf_counter() - t0)
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

    def run_until_drained(self, max_rounds: int = 100_000) -> dict[int, Any]:
        """Batch-querying mode (paper scenario ii)."""
        rounds = 0
        while (self.pending() or self.live.any()) and rounds < max_rounds:
            self.run_round()
            rounds += 1
        return dict(self.results)
