"""Open-loop load generation for the slot-table runtime, in the port.

A copy of the JAX package's ``launch/loadgen.py`` (numpy only, so the
same code serves both packages; the port keeps its own copy because it
imports nothing of the JAX package).  The arrival arrays are bit-equal to
the JAX module's for the same arguments, and under the virtual clock a
run's ticks, latencies and backlog depend only on the target's round
schedule, which the port's engine shares with the JAX engine.

Every bench before the JAX module was closed-loop: submit a batch, drain
it, report wall time.  Quegel's whole point is the opposite regime —
light queries *arrive continuously* and share supersteps
(arXiv:1601.06497), and the graph-systems evaluation literature (Ammar &
Özsu, arXiv:1806.08082) singles out sustained-offered-load behavior as
the measurement that distinguishes serving systems.  This module
generates that load:

* **Arrival processes** — ``poisson_arrivals`` (memoryless, the classic
  open-loop model), ``constant_arrivals`` (deterministic spacing), and
  ``mmpp_arrivals`` (2-state Markov-modulated Poisson: a hot state and a
  cold state with exponential dwells — bursty traffic whose *long-run*
  rate still equals the requested one).  All are seeded and reproducible.
* **A virtual clock** — ``run_open_loop(..., clock="virtual")`` counts one
  tick per ``pump()`` round, fast-forwarding across idle gaps.  Latencies
  in ticks are then fully deterministic (independent of host speed and of
  the propagation plan).  ``clock="wall"`` replays the same arrival
  schedule against ``time.perf_counter`` with sleeps, for measuring real
  latency against a live target.
* **A qps sweep** — ``sweep_qps`` re-runs the same workload at increasing
  offered rates and finds the **saturation knee**: the largest offered
  rate the target still serves at ≥ ``knee_tol`` of what was offered.

The target duck type is anything with ``submit(query, **kw) -> qid``,
``pump() -> [(qid, result, status)]``, ``pending()`` and ``inflight()`` —
``core/engine.py``'s ``QuegelEngine``, a bare ``SlotRuntime``, or
``launch/router.py``'s ``ReplicaPool``; the split of latency into queue
wait and service is read from ``runtime.stats.queue_waits`` and
``service_times``, and hits from ``runtime.stats.cache_hits``.

Offered vs achieved vs delivered: ``achieved_qps`` (completions over the
arrival-to-last-completion makespan) is *always* slightly below offered at
low load because the makespan includes the tail of the last query's
service — the open-loop analogue of flushing a pipeline.  ``busy_qps``
(completions per tick in which the target had work) is the delivered
capacity; "the target keeps up" means ``busy_qps >= offered_qps``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np


# --------------------------------------------------------------- arrivals
def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """``n`` arrival times with Exp(1/rate) inter-arrival gaps."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate, int(n)))


def constant_arrivals(rate: float, n: int, *, seed: int = 0,
                      start: float = 0.0) -> np.ndarray:
    """Deterministic spacing: arrival i at ``start + (i+1)/rate``.  The
    ``seed`` argument is accepted (and ignored) so every process shares
    one signature."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    return start + (np.arange(int(n), dtype=np.float64) + 1.0) / rate


def mmpp_arrivals(rate: float, n: int, *, seed: int = 0, start: float = 0.0,
                  burst: float = 4.0, dwell: float = 8.0) -> np.ndarray:
    """2-state Markov-modulated Poisson process: alternate a hot state
    (rate ``burst * b``) and a cold state (rate ``b / burst``) with
    Exp(``dwell``)-mean dwell times.  ``b`` is chosen so the long-run mean
    rate equals ``rate`` (equal expected time in both states):
    ``(burst*b + b/burst) / 2 == rate``."""
    if rate <= 0 or burst < 1.0 or dwell <= 0:
        raise ValueError("need rate > 0, burst >= 1, dwell > 0")
    rng = np.random.default_rng(seed)
    b = 2.0 * rate / (burst + 1.0 / burst)
    state_rates = (burst * b, b / burst)
    out: list[float] = []
    t = float(start)
    state = 0  # start hot: bursty from the first arrival
    while len(out) < n:
        t_end = t + rng.exponential(dwell)
        r = state_rates[state]
        while len(out) < n:
            t_next = t + rng.exponential(1.0 / r)
            if t_next > t_end:
                break
            out.append(t_next)
            t = t_next
        t = t_end
        state = 1 - state
    return np.asarray(out, dtype=np.float64)


ARRIVALS: dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "constant": constant_arrivals,
    "mmpp": mmpp_arrivals,
}


def make_arrivals(process: str, rate: float, n: int, *, seed: int = 0,
                  **kw) -> np.ndarray:
    if process not in ARRIVALS:
        raise ValueError(
            f"unknown arrival process {process!r}: expected one of "
            f"{sorted(ARRIVALS)}"
        )
    return ARRIVALS[process](rate, n, seed=seed, **kw)


# ------------------------------------------------------------------ result
@dataclasses.dataclass
class LoadResult:
    """One open-loop run: offered load in, latency distribution out.

    Virtual-clock time unit is one ``pump()`` round; wall-clock unit is
    seconds.  ``latencies``/``statuses`` are per-query in submission
    order.  ``queue_waits``/``service_times`` are the runtime's wall-time
    split (DESIGN.md §11), collected as the delta accrued during the run.
    """

    clock: str
    n: int
    offered_qps: float
    achieved_qps: float     # n / (last completion - first arrival)
    busy_qps: float         # completions per tick with work (capacity)
    makespan: float
    ticks: int              # pump() calls that found work
    latencies: list = dataclasses.field(default_factory=list)
    statuses: dict = dataclasses.field(default_factory=dict)
    max_backlog: int = 0    # peak pending() over the run
    cache_hits: int = 0
    queue_waits: list = dataclasses.field(default_factory=list)
    service_times: list = dataclasses.field(default_factory=list)

    def latency_percentile(self, q: float) -> float:
        if not self.latencies:
            return float("nan")
        return float(np.percentile(self.latencies, q))

    def summary(self) -> dict:
        """JSON-able cell for BENCH tables."""
        pct = self.latency_percentile
        wpct = (lambda q: float(np.percentile(self.queue_waits, q))
                if self.queue_waits else float("nan"))
        spct = (lambda q: float(np.percentile(self.service_times, q))
                if self.service_times else float("nan"))
        return {
            "clock": self.clock,
            "n": self.n,
            "offered_qps": float(self.offered_qps),
            "achieved_qps": float(self.achieved_qps),
            "busy_qps": float(self.busy_qps),
            "makespan": float(self.makespan),
            "ticks": int(self.ticks),
            "lat_p50": pct(50), "lat_p95": pct(95), "lat_p99": pct(99),
            "lat_mean": (float(np.mean(self.latencies))
                         if self.latencies else float("nan")),
            "max_backlog": int(self.max_backlog),
            "cache_hits": int(self.cache_hits),
            "qwait_p50_s": wpct(50), "qwait_p95_s": wpct(95),
            "service_p50_s": spct(50), "service_p95_s": spct(95),
            "statuses": dict(sorted(
                collections.Counter(self.statuses.values()).items()
            )),
        }


def _norm_item(item) -> tuple[Any, dict]:
    if isinstance(item, tuple) and len(item) == 2 and isinstance(item[1],
                                                                 dict):
        return item
    return item, {}


def _runtimes(target) -> list:
    """The SlotRuntimes behind a target (ReplicaPool -> one per replica;
    engine/server -> its runtime; bare runtime -> itself)."""
    if hasattr(target, "replicas"):
        return [r.runtime for r in target.replicas]
    return [getattr(target, "runtime", target)]


def _stats_mark(target) -> list[tuple[int, int]]:
    return [(len(rt.stats.queue_waits), len(rt.stats.service_times))
            for rt in _runtimes(target)]


def _stats_delta(target, marks) -> tuple[list, list]:
    qw: list = []
    sv: list = []
    for rt, (i, j) in zip(_runtimes(target), marks):
        qw.extend(rt.stats.queue_waits[i:])
        sv.extend(rt.stats.service_times[j:])
    return qw, sv


def _cache_hits(target) -> int:
    return sum(rt.stats.cache_hits for rt in _runtimes(target))


# ---------------------------------------------------------------- open loop
def run_open_loop(
    target,
    items: Sequence,
    arrivals: Sequence[float],
    *,
    clock: str = "virtual",
    offered_qps: Optional[float] = None,
    max_ticks: int = 1_000_000,
    sleep_floor: float = 1e-4,
) -> LoadResult:
    """Drive ``target`` with ``items[i]`` arriving at ``arrivals[i]``.

    Open loop: arrivals NEVER wait for completions — a slow target grows a
    backlog instead of slowing the generator down (the closed-loop
    coordinated-omission trap).  ``items`` are queries or ``(query,
    submit_kwargs)`` pairs.  Virtual clock: one tick per ``pump()``, idle
    gaps fast-forwarded, latency in ticks (deterministic).  Wall clock:
    ticks happen in real time with sleeps until the next arrival, latency
    in seconds measured from the *scheduled* arrival time.
    """
    if clock not in ("virtual", "wall"):
        raise ValueError(f"clock must be 'virtual' or 'wall', got {clock!r}")
    n = len(items)
    arr = np.asarray(arrivals, dtype=np.float64)
    if arr.shape != (n,):
        raise ValueError(f"need one arrival per item: {arr.shape} vs {n}")
    order = np.argsort(arr, kind="stable")
    if offered_qps is None:
        span = float(arr.max() - arr.min())
        offered_qps = (n - 1) / span if span > 0 and n > 1 else float("nan")

    marks = _stats_mark(target)
    hits0 = _cache_hits(target)
    submit_at: dict[int, float] = {}   # qid -> scheduled arrival time
    done_at: dict[int, float] = {}
    statuses: dict[int, str] = {}
    max_backlog = 0
    ticks = 0
    i = 0  # next arrival index (into ``order``)

    def _submit_due(now: float) -> int:
        nonlocal i
        k = 0
        while i < n and arr[order[i]] <= now:
            q, kw = _norm_item(items[order[i]])
            qid = target.submit(q, **kw)
            submit_at[qid] = float(arr[order[i]])
            i += 1
            k += 1
        return k

    if clock == "virtual":
        now = 0.0
        while len(done_at) < n:
            # truly idle (no queue, no slots, no unflushed completions):
            # fast-forward to the next arrival without burning ticks
            if (i < n and len(submit_at) == len(done_at)
                    and not target.pending() and not target.inflight()
                    and arr[order[i]] > now):
                now = float(arr[order[i]])
            _submit_due(now)
            max_backlog = max(max_backlog, target.pending())
            completions = target.pump()
            ticks += 1
            now += 1.0
            for qid, _res, status in completions:
                done_at[qid] = now
                statuses[qid] = status
            if ticks > max_ticks:
                raise RuntimeError(
                    f"open-loop run exceeded {max_ticks} ticks with "
                    f"{n - len(done_at)} queries outstanding"
                )
    else:
        t0 = time.perf_counter()
        while len(done_at) < n:
            now = time.perf_counter() - t0
            _submit_due(now)
            if (i < n and len(submit_at) == len(done_at)
                    and not target.pending() and not target.inflight()):
                gap = arr[order[i]] - (time.perf_counter() - t0)
                if gap > 0:
                    time.sleep(max(sleep_floor, min(gap, 0.05)))
                    continue
            max_backlog = max(max_backlog, target.pending())
            completions = target.pump()
            ticks += 1
            tnow = time.perf_counter() - t0
            for qid, _res, status in completions:
                done_at[qid] = tnow
                statuses[qid] = status
            if ticks > max_ticks:
                raise RuntimeError(
                    f"open-loop run exceeded {max_ticks} ticks with "
                    f"{n - len(done_at)} queries outstanding"
                )

    latencies = [done_at[qid] - submit_at[qid] for qid in sorted(done_at)]
    makespan = max(done_at.values()) - float(arr.min()) if done_at else 0.0
    qw, sv = _stats_delta(target, marks)
    return LoadResult(
        clock=clock,
        n=n,
        offered_qps=float(offered_qps),
        achieved_qps=n / makespan if makespan > 0 else float("nan"),
        busy_qps=n / ticks if ticks else float("nan"),
        makespan=float(makespan),
        ticks=ticks,
        latencies=latencies,
        statuses=statuses,
        max_backlog=int(max_backlog),
        cache_hits=_cache_hits(target) - hits0,
        queue_waits=qw,
        service_times=sv,
    )


# -------------------------------------------------------------------- sweep
def saturation_knee(curve: dict[float, dict], *, tol: float = 0.9) -> float:
    """Largest offered rate still served at ``delivered >= tol * offered``
    — reading the latency-throughput curve for the provisioning number.
    Delivered capacity is ``busy_qps`` (``achieved_qps`` as fallback for
    hand-built curves): achieved always trails offered by the drain tail,
    so it would report saturation even when the target keeps up.
    ``curve`` maps offered rate -> LoadResult.summary() cell.  NaN when no
    point keeps up."""
    ok = [r for r, cell in curve.items()
          if cell.get("busy_qps", cell.get("achieved_qps", 0.0)) >= tol * r]
    return float(max(ok)) if ok else float("nan")


def sweep_qps(
    make_target: Callable[[], Any],
    items: Sequence,
    rates: Sequence[float],
    *,
    process: str = "poisson",
    seed: int = 0,
    clock: str = "virtual",
    knee_tol: float = 0.9,
    reset_stats: bool = True,
    **arrival_kw,
) -> dict:
    """Run the same workload at each offered rate; return
    ``{"curve": {rate: cell}, "knee": rate}``.  ``make_target`` is called
    once per sweep point — return a fresh target, or the same warm one
    (virtual-clock latencies are deterministic either way; reusing skips
    re-jitting).  With ``reset_stats`` the target's SlotStats are replaced
    so wall-time splits stay per-point."""
    curve: dict[float, dict] = {}
    for rate in rates:
        target = make_target()
        if reset_stats:
            for rt in _runtimes(target):
                rt.stats = type(rt.stats)()
        arr = make_arrivals(process, rate, len(items), seed=seed,
                            **arrival_kw)
        res = run_open_loop(target, items, arr, clock=clock,
                            offered_qps=rate)
        curve[float(rate)] = res.summary()
    return {"curve": curve, "knee": saturation_knee(curve, tol=knee_tol)}
