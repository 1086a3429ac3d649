"""Preemption in the port against the JAX package: suspend/resume parity
and preemptive scheduling.

A query suspended at any round boundary and resumed later must be
observationally equivalent to one never suspended: identical result,
terminal status and cumulative superstep count.  Every cell of the
(app x scheduler x steps_per_round) matrix runs the port uninterrupted and
under three adversarial suspension schedules, and every fingerprint must
equal the JAX engine's uninterrupted one on the same graph and queries.
The preemptive tests compare retirement orders and preemption counts with
the JAX engine's preemptive run."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import ppsp as jppsp
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph

from repro_torch.apps import ppsp
from repro_torch.core.runtime import DONE, TIMEOUT, SlotProgram, SlotRuntime

from _torch_common import port_graph

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihypothesis import given, settings, strategies as st

MAKERS = {"bfs": (jppsp.make_bfs_engine, ppsp.make_bfs_engine),
          "bibfs": (jppsp.make_bibfs_engine, ppsp.make_bibfs_engine)}
SCHEDULERS = ["fifo", "priority", "sjf", "deadline"]


@functools.lru_cache(maxsize=None)
def _matrix_graph():
    """The JAX tests' 60-vertex graph: a 48-vertex random core and a
    12-vertex path tail (48 -> ... -> 59) whose queries are genuinely
    heavy, so budget eviction fires even at steps_per_round=4."""
    g = random_graph(48, 3.0, seed=1, directed=True)
    src = np.concatenate([np.asarray(g.src), np.arange(48, 59)])
    dst = np.concatenate([np.asarray(g.dst), np.arange(49, 60)])
    return JGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), 60)


@functools.lru_cache(maxsize=None)
def _small_directed():
    return random_graph(60, 3.0, seed=1, directed=True)


@functools.lru_cache(maxsize=None)
def _path_graph(n=60):
    """Directed path 0->1->...->n-1: BFS runtime == requested distance, so
    budgets are honest job sizes and heavies really convoy."""
    src = np.arange(n - 1, dtype=np.int32)
    return JGraph.from_edges(src, src + 1, n)


def _engines(app, g, **kw):
    """(JAX engine, port engine on the CPU) for the same graph and options."""
    jmake, make = MAKERS[app]
    return jmake(g, **kw), make(port_graph(g), device="cpu", **kw)


def _submits(g, n=6, seed=3, heavy=False):
    """The JAX harness's mixed workload: budgets that evict mid-flight,
    generous budgets, and priority/deadline keys for every scheduler."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, min(g.n_real, 48), (n, 2))
    subs = []
    for i, (a, b) in enumerate(pairs):
        kw = dict(priority=int(rng.integers(0, 3)), deadline=float(i % 4))
        if i % 3 == 1:
            kw["budget"] = 2
        elif i % 3 == 2:
            kw["budget"] = 64
        subs.append((np.asarray([int(a), int(b)], np.int32), kw))
    if heavy:
        subs.append((np.asarray([48, 59], np.int32), dict(budget=4, deadline=2.0)))
        subs.append((np.asarray([48, 57], np.int32), dict(budget=64, priority=1)))
    return subs


def _fingerprint(eng):
    res = {q: {k: np.asarray(v).tolist() for k, v in r.items()}
           for q, r in eng.runtime.results.items()}
    return res, dict(eng.runtime.status), dict(eng.runtime.steps)


def _drain(eng, submits, suspend_at=None):
    """Drive round by round, suspending live slots per ``suspend_at``
    ({round index: "all" | [slot, ...]}) after that round executes.
    Returns (fingerprint, {qid: completion round})."""
    for q, kw in submits:
        eng.submit(q, **kw)
    completions = {}
    r = 0
    while len(eng.runtime.scheduler) or eng.runtime.live.any():
        seen = set(eng.runtime.results)
        eng.runtime.run_round()
        for qid in set(eng.runtime.results) - seen:
            completions[qid] = r
        sel = (suspend_at or {}).get(r)
        if sel is not None:
            live = [s for s in range(eng.capacity) if eng.runtime.live[s]]
            victims = live if sel == "all" else [s for s in live if s in sel]
            if victims:
                eng.runtime.suspend(victims)
        r += 1
        assert r < 10_000, "suspension schedule prevented progress"
    return _fingerprint(eng), completions


def _adversarial_schedules(completions):
    """Suspend at the admission round, at every boundary, and at exactly
    the boundaries before each query's final round."""
    every = {r: "all" for r in range(max(completions.values()) + 2)}
    final = {c - 1: "all" for c in completions.values() if c > 0}
    return {"admission_round": {0: "all"}, "every_round": every,
            "pre_final_round": final or {0: "all"}}


# ----------------------------------------------------- differential matrix
@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("spr", [1, 4])
@pytest.mark.parametrize("app", sorted(MAKERS))
def test_suspend_resume_parity_matrix(app, spr, scheduler):
    g = _matrix_graph()
    subs = _submits(g, heavy=True)
    kw = dict(capacity=3, scheduler=scheduler, steps_per_round=spr)
    jeng, eng = _engines(app, g, **kw)
    want, _ = _drain(jeng, subs)
    got, completions = _drain(eng, subs)
    assert got == want
    _, statuses, _ = want
    assert TIMEOUT in statuses.values() and DONE in statuses.values()
    for name, sched in _adversarial_schedules(completions).items():
        e = MAKERS[app][1](port_graph(g), device="cpu", **kw)
        got, _ = _drain(e, subs, suspend_at=sched)
        assert got == want, name
        if name == "every_round":
            assert e.stats.preemptions > 0 and e.stats.resumes > 0


def test_suspend_errors():
    eng = ppsp.make_bfs_engine(port_graph(_small_directed()), capacity=2, device="cpu")
    with pytest.raises(ValueError, match="not live"):
        eng.runtime.suspend([0])
    eng.submit(np.asarray([0, 5], np.int32))
    eng.run_round()
    dead = next(s for s in range(2) if not eng.runtime.live[s])
    with pytest.raises(ValueError, match="not live"):
        eng.runtime.suspend([dead])
    with pytest.raises(ValueError, match="not live"):
        eng.runtime.suspend([7])

    class NoSuspend(SlotProgram):
        pass

    rt = SlotRuntime(NoSuspend(), 2)
    rt.live[0] = True
    rt._slot_ticket[0] = object()
    with pytest.raises(NotImplementedError, match="slot_suspend"):
        rt.suspend([0])


def test_suspend_payload_is_a_host_copy_of_the_state_rows():
    """The payload is the JAX engine's version-0 payload: the leaf names of
    ``program.init``, numpy rows that later rounds do not overwrite."""
    eng = ppsp.make_bibfs_engine(port_graph(_small_directed()), capacity=2, device="cpu")
    eng.submit(np.asarray([0, 55], np.int32))
    eng.run_round()
    slot = eng.runtime.slot_of(0)
    row = {k: v[slot].clone() for k, v in eng._slots["state"].items()}
    (payload,) = eng.slot_suspend([slot])
    assert payload["v"] == 0 and sorted(payload["state"]) == sorted(row)
    for k, v in payload["state"].items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, row[k].numpy())
    assert not bool(eng._slots["live"][slot])
    for t in eng._slots["state"].values():
        t.zero_()
    for k, v in payload["state"].items():
        np.testing.assert_array_equal(v, row[k].numpy())
    with pytest.raises(RuntimeError, match="no such edition"):
        eng.slot_register_resume({"v": 1, "state": payload["state"]})
    eng.slot_register_resume(payload)
    assert eng._resume_refs == {0: 2}


def test_suspended_query_keeps_budget_accounting():
    """TIMEOUT eviction fires at the same cumulative superstep count
    however often the query was suspended in between."""
    g = _small_directed()
    subs = [(np.asarray([0, 55], np.int32), dict(budget=3))]
    jeng, eng = _engines("bfs", g, capacity=1)
    want, _ = _drain(jeng, subs)
    got, _ = _drain(eng, subs, suspend_at={0: "all", 1: "all", 2: "all", 3: "all"})
    assert got == want
    _, statuses, steps = got
    assert list(statuses.values()) == [TIMEOUT]
    assert list(steps.values()) == [3]


# ------------------------------------------------- random schedules (property)
@functools.lru_cache(maxsize=None)
def _jax_uninterrupted(spr):
    g = _small_directed()
    want, _ = _drain(jppsp.make_bfs_engine(g, capacity=3, steps_per_round=spr),
                     _submits(g, n=5, seed=11))
    return want


@settings(max_examples=15, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 24), st.integers(0, 2)),
                min_size=0, max_size=10),
       st.integers(1, 4))
def test_random_suspend_schedule_parity(sched_pairs, spr):
    """Any schedule of (round, slot) suspensions leaves results, statuses
    and step counts identical to the JAX engine's uninterrupted run."""
    suspend_at = {}
    for r, s in sched_pairs:
        suspend_at.setdefault(r, []).append(s)
    g = _small_directed()
    eng = ppsp.make_bfs_engine(port_graph(g), capacity=3, steps_per_round=spr,
                               device="cpu")
    got, _ = _drain(eng, _submits(g, n=5, seed=11), suspend_at=suspend_at)
    assert got == _jax_uninterrupted(spr)


# -------------------------------------------------- preemptive scheduling
def test_preemptive_requires_rankable_scheduler():
    g = port_graph(_small_directed())
    with pytest.raises(ValueError, match="cannot drive preemption"):
        ppsp.make_bfs_engine(g, capacity=2, scheduler="fifo", preemptive=True,
                             device="cpu")
    with pytest.raises(ValueError, match="cannot drive preemption"):
        SlotRuntime(None, 2, preemptive=True)


def _staged_convoy(eng):
    """Two genuine heavies (~58 supersteps) grab both slots; three lights
    (4 supersteps each) arrive one round later.  Returns (heavy qids,
    light qids, retirement order)."""
    heavy = [eng.submit(np.asarray([s, 59], np.int32), budget=60) for s in (0, 1)]
    eng.run_round()
    light = [eng.submit(np.asarray([i + 2, i + 6], np.int32), budget=8)
             for i in range(3)]
    order = []
    while len(eng.runtime.scheduler) or eng.runtime.live.any():
        order += [qid for qid, _, _ in eng.runtime.run_round() or []]
    return heavy, light, order


def _stats(eng):
    s = eng.stats
    return s.preemptions, s.resumes, s.max_inflight, s.rounds


def test_preemptive_sjf_lets_lights_jump_the_convoy():
    g = _path_graph()
    jref, ref = _engines("bfs", g, capacity=2, scheduler="sjf")
    _staged_convoy(ref)
    _staged_convoy(jref)
    jeng, eng = _engines("bfs", g, capacity=2, scheduler="sjf", preemptive=True)
    heavy, light, order = _staged_convoy(eng)
    assert _staged_convoy(jeng) == (heavy, light, order)
    assert _stats(eng) == _stats(jeng)
    assert max(order.index(q) for q in light) < min(order.index(h) for h in heavy)
    assert eng.stats.preemptions >= 1 and eng.stats.resumes >= 1
    assert eng.stats.max_inflight > eng.capacity
    assert _fingerprint(eng) == _fingerprint(ref) == _fingerprint(jeng) == _fingerprint(jref)


def test_preemptive_deadline_urgent_query_preempts():
    orders = []
    for eng in _engines("bfs", _path_graph(), capacity=1, scheduler="deadline",
                        preemptive=True):
        lax_q = eng.submit(np.asarray([0, 50], np.int32), deadline=100.0)
        eng.run_round()
        urgent = eng.submit(np.asarray([1, 4], np.int32), deadline=1.0)
        order = []
        while len(eng.runtime.scheduler) or eng.runtime.live.any():
            order += [qid for qid, _, _ in eng.runtime.run_round() or []]
        assert order.index(urgent) < order.index(lax_q)
        assert eng.stats.preemptions >= 1
        orders.append((order, _stats(eng), _fingerprint(eng)))
    assert orders[0] == orders[1]


def test_preempt_margin_suppresses_preemption():
    runs = []
    for eng in _engines("bfs", _path_graph(), capacity=2, scheduler="sjf",
                        preemptive=True, preempt_margin=1e9):
        runs.append(_staged_convoy(eng))
        assert eng.stats.preemptions == 0
        assert eng.stats.max_inflight <= eng.capacity
    assert runs[0] == runs[1]


def test_no_thrash_same_rank():
    """Equal-ranked waiting queries never evict a running one (strict
    inequality), at every one of the ~30 boundaries it survives."""
    runs = []
    for eng in _engines("bfs", _path_graph(), capacity=1, scheduler="sjf",
                        preemptive=True):
        eng.submit(np.asarray([0, 30], np.int32), budget=32)
        eng.run_round()
        eng.submit(np.asarray([0, 30], np.int32), budget=32)
        eng.run_until_drained()
        assert eng.stats.preemptions == 0
        runs.append((_stats(eng), _fingerprint(eng)))
    assert runs[0] == runs[1]


def test_preemptive_ties_pick_the_later_victim():
    """Two running queries of equal rank: the later-submitted one is the
    victim, in both packages (worst rank first, later seq among equals)."""
    runs = []
    for eng in _engines("bfs", _path_graph(), capacity=2, scheduler="priority",
                        preemptive=True):
        a = eng.submit(np.asarray([0, 40], np.int32), priority=5)
        b = eng.submit(np.asarray([1, 41], np.int32), priority=5)
        eng.run_round()
        c = eng.submit(np.asarray([2, 6], np.int32), priority=0)
        eng.run_round()
        suspended = sorted(tk.qid for _, _, tk in eng.runtime.scheduler._h)
        assert suspended == [b]
        eng.run_until_drained()
        runs.append((suspended, _stats(eng), _fingerprint(eng), a, c))
    assert runs[0] == runs[1]
