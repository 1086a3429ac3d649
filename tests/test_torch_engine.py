"""Engine-level parity across packages: the port's QuegelEngine (batched
programs, k masked supersteps, one sync per round) against the JAX
engine on the same graph and queries — identical qid->result maps,
statuses and round/barrier/superstep counters."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import ppsp as jppsp
from repro.core.graph import random_graph

from repro_torch.apps import ppsp
from repro_torch.core.engine import QuegelEngine

from _torch_common import assert_same_results, port_graph

MAKERS = {"bfs": (jppsp.make_bfs_engine, ppsp.make_bfs_engine),
          "bibfs": (jppsp.make_bibfs_engine, ppsp.make_bibfs_engine)}


@functools.lru_cache(maxsize=None)
def _graph():
    return random_graph(90, 2.5, seed=21)


def _pairs(n_pairs, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, _graph().n_real, (n_pairs, 2)).astype(np.int32)


def _drive(eng, pairs, budgets=None):
    """Submit half, run one round, submit the rest mid-stream, drain.
    Priorities and deadlines are seeded, so every scheduler has keys."""
    half = len(pairs) // 2
    budgets = [0] * len(pairs) if budgets is None else budgets
    rng = np.random.default_rng(9)
    prio = rng.integers(0, 3, len(pairs))
    deadline = rng.random(len(pairs))

    def submit(i):
        eng.submit(pairs[i], budget=int(budgets[i]), priority=int(prio[i]),
                   deadline=float(deadline[i]))

    for i in range(half):
        submit(i)
    eng.run_round()
    for i in range(half, len(pairs)):
        submit(i)
    res = eng.run_until_drained()
    st = eng.stats
    return res, dict(eng.status), (st.rounds, st.barriers, st.supersteps_total,
                                   st.queries_done, st.timeouts, st.max_inflight,
                                   st.slot_occupancy)


@functools.lru_cache(maxsize=None)
def _jax_run(prog, capacity, k, scheduler="fifo", budgeted=False):
    pairs = _pairs(12, seed=capacity + k)
    budgets = _budgets(len(pairs)) if budgeted else None
    eng = MAKERS[prog][0](_graph(), capacity=capacity, steps_per_round=k,
                          scheduler=scheduler)
    return _drive(eng, pairs, budgets)


def _budgets(n):
    return np.random.default_rng(5).integers(1, 4, n)


def _port_run(prog, capacity, k, backend, scheduler="fifo", budgeted=False):
    pairs = _pairs(12, seed=capacity + k)
    budgets = _budgets(len(pairs)) if budgeted else None
    eng = MAKERS[prog][1](port_graph(_graph()), capacity=capacity,
                          steps_per_round=k, scheduler=scheduler,
                          backend=backend, block=16, device="cpu")
    return _drive(eng, pairs, budgets)


@pytest.mark.parametrize("prog", ["bfs", "bibfs"])
@pytest.mark.parametrize("capacity", [1, 8])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_engine_matches_jax(prog, capacity, k, backend):
    res, status, stats = _port_run(prog, capacity, k, backend)
    jres, jstatus, jstats = _jax_run(prog, capacity, k)
    assert_same_results(res, jres)
    assert status == jstatus
    assert stats == jstats


@pytest.mark.parametrize("scheduler", ["fifo", "sjf", "priority", "deadline"])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_budgets_timeout_match_jax(scheduler, backend):
    """Budgets of 1-3 supersteps evict the longer queries as TIMEOUT with
    partial results; admission order follows the scheduler."""
    res, status, stats = _port_run("bfs", 3, 1, backend, scheduler, True)
    jres, jstatus, jstats = _jax_run("bfs", 3, 1, scheduler, True)
    assert "TIMEOUT" in status.values() and "DONE" in status.values()
    assert_same_results(res, jres)
    assert status == jstatus
    assert stats == jstats


@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_result_cache_matches_jax(backend):
    """Repeated pairs are served from the LRU result cache, keyed by the
    graph's content hash: the same hits and answers in both packages."""
    g = _graph()
    pairs = np.concatenate([_pairs(5, seed=2)] * 2)
    jeng = jppsp.make_bfs_engine(g, capacity=2, result_cache=4)
    eng = ppsp.make_bfs_engine(port_graph(g), capacity=2, result_cache=4,
                               backend=backend, block=16, device="cpu")
    assert eng.cache_key(pairs[0]).split(":")[0] == g.content_hash()
    for e in (jeng, eng):
        for p in pairs[:5]:
            e.submit(p)
        e.run_until_drained()
        for p in pairs[5:]:
            e.submit(p)
        e.run_until_drained()
    assert_same_results(eng._results, jeng._results)
    assert eng.stats.cache_hits == jeng.stats.cache_hits > 0
    assert eng.stats.rounds == jeng.stats.rounds


def test_pump_poll_and_interactive_match_jax():
    g = _graph()
    pairs = _pairs(6, seed=3)
    jeng = jppsp.make_bibfs_engine(g, capacity=2)
    eng = ppsp.make_bibfs_engine(port_graph(g), capacity=2, device="cpu")
    for p in pairs:
        jeng.submit(p)
        eng.submit(p)
    seen, jseen = [], []
    while eng.pending() or eng.inflight():
        seen += [(q, s) for q, _, s in eng.pump()]
    while jeng.pending() or jeng.inflight():
        jseen += [(q, s) for q, _, s in jeng.pump()]
    assert seen == jseen
    for qid in range(len(pairs)):
        assert eng.poll(qid)[0] == jeng.poll(qid)[0] == "DONE"
    one = eng.query(pairs[0])
    assert int(one["dist"]) == int(jeng.query(pairs[0])["dist"])


@pytest.mark.parametrize("option", [
    "legacy", "mesh", "preemptive", "journal", "arg_carried", "warmup",
    "index_fn", "gather_edges", "track_frontier", "propagate_override"])
def test_unported_options_raise(option):
    g = port_graph(_graph())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QuegelEngine(g, ppsp.BFSProgram(), 2, example_query=np.zeros(2, np.int32),
                     device="cpu", **{option: True})
