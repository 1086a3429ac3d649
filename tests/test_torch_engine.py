"""Engine-level parity across packages: the port's QuegelEngine (batched
programs, k masked supersteps, one sync per round) against the JAX
engine on the same graph and queries — identical qid->result maps,
statuses and round/barrier/superstep counters."""
import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import ppsp as jppsp
from repro.apps import reach as jreach
from repro.core.graph import random_dag, random_graph

import repro_torch
from repro_torch.apps import ppsp, reach
from repro_torch.core import engine as tengine
from repro_torch.core.engine import QuegelEngine
from repro_torch.kernels import ops, ref

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


_KEY_QUERIES = {
    "leaf": lambda r: r.integers(0, 90, 2).astype(np.int32),
    "tuple": lambda r: (np.int32(r.integers(90)), np.int32(r.integers(90))),
    "list": lambda r: [r.integers(0, 9, 3).astype(np.int32),
                       (np.float32(r.random()), np.int64(r.integers(9)))],
    "dict": lambda r: {"a": np.int32(r.integers(9)), "b": r.random(2).astype(np.float32)},
    "dict_with_none": lambda r: {"k": None, "q": (np.int32(r.integers(9)),
                                                   np.int32(r.integers(9)))},
    "none": lambda r: None,
}


@pytest.mark.parametrize("structure", sorted(_KEY_QUERIES))
def test_cache_key_matches_jax(structure):
    """The result-cache key (graph content hash, then the query hash over
    the structure JAX spells as ``repr(treedef)`` and every leaf's dtype,
    shape and bytes) is the JAX engine's, so a replica pool places a query
    on the same replica in both packages."""
    q = _KEY_QUERIES[structure](np.random.default_rng(len(structure)))
    eng = ppsp.make_bfs_engine(port_graph(_graph()), capacity=2, device="cpu")
    jeng = jppsp.make_bfs_engine(_graph(), capacity=2)
    assert eng.cache_key(q) == jeng.cache_key(q)
    assert eng.cache_key(q).split(":")[0] == _graph().content_hash()


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


@pytest.mark.parametrize("option,value", [("mesh", True), ("mesh_axis", "x"),
                                          ("partition", "src")])
def test_unported_options_raise(option, value):
    g = port_graph(_graph())
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, \*Mesh mode\*"):
        QuegelEngine(g, ppsp.BFSProgram(), 2, example_query=np.zeros(2, np.int32),
                     device="cpu", **{option: value})


@pytest.mark.parametrize("option,value", [
    ("donate", True), ("donate", False), ("donate", "auto"),
    ("interpret", True), ("interpret", False),
    ("mesh_axis,partition", (None, "dst"))])
def test_jax_default_options_construct_and_answer_as_jax(option, value):
    """Options of the JAX signature that mean nothing in eager torch
    (donation, interpret mode) or only under a mesh, at their defaults,
    construct an engine that answers as the JAX engine does."""
    kw = dict(zip(option.split(","), value)) if "," in option else {option: value}
    pairs = _pairs(6, seed=33)
    eng = ppsp.make_bfs_engine(port_graph(_graph()), capacity=3, device="cpu", **kw)
    jeng = jppsp.make_bfs_engine(_graph(), capacity=3, **kw)
    for p in pairs:
        eng.submit(p)
        jeng.submit(p)
    assert_same_results(eng.run_until_drained(), {
        q: {k: np.asarray(v) for k, v in r.items()}
        for q, r in jeng.run_until_drained().items()})
    assert eng.stats.rounds == jeng.stats.rounds


@pytest.mark.parametrize("option,value", [
    ("arg_carried", True), ("warmup", True), ("edge_capacity", 4096),
    ("gather_edges", 16), ("index_fn", lambda g, idx, d: (idx, None))])
def test_mutation_options_construct_and_answer_as_jax(option, value):
    """The mutation and gated-COO options the port took over construct an
    engine that answers as the JAX engine does."""
    g = port_graph(_graph())
    pairs = _pairs(6, seed=31)
    eng = ppsp.make_bibfs_engine(g, capacity=3, device="cpu", **{option: value})
    jeng = jppsp.make_bibfs_engine(_graph(), capacity=3)
    for p in pairs:
        eng.submit(p)
        jeng.submit(p)
    assert_same_results(eng.run_until_drained(), {
        q: {k: np.asarray(v) for k, v in r.items()}
        for q, r in jeng.run_until_drained().items()})


def _roadmap_queue() -> str:
    """The text of ROADMAP.md §1's queue of modules still to port."""
    text = (Path(repro_torch.__file__).resolve().parents[2] / "ROADMAP.md").read_text()
    sec = text[text.index("### 1. Modules to port"):text.index("### 2.")]
    return sec[sec.index("**Queue"):]


def test_not_ported_messages_name_roadmap_titles():
    """Every option or backend that is not ported names a §1 queue item by
    its title, and every such title heads an item of the queue."""
    queue = _roadmap_queue()
    titles = set(tengine._NOT_PORTED.values()) | set(ops._NOT_PORTED.values())
    pkg = Path(repro_torch.__file__).resolve().parent
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"§1 items? \d", text), path
        for ref_ in re.findall(r"ROADMAP\.md §1,([^)\"]*)", text):
            titles |= {t for t in re.findall(r"\*([^*]+)\*", ref_) if "{" not in t}
    assert titles == {"Mesh mode"}, titles
    for title in titles:
        assert f"**{title}**" in queue, title
    with pytest.raises(NotImplementedError, match=r"\*Mesh mode\*"):
        ppsp.make_bfs_engine(port_graph(_graph()), capacity=2, backend="sharded",
                             device="cpu")


# ------------------------------------------------ engine diagnostics
@functools.lru_cache(maxsize=None)
def _dag():
    return random_dag(80, 2.5, seed=13)


def _frontier_run(eng, pairs):
    for p in pairs:
        eng.submit(p)
    res = eng.run_until_drained()
    return res, list(eng.stats.frontier_active)


@functools.lru_cache(maxsize=None)
def _jax_frontier(prog, k):
    if prog == "bfs":
        eng = jppsp.make_bfs_engine(_graph(), capacity=3, steps_per_round=k,
                                    track_frontier=True)
        pairs = _pairs(10, seed=4)
    else:
        eng = jreach.make_reach_engine(_dag(), jreach.build_reach_index(_dag()), capacity=3,
                                       steps_per_round=k, track_frontier=True)
        pairs = np.random.default_rng(4).integers(0, 80, (10, 2)).astype(np.int32)
    return _frontier_run(eng, pairs), pairs


@pytest.mark.parametrize("prog", ["bfs", "reach"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_track_frontier_matches_jax(prog, k, backend):
    """Per round, the live slots' active vertices summed over
    ``frontier_of`` (BFS: one mask; reach: forward and backward)."""
    (jres, jfront), pairs = _jax_frontier(prog, k)
    kw = dict(capacity=3, steps_per_round=k, track_frontier=True, backend=backend,
              block=16, device="cpu")
    if prog == "bfs":
        eng = ppsp.make_bfs_engine(port_graph(_graph()), **kw)
    else:
        dag = port_graph(_dag())
        eng = reach.make_reach_engine(dag, reach.build_reach_index(dag), **kw)
    res, front = _frontier_run(eng, pairs)
    assert_same_results(res, jres)
    assert front == jfront and len(front) == eng.stats.rounds
    if k == 1:  # at k = 2 short queries finish inside a round and read 0
        assert sum(front) > 0


def test_track_frontier_off_records_nothing():
    eng = ppsp.make_bfs_engine(port_graph(_graph()), capacity=3, device="cpu")
    _frontier_run(eng, _pairs(4, seed=4))
    assert eng.stats.frontier_active == []


def test_propagate_override_matches_coo():
    """A callable in place of a view's backend: wrapped in CallableBackend,
    called for every propagate of that view, answers as ``coo``'s."""
    g = port_graph(_graph())
    calls = {"default": 0, "rev": 0}

    def via(view, graph):
        def fn(sr, x, frontier):
            calls[view] += 1
            return ref.propagate_coo(graph, sr, x, frontier)
        return fn

    pairs = _pairs(10, seed=6)
    eng = ppsp.make_bibfs_engine(g, capacity=4, device="cpu", propagate_override={
        "default": via("default", g), "rev": via("rev", g.reverse())})
    assert all(isinstance(eng._backends[v], ops.CallableBackend) for v in calls)
    res = _frontier_run(eng, pairs)[0]
    want = _frontier_run(ppsp.make_bibfs_engine(g, capacity=4, device="cpu"), pairs)[0]
    assert_same_results(res, want)
    assert calls["default"] == calls["rev"] == eng.stats.rounds  # one superstep a round
