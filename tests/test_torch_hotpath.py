"""The port's fused round against its ``legacy=True`` round (the
pre-overhaul A/B baseline) and against the JAX engine's legacy round, on
the same graphs and queries: identical qid -> result maps and engine
counters, admission mid-stream, auxiliary views, an index, graph deltas
and suspend/resume; ``donate`` is invisible, and only the legacy round
reads liveness back from the device."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import hub2 as jhub2
from repro.apps import ppsp as jppsp
from repro.core.graph import random_graph

from repro_torch.apps import hub2, ppsp
from repro_torch.core import engine as tengine

from _torch_common import assert_same_results, port_graph

MODES = ("fused", "legacy")


def _pairs(graph, n_pairs, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, graph.n_real, (n_pairs, 2)).astype(np.int32)


def _stat_tuple(eng):
    s = eng.stats
    return (s.super_rounds, s.barriers, s.queries_done, s.supersteps_total)


def _np_map(res):
    return {q: {k: np.asarray(v) for k, v in r.items()} for q, r in res.items()}


def _drain(eng, pairs):
    for p in pairs:
        eng.submit(p)
    return _np_map(eng.run_until_drained()), _stat_tuple(eng)


def _waves(eng, waves):
    """Submit in waves with two rounds between them, so new queries join
    slots that are mid-flight at different supersteps (paper Fig. 2)."""
    for wave in waves:
        for p in wave:
            eng.submit(p)
        eng.run_round()
        eng.run_round()
    return _np_map(eng.run_until_drained()), _stat_tuple(eng)


@functools.lru_cache(maxsize=None)
def _directed():
    """The ``small_directed`` graph of ``tests/conftest.py``."""
    return random_graph(60, 3.0, seed=1, directed=True)


@functools.lru_cache(maxsize=None)
def _jax_batch(capacity, seed, prog="bfs"):
    g = _directed()
    make = jppsp.make_bfs_engine if prog == "bfs" else jppsp.make_bibfs_engine
    return _drain(make(g, capacity=capacity, legacy=True),
                  _pairs(g, 14 if prog == "bfs" else 10, seed=seed))


@pytest.mark.parametrize("capacity", [1, 3, 8])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_fused_matches_legacy_batch(capacity, backend):
    g = _directed()
    want = _jax_batch(capacity, capacity)
    for mode in MODES:
        eng = ppsp.make_bfs_engine(port_graph(g), capacity=capacity, backend=backend,
                                   block=16, legacy=(mode == "legacy"), device="cpu")
        res, stats = _drain(eng, _pairs(g, 14, seed=capacity))
        assert_same_results(res, want[0])
        assert stats == want[1], mode


@pytest.mark.parametrize("backend", ["coo", "blocks_ref", "cuda"])
def test_fused_matches_legacy_midstream(small_directed, backend):
    g = small_directed
    waves = [_pairs(g, 3, seed=s) for s in (21, 22, 23)]
    want = _waves(jppsp.make_bfs_engine(g, capacity=4, legacy=True), waves)
    for mode in MODES:
        eng = ppsp.make_bfs_engine(port_graph(g), capacity=4, backend=backend, block=16,
                                   legacy=(mode == "legacy"), device="cpu")
        res, stats = _waves(eng, waves)
        assert_same_results(res, want[0])
        assert stats == want[1], mode


@pytest.mark.parametrize("gather_edges", [None, 8])
def test_fused_matches_legacy_bibfs_aux_view(gather_edges):
    """Programs with an auxiliary (reverse) view, on ungated and gated COO."""
    g = _directed()
    want = _jax_batch(4, 31, "bibfs")
    for mode in MODES:
        eng = ppsp.make_bibfs_engine(port_graph(g), capacity=4, gather_edges=gather_edges,
                                     legacy=(mode == "legacy"), device="cpu")
        res, stats = _drain(eng, _pairs(g, 10, seed=31))
        assert_same_results(res, want[0])
        assert stats == want[1], mode


def test_fused_matches_legacy_with_index(small_undirected):
    """Index-carrying programs (Hub²): init reads the index per admission."""
    g = small_undirected
    pairs = _pairs(g, 8, seed=41)
    jidx = jhub2.build_hub_index(g, k=4, capacity=4)
    want = _drain(jhub2.make_hub2_engine(g, jidx, capacity=4, legacy=True), pairs)
    pg = port_graph(g)
    idx = hub2.build_hub_index(pg, k=4, capacity=4, device="cpu")
    for mode in MODES:
        eng = hub2.make_hub2_engine(pg, idx, capacity=4, legacy=(mode == "legacy"),
                                    device="cpu")
        res, stats = _drain(eng, pairs)
        assert_same_results(res, want[0])
        assert stats == want[1], mode


def _mutate_and_suspend(eng, g, pairs):
    """Half the pairs, a round, the first live slot suspended, an edge
    delta (the in-flight queries stay on version 0), the other half,
    drain.  Returns the result map, statuses and counters."""
    n_real = g.n_real
    for p in pairs[:4]:
        eng.submit(p)
    eng.run_round()
    live = [s for s in range(eng.capacity) if eng.runtime.live[s]]
    eng.runtime.suspend(live[:1])
    eng.apply_delta(adds=np.array([[0, n_real - 1], [n_real - 1, 0]], np.int32),
                    dels=np.stack([np.asarray(g.src)[:2], np.asarray(g.dst)[:2]], 1))
    for p in pairs[4:]:
        eng.submit(p)
    res = _np_map(eng.run_until_drained())
    st = eng.stats
    return res, dict(eng.status), (_stat_tuple(eng), st.preemptions, st.resumes,
                                   eng.graph.version)


def test_legacy_across_delta_and_suspend_matches_jax(small_directed):
    """The legacy round admits a resumed query on its pinned version and
    fresh ones on the new version, as the JAX legacy engine does."""
    g = small_directed
    pairs = _pairs(g, 10, seed=43)
    want = _mutate_and_suspend(jppsp.make_bfs_engine(g, capacity=3, legacy=True), g, pairs)
    assert want[2][1] == want[2][2] == 1 and want[2][3] == 1
    for mode in MODES:
        eng = ppsp.make_bfs_engine(port_graph(g), capacity=3, legacy=(mode == "legacy"),
                                   device="cpu")
        res, status, stats = _mutate_and_suspend(eng, g, pairs)
        assert_same_results(res, want[0])
        assert status == want[1] and stats == want[2], mode


@pytest.mark.parametrize("option,value,message", [
    ("steps_per_round", 2, "multi-superstep"),
    ("arg_carried", True, "carriable"),
    ("warmup", True, "fused round")])
def test_legacy_refuses_what_jax_refuses(small_directed, option, value, message):
    kw = {option: value}
    with pytest.raises(ValueError, match=message):
        jppsp.make_bfs_engine(small_directed, capacity=2, legacy=True, **kw)
    with pytest.raises(ValueError, match=message):
        ppsp.make_bfs_engine(port_graph(small_directed), capacity=2, legacy=True,
                             device="cpu", **kw)


def test_donation_flag_is_equivalent(small_directed):
    """donate=True, False or 'auto' is invisible to results."""
    g = small_directed
    pairs = _pairs(g, 8, seed=51)
    out = {}
    for donate in (True, False, "auto"):
        eng = ppsp.make_bfs_engine(port_graph(g), capacity=4, donate=donate, device="cpu")
        out[donate] = _drain(eng, pairs)
    for donate in (False, "auto"):
        assert_same_results(out[donate][0], out[True][0])
        assert out[donate][1] == out[True][1]


def test_query_latencies_recorded(small_directed):
    g = small_directed
    eng = ppsp.make_bfs_engine(port_graph(g), capacity=4, legacy=True, device="cpu")
    _drain(eng, _pairs(g, 6, seed=61))
    assert len(eng.stats.query_latencies) == 6
    assert all(t >= 0 for t in eng.stats.query_latencies)
    assert eng.stats.latency_percentile(50) <= eng.stats.latency_percentile(95)


@pytest.mark.parametrize("mode", MODES)
def test_only_legacy_reads_liveness_from_the_device(small_directed, monkeypatch, mode):
    """The fused round serves admission from the runtime's host mirror; the
    legacy round copies the slot liveness to the host before every
    admission, as the pre-overhaul round did."""
    g = small_directed
    eng = ppsp.make_bfs_engine(port_graph(g), capacity=2, legacy=(mode == "legacy"),
                               device="cpu")
    reads = []
    orig = tengine.to_numpy

    def spy(x):
        if x is eng._slots["live"]:
            reads.append(1)
        return orig(x)

    monkeypatch.setattr(tengine, "to_numpy", spy)
    _drain(eng, _pairs(g, 5, seed=71))
    assert len(reads) == (eng.stats.rounds if mode == "legacy" else 0)
