"""Sparsity-aware propagation in the port against the JAX package: the
gated tile plans and the gated COO gather are pure optimizations, so the
qid -> result maps and the round, barrier and superstep counters must
equal the dense single-step engine's and the JAX engine's, admission
mid-stream included (the gated cases of tests/test_sparsity.py)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import hub2 as jhub2
from repro.apps import keyword as jkeyword
from repro.apps import ppsp as jppsp
from repro.core.graph import random_graph

from repro_torch.apps import hub2, keyword, ppsp

from _torch_common import assert_same_results, port_graph


@functools.lru_cache(maxsize=None)
def _directed():
    return random_graph(60, 3.0, seed=1, directed=True)


@functools.lru_cache(maxsize=None)
def _undirected():
    return random_graph(60, 3.0, seed=2, directed=False)


def _pairs(graph, n_pairs, seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(p, np.int32) for p in rng.integers(0, graph.n_real, (n_pairs, 2))]


def _stats(eng):
    s = eng.stats
    return (s.super_rounds, s.barriers, s.queries_done, s.supersteps_total)


def _np_results(res):
    return {q: {k: np.asarray(v) for k, v in r.items()} for q, r in res.items()}


def _waves(eng, waves):
    for wave in waves:
        for p in wave:
            eng.submit(p)
        eng.run_round()
    return eng.run_until_drained()


@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
def test_engine_gated_matches_dense_tile(backend):
    """gate=True (dead-tile skipping) against gate=False (dense pre-mask)
    under steps_per_round=4 with mid-stream admission: identical results
    and counters, equal to the JAX engine's gated run."""
    jg = _directed()
    g = port_graph(jg)
    waves = [_pairs(jg, 3, seed=s) for s in (41, 42)]
    out, stats = {}, {}
    for gate in (True, False):
        eng = ppsp.make_bfs_engine(g, capacity=3, backend=backend, block=16,
                                   steps_per_round=4, gate=gate, device="cpu")
        out[gate] = _waves(eng, waves)
        stats[gate] = _stats(eng)
    jeng = jppsp.make_bfs_engine(jg, capacity=3, backend="blocks_ref", block=16,
                                 steps_per_round=4)
    want = _np_results(_waves(jeng, [[jnp.asarray(p) for p in w] for w in waves]))
    assert_same_results(out[True], out[False])
    assert_same_results(out[True], want)
    assert stats[True] == stats[False] == _stats(jeng)


@pytest.mark.parametrize("chunk,spr", [(64, 2), (7, 1), (4096, 3)])
def test_engine_coo_gather_matches_dense(chunk, spr):
    """The gated COO gather through the engine (BiBFS: two views) against
    the plain segment reduction and the JAX engine's gated gather."""
    jg = _directed()
    g = port_graph(jg)
    pairs = _pairs(jg, 10, seed=51)
    plain = ppsp.make_bibfs_engine(g, capacity=4, device="cpu")
    gated = ppsp.make_bibfs_engine(g, capacity=4, gather_edges=chunk, steps_per_round=spr,
                                   device="cpu")
    jgated = jppsp.make_bibfs_engine(jg, capacity=4, gather_edges=chunk, steps_per_round=spr)
    for e in (plain, gated):
        for p in pairs:
            e.submit(p)
    for p in pairs:
        jgated.submit(jnp.asarray(p))
    out_p, out_g = plain.run_until_drained(), gated.run_until_drained()
    assert_same_results(out_g, out_p)
    assert_same_results(out_g, _np_results(jgated.run_until_drained()))
    assert gated.stats.supersteps_total == plain.stats.supersteps_total
    assert _stats(gated) == _stats(jgated)


def test_coo_gated_backend_spec():
    """backend='coo_gated' turns the gather on at its default chunk."""
    jg = _directed()
    pairs = _pairs(jg, 6, seed=52)
    eng = ppsp.make_bibfs_engine(port_graph(jg), capacity=2, backend="coo_gated",
                                 device="cpu")
    assert eng._backends["default"].gather_edges == 512
    jeng = jppsp.make_bibfs_engine(jg, capacity=2, backend="coo_gated")
    for p in pairs:
        eng.submit(p)
        jeng.submit(jnp.asarray(p))
    assert_same_results(eng.run_until_drained(), _np_results(jeng.run_until_drained()))


@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
def test_engine_gated_keyword_lanes(backend):
    """Multi-lane (MAXK, V) state: keyword search on a gated tile plan ==
    the coo plan == the JAX engine."""
    jg = _directed()
    tokens = jkeyword.make_vertex_text(jg.n, 20, 2, seed=6)
    rng = np.random.default_rng(7)
    qs = []
    for _ in range(4):
        q = np.full(jkeyword.MAXK, -1, np.int32)
        q[:2] = rng.integers(0, 8, 2)
        qs.append(q)
    out = {}
    for be in ("coo", backend):
        eng = keyword.make_keyword_engine(port_graph(jg), tokens, capacity=2, delta_max=3,
                                          backend=be, block=16, steps_per_round=2,
                                          device="cpu")
        for q in qs:
            eng.submit(q)
        out[be] = eng.run_until_drained()
    jeng = jkeyword.make_keyword_engine(jg, tokens, capacity=2, delta_max=3,
                                        backend="blocks_ref", block=16, steps_per_round=2)
    for q in qs:
        jeng.submit(jnp.asarray(q))
    assert_same_results(out[backend], out["coo"])
    assert_same_results(out[backend], _np_results(jeng.run_until_drained()))


@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
def test_hub2_index_on_tile_backends(backend):
    """Hub² indexing mixes min_right and max_right on one view; the
    per-semiring tables build the coo plan's index and the JAX one."""
    jg = _undirected()
    want = jhub2.build_hub_index(jg, k=4, capacity=4)
    idx = hub2.build_hub_index(port_graph(jg), k=4, capacity=4, backend=backend, block=16,
                               device="cpu")
    for f in ("hub_dist", "core"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
def test_hub2_query_on_tile_backend(backend):
    jg = _undirected()
    g = port_graph(jg)
    idx = hub2.build_hub_index(g, k=4, capacity=4, backend=backend, block=16, device="cpu")
    e_coo = hub2.make_hub2_engine(g, idx, capacity=2, device="cpu")
    e_blk = hub2.make_hub2_engine(g, idx, capacity=2, backend=backend, block=16,
                                  steps_per_round=4, device="cpu")
    jeng = jhub2.make_hub2_engine(jg, jhub2.build_hub_index(jg, k=4, capacity=4),
                                  capacity=2)
    for p in _pairs(jg, 5, seed=61):
        want = int(jeng.query(jnp.asarray(p))["dist"])
        assert int(e_coo.query(p)["dist"]) == int(e_blk.query(p)["dist"]) == want
