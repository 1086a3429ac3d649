"""Terrain SSSP (paper §5.3) and graph keyword search (paper §5.5) across
packages: the same numpy-built graph and queries through the JAX engine
and the port's (``coo``, and ``cuda`` whose kernel runs its plain version
here) give the same answers; the port's also match scipy's Dijkstra and
the brute-force hop oracle of ``tests/test_terrain_keyword.py``."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from repro.apps import keyword as jkeyword
from repro.apps import terrain as jterrain
from repro.core.graph import grid_terrain, random_graph
from repro.core.semiring import INF

from repro_torch import carry
from repro_torch.apps import keyword, terrain

from _torch_common import assert_same_results, port_graph
from test_terrain_keyword import _oracle_keyword

BACKENDS = ["coo", "cuda"]


def _drain(eng, queries):
    for q in queries:
        eng.submit(q)
    return eng.run_until_drained(), eng.stats.rounds


# ------------------------------------------------------------ terrain
@functools.lru_cache(maxsize=None)
def _terrain():
    return grid_terrain(12, 14, eps_subdiv=2, seed=1)


def _terrain_pairs(capacity):
    g, _ = _terrain()
    pairs = np.random.default_rng(5 + capacity).integers(0, g.n_real, (7, 2))
    return np.concatenate([pairs, [[0, 2]]]).astype(np.int32)  # and a near pair


@functools.lru_cache(maxsize=None)
def _jax_terrain(capacity):
    g, coords = _terrain()
    eng = jterrain.make_terrain_engine(g, coords, capacity=capacity)
    return _drain(eng, [jnp.asarray(p) for p in _terrain_pairs(capacity)])


@pytest.mark.parametrize("capacity", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_terrain_matches_jax(capacity, backend):
    """``dist`` bit for bit (float32: the same relaxations in the same
    order, min is exact) and ``visited``, with the same rounds."""
    g, coords = _terrain()
    eng = terrain.make_terrain_engine(port_graph(g), carry.coords_from_numpy(coords, "cpu"),
                                      capacity=capacity, backend=backend, block=16,
                                      device="cpu")
    res, rounds = _drain(eng, _terrain_pairs(capacity))
    jres, jrounds = _jax_terrain(capacity)
    assert_same_results(res, jres)
    assert rounds == jrounds


@pytest.mark.parametrize("backend", BACKENDS)
def test_terrain_matches_dijkstra(backend):
    g, coords = _terrain()
    src, dst, w = (np.asarray(a) for a in (g.src, g.dst, g.w))
    m = csr_matrix((w, (src, dst)), shape=(g.n, g.n))
    eng = terrain.make_terrain_engine(port_graph(g), coords, capacity=4, backend=backend,
                                      block=16, device="cpu")
    res, _ = _drain(eng, _terrain_pairs(4))
    for qid, (s, t) in enumerate(_terrain_pairs(4)):
        want = dijkstra(m, indices=int(s))[int(t)]
        np.testing.assert_allclose(float(res[qid]["dist"]), want, rtol=1e-4)
    # the near pair (0, 2) terminates early and touches under half the mesh
    assert int(res[len(res) - 1]["visited"]) < g.n_real // 2


@pytest.mark.parametrize("rows,cols,seed", [(12, 14, 1), (64, 64, 0), (257, 257, 0)])
def test_terrain_euclidean_matches_xla(rows, cols, seed):
    """The early-termination test ``d[t] < d_E^min`` reads the Euclidean
    distance: the port's equals XLA's jnp.linalg.norm bit for bit, and so
    does torch.linalg.vector_norm on the CPU.  257 x 257 is the full size
    ``chip_smoke.py`` phase 5 runs, whose 8 sources (``default_rng(1)``'s
    first 8 pairs) are checked here too: there the card's distances equal
    the host's."""
    g, coords = grid_terrain(rows, cols, eps_subdiv=2, seed=seed)
    tc = torch.from_numpy(coords)
    src = np.concatenate([
        np.random.default_rng(0).integers(0, len(coords), 8),
        np.random.default_rng(1).integers(0, g.n_real, (64, 2))[:8, 0]])
    got = terrain.euclidean(tc, torch.from_numpy(src)).numpy()
    for row, s in zip(got, src):
        want = np.asarray(jnp.linalg.norm(jnp.asarray(coords) - coords[s][None, :], axis=-1))
        assert row.dtype == want.dtype and row.tobytes() == want.tobytes()
        norm = torch.linalg.vector_norm(tc - tc[int(s)][None, :], dim=-1).numpy()
        assert norm.tobytes() == want.tobytes()


# ------------------------------------------------------------ keyword
DELTA = 3


@functools.lru_cache(maxsize=None)
def _kw_setup():
    g = random_graph(50, 2.5, seed=41, directed=True)
    tokens = jkeyword.make_vertex_text(g.n_real, 15, 2, seed=42)
    padded = np.pad(tokens, ((0, g.n - g.n_real), (0, 0)), constant_values=-2)
    return g, tokens, padded


def _kw_queries():
    rng = np.random.default_rng(6)
    out = []
    for i in range(8):
        kws = rng.integers(0, 10, 2 + i % 2)
        q = np.full(keyword.MAXK, -1, np.int32)
        q[: len(kws)] = kws
        out.append(q)
    return out


@functools.lru_cache(maxsize=None)
def _jax_keyword(capacity):
    g, _, padded = _kw_setup()
    eng = jkeyword.make_keyword_engine(g, padded, capacity=capacity, delta_max=DELTA)
    return _drain(eng, [jnp.asarray(q) for q in _kw_queries()])


def test_vertex_text_identical():
    for args in ((50, 15, 2, 42), (300, 1000, 4, 2)):
        a = keyword.make_vertex_text(*args[:3], seed=args[3])
        b = jkeyword.make_vertex_text(*args[:3], seed=args[3])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("capacity", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_keyword_matches_jax(capacity, backend):
    """num_roots, top_roots, top_scores and touched exactly.  Tied scores
    are the rule here (the stable sort keeps the lower ids first), and at
    least one query's top 16 holds a tie."""
    g, _, padded = _kw_setup()
    eng = keyword.make_keyword_engine(port_graph(g), padded, capacity=capacity,
                                      delta_max=DELTA, backend=backend, block=16,
                                      device="cpu")
    res, rounds = _drain(eng, _kw_queries())
    jres, jrounds = _jax_keyword(capacity)
    assert_same_results(res, jres)
    assert rounds == jrounds
    tied = [r for r in res.values()
            if len(np.unique(r["top_scores"])) < len(r["top_scores"])]
    assert tied


@pytest.mark.parametrize("backend", BACKENDS)
def test_keyword_matches_oracle(backend):
    g, tokens, padded = _kw_setup()
    tok_sets = [set(tokens[v].tolist()) for v in range(g.n_real)]
    eng = keyword.make_keyword_engine(port_graph(g), padded, capacity=4, delta_max=DELTA,
                                      backend=backend, block=16, device="cpu")
    res, _ = _drain(eng, _kw_queries())
    for qid, q in enumerate(_kw_queries()):
        kws = [int(k) for k in q if k >= 0]
        dists = _oracle_keyword(g, tok_sets, kws, DELTA)
        roots = {v for v in range(g.n_real) if all(dists[i, v] < INF for i in range(len(kws)))}
        assert int(res[qid]["num_roots"]) == len(roots), kws
        for r, sc in zip(res[qid]["top_roots"], res[qid]["top_scores"]):
            if sc < INF and r < g.n_real:
                assert int(r) in roots and sc == dists[:, int(r)].sum(), (kws, r)


def test_keyword_on_the_jax_index():
    """The port answers on the token table the JAX package's index holds."""
    g, _, padded = _kw_setup()
    jidx = jkeyword.InvertedIndex(padded)
    idx = carry.inverted_index_from_numpy(np.asarray(jidx.tokens), "cpu")
    q = _kw_queries()[0]
    for k in range(keyword.MAXK):
        np.testing.assert_array_equal(idx.match(torch.from_numpy(q[k:k + 1]))[0].numpy(),
                                      np.asarray(jidx.match(q[k])))
