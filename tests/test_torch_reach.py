"""P2P reachability (paper §5.4) across packages: SCC condensation (host
and device), DFS orders, the five label arrays and the pruned BiBFS
answers of the port equal the JAX package's on the same numpy-built
graphs, int32 bit for bit; the port's answers also match networkx."""
import collections
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import networkx as nx
import numpy as np

from repro.apps import ppsp as jppsp
from repro.apps import reach as jreach
from repro.core.graph import random_dag, random_graph

from repro_torch import carry
from repro_torch.apps import ppsp, reach

from _torch_common import assert_same_results, fields_np, port_graph
from conftest import nx_of

INDEX_FIELDS = ("level", "pre", "yes_hi", "post", "no_lo")
BACKENDS = ["coo", "cuda"]


@functools.lru_cache(maxsize=None)
def _dag():
    return random_dag(80, 2.5, seed=13)


@functools.lru_cache(maxsize=None)
def _jax_index():
    return jreach.build_reach_index(_dag())


@functools.lru_cache(maxsize=None)
def _index():
    return reach.build_reach_index(port_graph(_dag()))


def _pairs(capacity):
    return np.random.default_rng(17 + capacity).integers(0, _dag().n_real, (24, 2)).astype(
        np.int32)


def _drain(eng, queries):
    for q in queries:
        eng.submit(q)
    return eng.run_until_drained(), eng.stats.rounds


@functools.lru_cache(maxsize=None)
def _jax_answers(capacity):
    eng = jreach.make_reach_engine(_dag(), _jax_index(), capacity=capacity)
    return _drain(eng, [jnp.asarray(p) for p in _pairs(capacity)])


@pytest.mark.parametrize("seed,avg_deg", [(31, 2.2), (5, 1.5)])
def test_scc_condense_matches_jax(seed, avg_deg):
    g = random_graph(70, avg_deg, seed=seed)
    comp, dag = reach.scc_condense(port_graph(g))
    jcomp, jdag = jreach.scc_condense(g)
    assert comp.dtype == jcomp.dtype and comp.tobytes() == jcomp.tobytes()
    assert dag.content_hash() == jdag.content_hash()
    assert nx.is_directed_acyclic_graph(nx_of(jdag))


def test_scc_condense_device_matches_jax():
    g = random_graph(50, 2.0, seed=37)
    comp, dag = reach.scc_condense_device(port_graph(g))
    jcomp, jdag = jreach.scc_condense_device(g)
    jcomp = np.asarray(jcomp)
    assert comp.dtype == jcomp.dtype and comp.tobytes() == jcomp.tobytes()
    assert dag.content_hash() == jdag.content_hash()

    def groups(c):  # the same partition as the host algorithm's
        m = collections.defaultdict(set)
        for v, k in enumerate(c[: g.n_real]):
            m[int(k)].add(v)
        return sorted(map(sorted, m.values()))

    assert groups(comp) == groups(jreach.scc_condense(g)[0])


def test_dfs_orders_match_jax():
    pre, post = reach.dfs_orders(port_graph(_dag()))
    jpre, jpost = jreach.dfs_orders(_dag())
    for a, b in ((pre, jpre), (post, jpost)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_reach_index_matches_jax():
    """The five label arrays int32 bit for bit (three COO fixpoints)."""
    want = fields_np(_jax_index())
    for name in INDEX_FIELDS:
        got = getattr(_index(), name).numpy()
        assert got.dtype == want[name].dtype == np.int32, name
        assert got.tobytes() == want[name].tobytes(), name


def test_level_label_is_longest_path():
    G = nx_of(_dag())
    want = {v: 0 for v in G.nodes}
    for v in nx.topological_sort(G):
        for u in G.predecessors(v):
            want[v] = max(want[v], want[u] + 1)
    lvl = _index().level.numpy()
    assert all(lvl[v] == want[v] for v in range(_dag().n_real))


@pytest.mark.parametrize("capacity", [2, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_reach_queries_match_jax(capacity, backend):
    """Per query ``reach`` and ``visited``, and the rounds, on the port's
    own index."""
    eng = reach.make_reach_engine(port_graph(_dag()), _index(), capacity=capacity,
                                  backend=backend, block=16, device="cpu")
    res, rounds = _drain(eng, _pairs(capacity))
    jres, jrounds = _jax_answers(capacity)
    assert_same_results(res, jres)
    assert rounds == jrounds


@pytest.mark.parametrize("backend", BACKENDS)
def test_reach_queries_on_the_jax_index(backend):
    idx = carry.reach_index_from_numpy(fields_np(_jax_index()), device="cpu")
    eng = reach.make_reach_engine(port_graph(_dag()), idx, capacity=4, backend=backend,
                                  block=16, device="cpu")
    res, _ = _drain(eng, _pairs(4))
    assert_same_results(res, _jax_answers(4)[0])
    G = nx_of(_dag())
    for qid, (s, t) in enumerate(_pairs(4)):
        assert bool(res[qid]["reach"]) == nx.has_path(G, int(s), int(t)), (s, t)


def test_labels_prune_access():
    """Pruned BiBFS touches no more vertices than label-free BiBFS."""
    g = port_graph(_dag())
    pruned = reach.make_reach_engine(g, _index(), capacity=4, device="cpu")
    plain = ppsp.make_bibfs_engine(g, capacity=4, device="cpu")
    pairs = np.random.default_rng(23).integers(0, g.n_real, (15, 2)).astype(np.int32)
    v_pruned = sum(int(pruned.query(p)["visited"]) for p in pairs)
    v_plain = sum(int(plain.query(p)["visited"]) for p in pairs)
    assert v_pruned <= v_plain
    jplain = jppsp.make_bibfs_engine(_dag(), capacity=4)
    assert v_plain == sum(int(jplain.query(jnp.asarray(p))["visited"]) for p in pairs)
