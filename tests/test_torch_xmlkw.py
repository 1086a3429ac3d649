"""XML keyword search (paper §5.2) across packages: SLCANaive,
SLCALevelAligned and MaxMatch in the port give the JAX package's slca,
elca and labeled masks and counts on the same numpy-built trees and
queries (MaxMatch moves 21 lanes per slot: Q = 42 at C = 2, which is no
multiple of the kernel's 8-lane tile), and match the brute-force oracles
of ``tests/test_xmlkw.py``."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import keyword as jkeyword
from repro.apps import xmlkw as jxmlkw
from repro.core.graph import random_tree

from repro_torch import carry
from repro_torch.apps import xmlkw

from _torch_common import assert_same_results, fields_np, port_graph
from test_xmlkw import oracle_elca, oracle_maxmatch, oracle_slca

PROGRAMS = ["SLCANaive", "SLCALevelAligned", "MaxMatch"]
# (tree size, seed, slots): trees of 60-200 vertices over three seeds
SETUPS = [(60, 0, 2), (120, 1, 4), (200, 2, 2)]


@functools.lru_cache(maxsize=None)
def _setup(n, seed):
    g, parent = random_tree(n, max_fanout=4, seed=seed)
    tokens = jkeyword.make_vertex_text(n, 12, 3, seed=seed + 1)
    return g, parent, tokens, jxmlkw.build_xml_index(parent, tokens, g.n)


def _queries(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        kws = rng.integers(0, 8, rng.integers(1, 4))
        q = np.full(xmlkw.MAXK, -1, np.int32)
        q[: len(kws)] = kws
        out.append(q)
    return out


def _drain(eng, queries):
    for q in queries:
        eng.submit(q)
    return eng.run_until_drained(), eng.stats.rounds


@functools.lru_cache(maxsize=None)
def _jax_answers(prog, n, seed, capacity):
    g, _, _, idx = _setup(n, seed)
    eng = jxmlkw.make_xml_engine(getattr(jxmlkw, prog), g, idx, capacity=capacity)
    return _drain(eng, [jnp.asarray(q) for q in _queries(seed)])


def test_xml_index_matches_jax():
    for n, seed, _ in SETUPS:
        g, parent, tokens, jidx = _setup(n, seed)
        idx = xmlkw.build_xml_index(parent, tokens, g.n, device="cpu")
        want = fields_np(jidx)
        for name in ("tokens", "level", "parent"):
            got = getattr(idx, name).numpy()
            assert got.dtype == want[name].dtype and got.tobytes() == want[name].tobytes()


@pytest.mark.parametrize("prog", PROGRAMS)
@pytest.mark.parametrize("n,seed,capacity", SETUPS)
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_xml_matches_jax_and_oracle(prog, n, seed, capacity, backend):
    g, parent, tokens, _ = _setup(n, seed)
    idx = xmlkw.build_xml_index(parent, tokens, g.n, device="cpu")
    eng = xmlkw.make_xml_engine(getattr(xmlkw, prog), port_graph(g), idx,
                                capacity=capacity, backend=backend, block=16, device="cpu")
    res, rounds = _drain(eng, _queries(seed))
    jres, jrounds = _jax_answers(prog, n, seed, capacity)
    assert_same_results(res, jres)
    assert rounds == jrounds
    tok_sets = [set(tokens[v].tolist()) for v in range(n)]
    for qid, q in enumerate(_queries(seed)):
        kws = [int(k) for k in q if k >= 0]
        got = lambda key: set(np.nonzero(res[qid][key][:n])[0].tolist())
        if prog == "MaxMatch":
            assert got("labeled") == oracle_maxmatch(parent, tok_sets, kws), kws
            continue
        assert got("slca") == oracle_slca(parent, tok_sets, kws), kws
        if prog == "SLCALevelAligned":
            assert got("elca") == oracle_elca(parent, tok_sets, kws), kws


@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_xml_on_the_jax_index_deep_tree(backend):
    """The port queries the index the JAX package built, on a deep tree
    (a locality window of parents, O(n) depth)."""
    g, parent = random_tree(150, max_fanout=3, seed=5, deep=True)
    tokens = jkeyword.make_vertex_text(150, 10, 3, seed=6)
    jidx = jxmlkw.build_xml_index(parent, tokens, g.n)
    idx = carry.xml_index_from_numpy(fields_np(jidx), device="cpu")
    queries = _queries(5)
    for prog in ("SLCALevelAligned", "MaxMatch"):
        eng = xmlkw.make_xml_engine(getattr(xmlkw, prog), port_graph(g), idx, capacity=4,
                                    backend=backend, block=16, device="cpu")
        jeng = jxmlkw.make_xml_engine(getattr(jxmlkw, prog), g, jidx, capacity=4)
        assert_same_results(_drain(eng, queries)[0],
                            _drain(jeng, [jnp.asarray(q) for q in queries])[0])
