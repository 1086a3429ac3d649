"""The port's edge partitions and sharded propagation against the JAX
package's ``core/distributed.py``.

In-process, with no process group: ``_pad_partition`` and the
``ShardedGraph`` arrays are byte-equal to the JAX package's for both
partitions, and the shard-local splice ``ShardedGraph.apply_delta``
equals the JAX splice and a full re-partition, Emax fallback included.

Across ranks: one spawned 8-rank gloo group on a (2, 4) mesh sharding
"model" runs ``make_propagate_sharded`` for min_plus, min_right and
max_right (int32, exact) and sum_times (float32, 1e-4/1e-5) on both
partitions, against the JAX ``ref.propagate_coo`` of the same inputs,
then BFS through ``propagate_override`` against networkx (the port of
tests/test_distributed.py's subprocess)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import distributed as jdist
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph
from repro.core.semiring import BY_NAME as JSR
from repro.kernels import ref as jref

from repro_torch.core import distributed as tdist

import _torch_mesh
from _torch_common import fields_np, port_graph, rand_x
from conftest import nx_of

PARTS = ["dst", "src"]
PROP_CASES = [(sr, part) for sr in ("min_plus", "min_right", "max_right", "sum_times")
              for part in PARTS]


@functools.lru_cache(maxsize=None)
def _graphs():
    """(int32 graph, float32-weighted graph, BFS graph), all |V| = 64."""
    g = random_graph(64, 3.0, seed=1, directed=True)
    gw = random_graph(64, 3.0, seed=2, directed=True)
    rng = np.random.default_rng(0)
    g2 = JGraph.from_edges(np.asarray(gw.src), np.asarray(gw.dst), gw.n_real,
                           w=rng.standard_normal(gw.num_edges), weight_dtype=np.float32)
    return g, g2, random_graph(64, 2.5, seed=5, directed=True)


def _same_partitions(t, j):
    for name in ("srcp", "dstp", "wp", "valid"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# ------------------------------------------------------ in-process, no group
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("part", PARTS)
def test_partitions_byte_equal_jax(part, weighted):
    jg = _graphs()[1 if weighted else 0]
    src, dst, w = jg._edges_np()
    for n_parts in (1, 4, 8):
        key = (dst if part == "dst" else src) // (jg.n // n_parts)
        for a, b in zip(tdist._pad_partition(src, dst, w, n_parts, key),
                        jdist._pad_partition(src, dst, w, n_parts, key)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        sg = tdist.ShardedGraph(port_graph(jg), n_parts, partition=part)
        _same_partitions(sg, jdist.ShardedGraph(jg, n_parts, partition=part))
        assert sg.block == jg.n // n_parts


def test_partition_refuses_unpadded_vertex_count():
    g = port_graph(random_graph(60, 3.0, seed=2, directed=True))
    with pytest.raises(ValueError, match="Graph.padded"):
        tdist.ShardedGraph(g, 8)
    tdist.ShardedGraph(g.padded(8), 8)


def _tail_graph():
    """tests/test_mutation.py's tail graph, padded to 64 vertices."""
    g = random_graph(48, 3.0, seed=1, directed=True)
    src = np.concatenate([np.asarray(g.src), np.arange(48, 59)])
    dst = np.concatenate([np.asarray(g.dst), np.arange(49, 60)])
    return JGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), 60).padded(64)


@pytest.mark.parametrize("part", PARTS)
def test_sharded_splice_matches_jax_and_full_repartition(part):
    """The shard-local splice equals the JAX splice byte for byte, and each
    row holds what a full re-partition puts there; a row outgrowing Emax
    falls back to the full path (tests/test_mutation.py::
    test_sharded_splice_matches_full_repartition, in the port)."""
    jg = _tail_graph()
    g = port_graph(jg)
    es, ed = np.asarray(jg.src), np.asarray(jg.dst)
    dels = [(int(es[4]), int(ed[4]))]
    adds = [(3, 17), (40, 2), (59, 1)]
    jsg = jdist.ShardedGraph(jg, 8, partition=part)
    sg = tdist.ShardedGraph(g, 8, partition=part)
    emax0 = int(sg.srcp.shape[1])

    jdelta = jg.make_delta(adds=adds, dels=dels)
    delta = g.make_delta(adds=adds, dels=dels)
    spliced = sg.apply_delta(g.apply_delta(delta), delta)
    _same_partitions(spliced, jsg.apply_delta(jg.apply_delta(jdelta), jdelta))
    assert int(spliced.srcp.shape[1]) == emax0
    full = tdist.ShardedGraph(g.apply_delta(delta), 8, partition=part)
    for r in range(8):
        for a, b in ((spliced.srcp, full.srcp), (spliced.dstp, full.dstp),
                     (spliced.wp, full.wp)):
            assert torch.equal(a[r][spliced.valid[r]], b[r][full.valid[r]]), (part, r)
    touched = set((delta if part == "dst" else delta.reversed())
                  .touched_dst_blocks(sg.block).tolist())
    untouched = [r for r in range(8) if r not in touched]
    assert untouched
    for r in untouched:
        assert torch.equal(spliced.srcp[r], sg.srcp[r])

    blk0 = [(s, 0) if part == "dst" else (0, s) for s in range(1, emax0 + 6)]
    dd, jdd = g.make_delta(adds=blk0), jg.make_delta(adds=blk0)
    fb = sg.apply_delta(g.apply_delta(dd), dd)
    _same_partitions(fb, jsg.apply_delta(jg.apply_delta(jdd), jdd))
    _same_partitions(fb, tdist.ShardedGraph(g.apply_delta(dd), 8, partition=part))
    assert int(fb.srcp.shape[1]) > emax0


# ------------------------------------------------------- 8 spawned ranks
def _prop_inputs():
    rng = np.random.default_rng(0)
    g, g2, _ = _graphs()
    xs = {}
    for sr, part in PROP_CASES:
        if sr == "sum_times":
            xs[sr, part] = ("float", rng.standard_normal((2, g2.n)).astype(np.float32))
        else:
            xs[sr, part] = ("int", rand_x(rng, sr, g.n, 3))
    return xs


def _bfs_pairs():
    return np.random.default_rng(3).integers(0, _graphs()[2].n_real, (6, 2)).tolist()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g, g2, g3 = _graphs()
    return _torch_mesh.run_ranks(
        8, "propagate_work", tmp_path_factory.mktemp("dist8"), timeout=240,
        g={"int": fields_np(g), "float": fields_np(g2)}, xs=_prop_inputs(),
        g3=fields_np(g3), pairs=_bfs_pairs())


@pytest.mark.parametrize("sr,part", PROP_CASES)
def test_sharded_propagate_matches_jax(ranks, sr, part):
    g, g2, _ = _graphs()
    gkey, x = _prop_inputs()[sr, part]
    want = np.asarray(jref.propagate_coo(g2 if gkey == "float" else g, JSR[sr], x))
    for r, out in enumerate(ranks):
        got = out[sr, part]
        assert got.dtype == want.dtype and got.shape == want.shape
        if sr == "sum_times":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_bfs_through_sharded_override_matches_networkx(ranks):
    import networkx as nx

    G = nx_of(_graphs()[2])
    for i, (s, t) in enumerate(_bfs_pairs()):
        try:
            want = nx.shortest_path_length(G, int(s), int(t))
        except nx.NetworkXNoPath:
            want = 2**30
        for out in ranks:
            assert out["bfs"][i] == want, (s, t)
