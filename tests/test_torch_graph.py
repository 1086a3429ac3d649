"""Graph build parity across packages: the port's generators and layouts
give byte-identical arrays and equal content hashes."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import graph as jgraph
from repro.core.semiring import BY_NAME as J_BY_NAME

from repro_torch.core import graph as tgraph

from _torch_common import fields_np, port_graph

ARRAYS = ("src", "dst", "w", "in_deg", "out_deg", "csr_row", "csr_src",
          "csr_dst", "csr_w")


def assert_graph_equal(tg, jg):
    assert (tg.n, tg.n_real) == (jg.n, jg.n_real)
    for name in ARRAYS:
        a = getattr(tg, name).numpy()
        b = np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    assert tg.content_hash() == jg.content_hash()


@pytest.mark.parametrize("n,m,directed", [(50, 1, False), (400, 3, False),
                                          (3000, 3, False), (300, 2, True)])
def test_barabasi_albert_identical(n, m, directed):
    assert_graph_equal(
        tgraph.barabasi_albert(n, m, seed=n, directed=directed, device="cpu"),
        jgraph.barabasi_albert(n, m, seed=n, directed=directed))


@pytest.mark.parametrize("directed", [True, False])
def test_random_graph_identical(directed):
    assert_graph_equal(
        tgraph.random_graph(150, 2.5, seed=4, directed=directed, device="cpu"),
        jgraph.random_graph(150, 2.5, seed=4, directed=directed))


def test_multi_component_graph_identical():
    assert_graph_equal(tgraph.multi_component_graph(4, 25, 2.0, seed=3, device="cpu"),
                       jgraph.multi_component_graph(4, 25, 2.0, seed=3))


def test_reverse_padded_undirected_identical():
    jg = jgraph.random_graph(90, 3.0, seed=8)
    tg = port_graph(jg)
    assert_graph_equal(tg.reverse(), jg.reverse())
    assert_graph_equal(tg.padded(16), jg.padded(16))
    assert_graph_equal(tg.undirected(), jg.undirected())


def _assert_blocks_equal(tb, jb):
    want = fields_np(jb)
    assert tb.block == want["block"]
    for name in ("src_ids", "tiles", "nslots"):
        a, b = getattr(tb, name).numpy(), want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("sr_name", sorted(J_BY_NAME))
@pytest.mark.parametrize("block", [8, 16])
def test_to_blocks_identical(sr_name, block):
    """Every semiring's add_id, with duplicate edges whose weights the
    multi-edge rule has to combine (min / max / sum)."""
    rng = np.random.default_rng(block)
    jg0 = jgraph.random_graph(70, 3.0, seed=block)
    s, d = np.asarray(jg0.src), np.asarray(jg0.dst)
    dup = rng.integers(0, len(s), 40)
    src = np.concatenate([s, s[dup]])
    dst = np.concatenate([d, d[dup]])
    w = rng.integers(1, 9, len(src)).astype(np.int32)
    jg = jgraph.Graph.from_edges(src, dst, 70, w=w)
    add_id = J_BY_NAME[sr_name].add_id
    _assert_blocks_equal(port_graph(jg).to_blocks(block, add_id),
                         jg.to_blocks(block, add_id))


@pytest.mark.parametrize("add_id", [0.0, float(2**30)])
def test_to_blocks_float_weights_identical(add_id):
    """Float weights: summed duplicates (in edge order) and min-combined."""
    rng = np.random.default_rng(5)
    jg0 = jgraph.random_graph(50, 3.0, seed=9)
    s, d = np.asarray(jg0.src), np.asarray(jg0.dst)
    src, dst = np.concatenate([s, s[:20]]), np.concatenate([d, d[:20]])
    w = rng.standard_normal(len(src)).astype(np.float32)
    jg = jgraph.Graph.from_edges(src, dst, 50, w=w, weight_dtype=np.float32)
    _assert_blocks_equal(port_graph(jg).to_blocks(16, add_id, dtype=np.float32),
                         jg.to_blocks(16, add_id, dtype=np.float32))
