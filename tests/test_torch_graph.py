"""Graph build parity across packages: the port's generators and layouts
give byte-identical arrays and equal content hashes."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import graph as jgraph
from repro.core.semiring import BY_NAME as J_BY_NAME

from repro_torch import carry
from repro_torch.core import graph as tgraph
from repro_torch.core.semiring import BY_NAME, MIN_PLUS, MIN_RIGHT

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


def _dup_graph(sr_name, dtype, seed):
    """70 vertices (no multiple of 8, 16 or 128) with duplicate edges, and
    weights the packer must drop: one equal to add_id, and a duplicate pair
    whose combined value is add_id (two add_ids under min/max, w and -w
    under sum)."""
    add_id = J_BY_NAME[sr_name].add_id
    rng = np.random.default_rng(seed)
    jg0 = jgraph.random_graph(70, 3.0, seed=seed)
    s, d = np.asarray(jg0.src), np.asarray(jg0.dst)
    dup = rng.integers(0, len(s), 30)
    src = np.concatenate([s, s[dup], s[:2]])
    dst = np.concatenate([d, d[dup], d[:2]])
    if dtype == np.float32:
        w = rng.standard_normal(len(src)).astype(np.float32)
    else:
        w = rng.integers(1, 9, len(src)).astype(np.int32)
    w[len(s) - 3] = add_id                   # a lone edge equal to add_id
    w[0] = add_id if add_id else w[-2]       # edge 0 and its duplicate at
    w[-2] = add_id if add_id else -w[-2]     # the end combine to add_id
    return jgraph.Graph.from_edges(src, dst, 70, w=w, weight_dtype=dtype)


def _densify(pb, add_id):
    """The dense (nb, max_bpr, B, B) table a packed one stands for."""
    nb, m, b = pb.num_dst_blocks, pb.max_bpr, pb.block
    w = pb.w.numpy()
    dense = np.full((nb, m, b, b), add_id, dtype=w.dtype)
    i = np.repeat(np.arange(nb), np.diff(pb.row_ptr.numpy()))
    k, r, c = (t.numpy() for t in pb.decode())
    dense[i, k, r, c] = w
    return dense


def _assert_packed_equal(a, b):
    assert (a.block, a.dtype) == (b.block, b.dtype)
    for name in ("src_ids", "nslots", "row_ptr", "entries", "w"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.numpy().tobytes() == y.numpy().tobytes(), name


@pytest.mark.parametrize("sr_name", sorted(J_BY_NAME))
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["int32", "float32"])
@pytest.mark.parametrize("block", [8, 16, 128])
def test_to_packed_blocks_is_the_nonidentity_of_to_blocks(sr_name, dtype, block):
    """The packed entries are exactly the entries of the dense table that
    differ from add_id, values bit for bit (duplicate float sums in edge
    order); packing the dense table, built here or by the JAX package and
    carried across, gives the same arrays.  A ``*_right`` semiring keeps
    the entries of its weighted twin (the same add-identity) but no
    values."""
    add_id = J_BY_NAME[sr_name].add_id
    sr = BY_NAME[sr_name]
    weighted = BY_NAME[sr_name.replace("_right", "_plus")]
    jg = _dup_graph(sr_name, dtype, seed=block)
    tg = port_graph(jg)
    dense = tg.to_blocks(block, add_id)
    pb = tg.to_packed_blocks(block, weighted)
    np.testing.assert_array_equal(pb.src_ids.numpy(), dense.src_ids.numpy())
    np.testing.assert_array_equal(pb.nslots.numpy(), dense.nslots.numpy())
    assert _densify(pb, add_id).tobytes() == dense.tiles.numpy().tobytes()
    w = pb.w.numpy()
    assert (w != add_id).all()
    assert pb.entries.numel() == int((dense.tiles != add_id).sum())
    # the add_id weights and the pair that combines to add_id were dropped
    pairs = np.unique(np.asarray(jg.src).astype(np.int64) * 70 + np.asarray(jg.dst))
    assert pb.entries.numel() < len(pairs)
    _assert_packed_equal(tgraph.pack_blocks(dense, weighted), pb)
    carried = carry.blocks_from_numpy(fields_np(jg.to_blocks(block, add_id)),
                                      device="cpu")
    _assert_packed_equal(tgraph.pack_blocks(carried, weighted), pb)
    own = tg.to_packed_blocks(block, sr)
    _assert_packed_equal(tgraph.pack_blocks(dense, sr), own)
    if sr.reads_weight:
        _assert_packed_equal(own, pb)
    else:
        assert own.w is None and torch.equal(own.entries, pb.entries)
        assert own.nbytes == pb.nbytes - pb.w.numel() * 4


def test_packed_blocks_refuse_what_an_entry_cannot_hold():
    g = tgraph.random_graph(40, 2.0, seed=1, device="cpu")
    with pytest.raises(ValueError, match="block"):
        g.to_packed_blocks(2048, MIN_PLUS)
    pb = g.to_packed_blocks(8, MIN_PLUS)
    moved = pb.to("cpu")
    _assert_packed_equal(moved, pb)


@pytest.mark.parametrize("chunk", [1, 7, 1024])
def test_work_items_cover_every_entry_once(chunk):
    """The CUDA kernel's work list: runs of at most ``chunk`` entries, each
    inside one destination row, covering every entry exactly once (a hub
    row of barabasi_albert(4096, 3) spans several items at 1024)."""
    pb = tgraph.barabasi_albert(4096, 3, seed=0, device="cpu").to_packed_blocks(
        128, MIN_RIGHT)
    items = pb.work_items(chunk)
    assert items.dtype == torch.int32 and pb.work_items(chunk) is items
    row, first, end = items.long().unbind(1)
    rp = pb.row_ptr.long()
    assert ((end - first >= 1) & (end - first <= chunk)).all()
    assert ((rp[row] <= first) & (end <= rp[row + 1])).all()
    covered = torch.zeros(pb.entries.numel(), dtype=torch.int64)
    for a, b in zip(first.tolist(), end.tolist()):
        covered[a:b] += 1
    assert (covered == 1).all()
    if chunk == 1024:
        assert int(torch.bincount(row).max()) > 1
