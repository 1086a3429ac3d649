"""Versioned mutable graphs in the port against the JAX package.

Graph layer: ``Graph.apply_delta`` splices a batched edge delta into both
adjacency views; every array, degree, ``content_hash``, version and
parent hash must equal the JAX package's splice of the same delta on the
same graph, with its edge cases (duplicate-add last wins, upsert,
self-loops, delete-of-absent refused, padded-range endpoints refused,
empty delta a version-bumping no-op), and capacity padding must be
invisible to the content.  The dense table splice (``update_blocks``) is
byte-identical to the JAX package's, and the packed one
(``update_packed_blocks``) equals ``to_packed_blocks`` of the mutated
graph array for array.

Index layer: ``maintain_hub_index`` (the port re-labels affected hubs in
one batched BFS on the device) equals the JAX package's maintenance and a
rebuild with the hub set pinned.

Serving layer: every query answers on the graph version it was admitted
under, equal to the JAX engine's answer at that version; the result
cache never serves across versions; arg-carried editions keep their
shapes across in-capacity deltas; journals with mutation records written
by the JAX engine are replayed by the port's recovery, and a JAX
version-1 suspend payload resumes in the port's engine.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import hub2 as jhub2
from repro.apps import ppsp as jppsp
from repro.core import runtime as jruntime
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph
from repro.launch import supervise as jsupervise
from repro.train.fault import FailureInjector as JFailureInjector

from repro_torch import carry
from repro_torch.apps import hub2, ppsp
from repro_torch.core.graph import BlockSparse, EdgeDelta, Graph
from repro_torch.core.runtime import ResultCache, QueryJournal, _MISS
from repro_torch.core.semiring import BY_NAME, INF, MIN_PLUS, MIN_RIGHT
from repro_torch.kernels import ops, ref
from repro_torch.launch.supervise import recover, run_with_recovery
from repro_torch.train.fault import FailureInjector

from _torch_common import assert_same_results, fields_np, port_blocks, port_graph

SPR = [1, 4]
GRAPH_FIELDS = ("src", "dst", "w", "in_deg", "out_deg", "csr_row", "csr_src",
                "csr_dst", "csr_w")


# --------------------------------------------------------------- helpers
@functools.lru_cache(maxsize=None)
def _tail_graph():
    """The JAX tests' 60-vertex graph: random core + a path tail
    48 -> ... -> 59, so queries on the tail are in flight for many rounds."""
    g = random_graph(48, 3.0, seed=1, directed=True)
    src = np.concatenate([np.asarray(g.src), np.arange(48, 59)])
    dst = np.concatenate([np.asarray(g.dst), np.arange(49, 60)])
    return JGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), 60)


def _same_graph(tg, jg):
    """Every array, size, lineage field and the content hash equal."""
    assert (tg.n, tg.n_real, tg.version, tg.parent_hash) == (
        jg.n, jg.n_real, jg.version, jg.parent_hash)
    assert tg.num_edges == jg.num_edges and tg.edge_capacity == jg.edge_capacity
    for f in GRAPH_FIELDS:
        a, b = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tg.content_hash() == jg.content_hash()


def _edge_map(g):
    s, d, w = g._edges_np()
    return {(int(a), int(b)): c for a, b, c in zip(s, d, w)}


def _non_edge(jg, rng):
    pairs = set(zip(np.asarray(jg.src).tolist(), np.asarray(jg.dst).tolist()))
    while True:
        a, b = (int(v) for v in rng.integers(0, jg.n_real, 2))
        if a != b and (a, b) not in pairs and (b, a) not in pairs:
            return a, b


def _jax_answer(jg, q, factory=jppsp.make_bfs_engine):
    e = factory(jg, capacity=2)
    qid = e.submit(jnp.asarray(q, jnp.int32))
    return {k: np.asarray(v) for k, v in e.run_until_drained()[qid].items()}


def _check_answer(got, want):
    assert_same_results({0: got}, {0: want})


# ===================================================== graph-layer deltas
def test_apply_delta_matches_jax(small_directed):
    jg = small_directed
    tg = port_graph(jg)
    rng = np.random.default_rng(7)
    adds = [_non_edge(jg, rng) for _ in range(5)]
    es, ed = np.asarray(jg.src), np.asarray(jg.dst)
    dels = [(int(es[i]), int(ed[i])) for i in (0, 10, 25)]
    w = np.arange(2, 7).astype(np.asarray(jg.w).dtype)
    tg1, jg1 = tg.apply_delta(adds, dels, w=w), jg.apply_delta(adds, dels, w=w)
    assert tg1.version == 1 and tg1.parent_hash == tg.content_hash()
    _same_graph(tg1, jg1)
    # nothing of the parent was written
    _same_graph(tg, jg)
    # a chain of deltas keeps the hash chain equal
    tg2 = tg1.apply_delta(dels=[adds[0]], adds=[dels[0]])
    jg2 = jg1.apply_delta(dels=[adds[0]], adds=[dels[0]])
    _same_graph(tg2, jg2)
    # propagate is identical on the spliced and the rebuilt graph
    s, d, ww = tg2._edges_np()
    rebuilt = Graph.from_edges(s, d, tg2.n_real, w=ww, weight_dtype=ww.dtype, device="cpu")
    x = torch.from_numpy(rng.integers(0, 50, (2, tg.n)).astype(np.int32))
    assert torch.equal(ref.propagate_coo(tg2, MIN_PLUS, x),
                       ref.propagate_coo(rebuilt, MIN_PLUS, x))


def test_duplicate_add_last_wins_and_upsert(small_directed):
    jg = small_directed
    tg = port_graph(jg)
    wd = np.asarray(jg.w).dtype
    a, b = _non_edge(jg, np.random.default_rng(3))
    cases = [dict(adds=[(a, b), (a, b)], w=np.asarray([5, 9], wd))]
    s0, d0 = int(np.asarray(jg.src)[4]), int(np.asarray(jg.dst)[4])
    cases += [dict(adds=[(s0, d0)], w=np.asarray([3], wd)),
              dict(adds=[(s0, d0)], dels=[(s0, d0)], w=np.asarray([7], wd))]
    for kw in cases:
        tg1 = tg.apply_delta(**kw)
        _same_graph(tg1, jg.apply_delta(**kw))
    assert _edge_map(tg.apply_delta(**cases[0]))[(a, b)] == 9
    assert _edge_map(tg.apply_delta(**cases[2]))[(s0, d0)] == 7


def test_self_loop_add_delete(small_directed):
    tg = port_graph(small_directed)
    g1 = tg.apply_delta(adds=[(4, 4)])
    assert _edge_map(g1)[(4, 4)] == 1 and g1.num_edges == tg.num_edges + 1
    _same_graph(g1, small_directed.apply_delta(adds=[(4, 4)]))
    g2 = g1.apply_delta(dels=[(4, 4)])
    assert g2.content_hash() == tg.content_hash() and g2.version == 2


def test_delete_nonexistent_raises_without_corruption(small_directed):
    tg = port_graph(small_directed)
    a, b = _non_edge(small_directed, np.random.default_rng(11))
    before = tg.content_hash()
    with pytest.raises(ValueError, match="not present"):
        tg.make_delta(dels=[(a, b)])
    with pytest.raises(ValueError, match="not present"):
        tg.apply_delta(dels=[(a, b)])
    assert tg.content_hash() == before and tg.version == 0
    _same_graph(tg, small_directed)


def test_delta_in_padded_range_refused(small_directed):
    gp = port_graph(small_directed.padded(8))
    assert gp.n == 64 and gp.n_real == 60
    for kw in (dict(adds=[(60, 63)]), dict(adds=[(5, 61)]), dict(dels=[(62, 63)])):
        with pytest.raises(ValueError, match="real vertex range"):
            gp.make_delta(**kw)
    a, b = _non_edge(small_directed, np.random.default_rng(0))
    _same_graph(gp.apply_delta(adds=[(a, b)]),
                small_directed.padded(8).apply_delta(adds=[(a, b)]))


def test_empty_delta_is_version_bumping_noop(small_directed):
    tg = port_graph(small_directed)
    h = tg.content_hash()
    assert tg.content_hash() is h  # memoized
    g1 = tg.apply_delta()
    assert g1.version == 1 and g1.parent_hash == h and g1.content_hash() == h
    assert g1.src is tg.src and g1.csr_row is tg.csr_row  # arrays shared


def test_make_delta_matches_jax_and_carries(small_directed):
    jg = small_directed
    tg = port_graph(jg)
    rng = np.random.default_rng(17)
    adds = [_non_edge(jg, rng) for _ in range(4)] + [(1, 2), (1, 2)]
    dels = [(int(np.asarray(jg.src)[i]), int(np.asarray(jg.dst)[i])) for i in (3, 3, 9)]
    jd, td = jg.make_delta(adds, dels), tg.make_delta(adds, dels)
    cd = carry.edge_delta_from_numpy(fields_np(jd))
    for f in ("add_src", "add_dst", "add_w", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
        np.testing.assert_array_equal(getattr(cd, f), getattr(jd, f))
        assert getattr(td, f).dtype == getattr(jd, f).dtype
    assert isinstance(cd, EdgeDelta) and td.size == jd.size
    for b in (4, 16):
        np.testing.assert_array_equal(td.touched_dst_blocks(b), jd.touched_dst_blocks(b))
    r = td.reversed()
    np.testing.assert_array_equal(r.add_src, jd.reversed().add_src)
    _same_graph(tg.apply_delta(cd), jg.apply_delta(jd))


def test_blocksparse_nslots_required():
    with pytest.raises(TypeError):
        BlockSparse(src_ids=torch.zeros((1, 1), dtype=torch.int32),
                    tiles=torch.zeros((1, 1, 4, 4)), block=4)


def test_update_blocks_matches_jax():
    """The vectorized splice is byte-identical to the JAX per-edge loop,
    growth of the slot axis included, and propagates as the COO view."""
    n = 60
    src, dst = np.arange(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32)
    jg = JGraph.from_edges(src, dst, n)
    tg = port_graph(jg)
    jbs = jg.to_blocks(16, MIN_PLUS.add_id)
    tbs = port_blocks(jbs)
    delta = jg.make_delta(adds=[(59, 0), (30, 1)], dels=[(0, 1)])
    jg1, tg1 = jg.apply_delta(delta), tg.apply_delta(carry.edge_delta_from_numpy(
        fields_np(delta)))
    touched = delta.touched_dst_blocks(16)
    for t in (touched, None):
        want = jg1.update_blocks(jbs, MIN_PLUS.add_id, t)
        got = tg1.update_blocks(tbs, MIN_PLUS.add_id, t)
        for f in ("src_ids", "tiles", "nslots"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert got.tiles.shape[1] > tbs.tiles.shape[1]
        x = torch.from_numpy(np.random.default_rng(0).integers(0, 40, (2, n)).astype(np.int32))
        assert torch.equal(ref.propagate_blocks_ref(got, MIN_PLUS, x)[:, :n],
                           ref.propagate_coo(tg1, MIN_PLUS, x))


@pytest.mark.parametrize("sr_name,dtype", [
    ("min_plus", np.int32), ("min_right", np.int32), ("max_right", np.int32),
    ("sum_times", np.float32), ("max_plus", np.float32)])
@pytest.mark.parametrize("block", [4, 16])
def test_update_packed_blocks_equals_to_packed_blocks(sr_name, dtype, block):
    """Row-by-row re-packing equals a full ``to_packed_blocks`` of the
    mutated graph, array for array, over a chain of deltas that grows and
    shrinks the widest row, upserts weights and adds duplicate-weight
    edges; the parent table is never written."""
    sr = BY_NAME[sr_name]
    rng = np.random.default_rng(block)
    g = random_graph(70, 3.0, seed=4, directed=True)
    w = rng.integers(1, 9, g.num_edges).astype(dtype)
    tg = Graph.from_edges(np.asarray(g.src), np.asarray(g.dst), 70, w=w,
                          weight_dtype=dtype, device="cpu")
    pb = tg.to_packed_blocks(block, sr)
    for step in range(6):
        s, d, _ = tg._edges_np()
        hub = int(rng.integers(0, 70))
        adds = [(int(a), hub) for a in rng.choice(70, 12, replace=False) if a != hub]
        dels = list({(int(s[i]), int(d[i])) for i in rng.choice(len(s), 8, replace=False)})
        aw = rng.integers(1, 9, len(adds)).astype(dtype)
        delta = tg.make_delta(adds if step % 3 != 2 else None, dels, w=aw if step % 3 != 2 else None)
        before = {k: None if v is None else v.copy() for k, v in pb.host().items()}
        g1 = tg.apply_delta(delta)
        got = g1.update_packed_blocks(pb, sr, delta.touched_dst_blocks(block))
        want = g1.to_packed_blocks(block, sr)
        for f in ("src_ids", "nslots", "row_ptr", "entries", "w"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (step, f)
        assert got.dtype == want.dtype and got.block == want.block
        for k, v in pb.host().items():
            assert v is None or np.array_equal(v, before[k]), k
        tg, pb = g1, got


def test_update_packed_blocks_untouched_rows_and_refusals(small_directed):
    tg = port_graph(small_directed)
    pb = tg.to_packed_blocks(16, MIN_PLUS)
    assert tg.update_packed_blocks(pb, MIN_PLUS, []) is pb
    with pytest.raises(ValueError, match="vertex count"):
        port_graph(small_directed.padded(128)).update_packed_blocks(pb, MIN_PLUS, [0])
    with pytest.raises(ValueError, match="no weights"):
        tg.update_packed_blocks(tg.to_packed_blocks(16, MIN_RIGHT), MIN_PLUS, [0])


def test_backend_refresh_matches_a_fresh_plan(small_directed):
    """``refresh`` on every plan answers as a plan built on the mutated
    graph; the cuda plan's spliced tables equal fresh ones and the old
    plan keeps its own."""
    tg = port_graph(small_directed)
    rng = np.random.default_rng(5)
    delta = tg.make_delta([_non_edge(small_directed, rng) for _ in range(6)],
                          [(int(tg.src[i]), int(tg.dst[i])) for i in (2, 30)])
    g1 = tg.apply_delta(delta)
    x = torch.from_numpy(rng.integers(0, 30, (3, tg.n)).astype(np.int32))
    m = torch.from_numpy(rng.random((3, tg.n)) < 0.4)
    want = ref.propagate_coo(g1, MIN_RIGHT, x, m)
    for spec in ("coo", "coo_gated", "blocks_ref", "cuda"):
        be = ops.make_backend(spec, tg, block=16)
        old = be.propagate(MIN_RIGHT, x, m)
        new = be.refresh(g1, delta)
        assert new is not be and new.graph is g1
        assert torch.equal(new.propagate(MIN_RIGHT, x, m), want), spec
        assert torch.equal(be.propagate(MIN_RIGHT, x, m), old), spec
        if spec == "cuda":
            fresh = g1.to_packed_blocks(16, MIN_RIGHT)
            t = new.tables["min_right"]
            for f in ("src_ids", "nslots", "row_ptr", "entries"):
                assert torch.equal(getattr(t, f), getattr(fresh, f)), f
            assert torch.equal(new.refresh(g1, None).tables["min_right"].entries,
                               fresh.entries)


def test_shared_table_plans_refuse_refresh_and_carry(small_directed):
    tg = port_graph(small_directed)
    be = ops.make_backend("blocks_ref", tg, blocks=tg.to_blocks(16, MIN_RIGHT.add_id),
                          block=16)
    with pytest.raises(ValueError, match="shared single-table"):
        be.refresh(tg)
    with pytest.raises(NotImplementedError, match="shared single-table"):
        be.as_args()
    with pytest.raises(NotImplementedError, match="cannot be argument-carried"):
        ops.CallableBackend(lambda *a: a[1]).as_args()


def test_as_args_from_args_pad_and_answer(small_directed):
    """Carried copies over padded arrays answer as the exact plan; padding
    the packed entries leaves ``row_ptr`` and every real entry alone."""
    tg = port_graph(small_directed)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 30, (2, tg.n)).astype(np.int32))
    m = torch.from_numpy(rng.random((2, tg.n)) < 0.5)
    gcar = tg.with_capacity(tg.num_edges + 40)
    for spec in ("coo", "coo_gated", "blocks_ref", "cuda"):
        be = ops.make_backend(spec, tg, block=16)
        want = be.propagate(MIN_RIGHT, x, m)
        args = be.as_args(gcar, slot_cap=9, entry_cap=4096)
        run = be.from_args(args)
        assert torch.equal(run.propagate(MIN_RIGHT, x, m), want), spec
        if spec == "cuda":
            t = args["tables"]["min_right"]
            assert t.max_bpr == 9 and t.entries.numel() == 4096
            assert int(t.row_ptr[-1]) == be.tables["min_right"].entries.numel()
            assert run.strict
        if spec.startswith("coo"):
            assert args["graph"] is gcar


# ================================================== capacity padding
def test_coo_plan_never_scatters_capacity_padding():
    """The coo plan reads only the logical prefix of a capacity-padded
    graph: no padding edge is gathered or scattered (padding into one
    dummy segment serialises ``scatter_reduce`` on the card)."""
    tg = port_graph(_tail_graph())
    gc = tg.with_capacity(max_e=tg.num_edges + 40)
    src, dst, w = ref.coo_indices(gc)
    assert src.numel() == dst.numel() == w.numel() == tg.num_edges
    for a, b in zip((src, dst, w), ref.coo_indices(tg)):
        assert torch.equal(a, b)
    be = ops.make_backend("coo", gc)
    be.warm()
    assert all(a.numel() == tg.num_edges for a in be._idx)


# ================================================== capacity padding
def test_with_capacity_padding_semantics():
    jg = _tail_graph()
    tg = port_graph(jg)
    cap = tg.num_edges + 16
    gc, jgc = tg.with_capacity(max_e=cap), jg.with_capacity(max_e=cap)
    _same_graph(gc, jgc)
    assert gc.nnz == tg.num_edges and gc.content_hash() == tg.content_hash()
    # the JAX package's padded graph carries into the port as it is
    _same_graph(port_graph(jgc), jgc)
    assert port_graph(jgc).nnz == tg.num_edges
    gt = gc.trimmed()
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(gt, f), getattr(tg, f)), f
    x = torch.from_numpy(np.where(np.arange(tg.n) == 48, 0.0, INF).astype(np.float32))
    fl = Graph.from_edges(*tg._edges_np()[:2], tg.n_real,
                          w=tg._edges_np()[2].astype(np.float32), weight_dtype=np.float32,
                          device="cpu").with_capacity(cap)
    assert torch.equal(ref.propagate_coo(fl, MIN_PLUS, x),
                       ref.propagate_coo(fl.trimmed(), MIN_PLUS, x))
    xi = torch.from_numpy(np.where(np.arange(tg.n) < 50, 0, INF).astype(np.int32))
    mask = torch.ones(tg.n, dtype=torch.bool)
    for chunk in (7, 4096):
        assert torch.equal(ref.propagate_coo_gated(gc, MIN_RIGHT, xi, mask, chunk),
                           ref.propagate_coo(tg, MIN_RIGHT, xi))
    # in capacity: shapes held, content as the exact graph's
    g1c, jg1c = gc.apply_delta(adds=[(0, 59)]), jgc.apply_delta(adds=[(0, 59)])
    _same_graph(g1c, jg1c)
    assert g1c.edge_capacity == cap and g1c.content_hash() == tg.apply_delta(
        adds=[(0, 59)]).content_hash()
    # overflow grows the capacity as the JAX package does
    big = [(int(i % 48), int((i * 7 + 3) % 48)) for i in range(1, 48)]
    big = [(a, b) for a, b in big if a != b]
    _same_graph(g1c.apply_delta(adds=big), jg1c.apply_delta(adds=big))
    assert g1c.carrier().version == 0 and g1c.carrier().parent_hash is None
    assert g1c.carrier().content_hash() == g1c.content_hash()


# ================================================== Hub² incremental
def test_hub2_incremental_matches_jax_and_pinned_rebuild(small_undirected):
    jg = small_undirected
    tg = port_graph(jg)
    jidx = jhub2.build_hub_index(jg, 8)
    tidx = hub2.build_hub_index(tg, 8, device="cpu")
    rng = np.random.default_rng(5)
    a, b = _non_edge(jg, rng)
    es, ed = np.asarray(jg.src), np.asarray(jg.dst)
    s0, d0 = int(es[3]), int(ed[3])
    jd = jg.make_delta(adds=[(a, b), (b, a)], dels=[(s0, d0), (d0, s0)])
    td = carry.edge_delta_from_numpy(fields_np(jd))
    jg1, tg1 = jg.apply_delta(jd), tg.apply_delta(td)
    np.testing.assert_array_equal(hub2.affected_hubs(tidx, td),
                                  jhub2.affected_hubs(jidx, jd))
    jinc, _ = jhub2.maintain_hub_index(jg1, jidx, jd, threshold=1.0)
    full = hub2.build_hub_index(tg1, 8, hubs=tidx.hub_ids.numpy(), device="cpu")
    for backend in ("coo", "cuda", "blocks_ref"):
        inc, info = hub2.maintain_hub_index(tg1, tidx, td, threshold=1.0,
                                            backend=backend, block=16, chunk=3)
        assert info["mode"] == "incremental" and info["affected_hubs"] > 0
        for f in ("hub_ids", "is_hub", "hub_dist", "core"):
            np.testing.assert_array_equal(getattr(inc, f).numpy(), np.asarray(getattr(jinc, f)))
            assert torch.equal(getattr(inc, f), getattr(full, f)), f
    # the maintained index is new arrays: the old one is untouched
    np.testing.assert_array_equal(tidx.hub_dist.numpy(), np.asarray(jidx.hub_dist))
    reb, info_r = hub2.maintain_hub_index(tg1, tidx, td, threshold=0.0, device="cpu")
    jreb, _ = jhub2.maintain_hub_index(jg1, jidx, jd, threshold=0.0)
    assert info_r["mode"] == "rebuild" and info_r["affected_hubs"] == tidx.k
    np.testing.assert_array_equal(reb.hub_dist.numpy(), np.asarray(jreb.hub_dist))
    same, info_e = hub2.maintain_hub_index(tg1, tidx, tg1.make_delta())
    assert same is tidx and info_e["affected_hubs"] == 0


@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_hub2_strict_subset_delete_matches_jax(ba_graph, backend):
    """The delete ``chip_smoke.py`` 7b applies after its deltas: one
    undirected edge, chosen from the current hub labels, whose endpoints'
    labels differ by exactly one in some rows but not all, so
    ``affected_hubs`` names a strict, nonempty subset and the incremental
    path re-labels only those rows.  The port's index equals the JAX
    package's ``maintain_hub_index``, and a pinned rebuild; the rows it
    does not name are the old ones."""
    jg = ba_graph
    tg = port_graph(jg)
    k = 16
    jidx = jhub2.build_hub_index(jg, k)
    tidx = hub2.build_hub_index(tg, k, device="cpu")
    s, d, _ = tg._edges_np()
    hd = tidx.hub_dist.numpy().astype(np.int64)
    named = (np.abs(hd[:, s] - hd[:, d]) == 1).sum(0)
    pick = np.nonzero((s < d) & (named > 0) & (named < k))[0][0]
    u, v = int(s[pick]), int(d[pick])
    jd = jg.make_delta(dels=[(u, v), (v, u)])
    td = carry.edge_delta_from_numpy(fields_np(jd))
    rows = hub2.affected_hubs(tidx, td)
    assert 0 < len(rows) < k and len(rows) == named[pick]
    np.testing.assert_array_equal(rows, jhub2.affected_hubs(jidx, jd))
    jg1, tg1 = jg.apply_delta(jd), tg.apply_delta(td)
    jinc, jinfo = jhub2.maintain_hub_index(jg1, jidx, jd)
    inc, info = hub2.maintain_hub_index(tg1, tidx, td, backend=backend, block=16)
    assert info["mode"] == jinfo["mode"] == "incremental"
    assert info["affected_hubs"] == jinfo["affected_hubs"] == len(rows)
    full = hub2.build_hub_index(tg1, k, hubs=tidx.hub_ids.numpy(), device="cpu")
    for f in ("hub_ids", "is_hub", "hub_dist", "core"):
        np.testing.assert_array_equal(getattr(inc, f).numpy(), np.asarray(getattr(jinc, f)))
        assert torch.equal(getattr(inc, f), getattr(full, f)), f
    kept = np.setdiff1d(np.arange(k), rows)
    assert torch.equal(inc.hub_dist[kept], tidx.hub_dist[kept])
    assert torch.equal(inc.core[kept], tidx.core[kept])
    assert not (torch.equal(inc.hub_dist[rows], tidx.hub_dist[rows])
                and torch.equal(inc.core[rows], tidx.core[rows]))


def test_relabel_matches_the_engine_rows(small_undirected):
    """The batched device BFS gives every hub's row as the engine's
    HubLabelBFS build does (all rows re-labeled, any chunk)."""
    tg = port_graph(small_undirected)
    idx = hub2.build_hub_index(tg, 8, device="cpu")
    for chunk in (1, 5, 8):
        for spec in ("coo", "cuda"):
            dist, pre = hub2._relabel_hubs(ops.make_backend(spec, tg, block=16), idx.is_hub,
                                           idx.hub_ids, np.arange(8), chunk)
            assert torch.equal(dist, idx.hub_dist)
            assert torch.equal((dist < INF) & (~pre | idx.is_hub[None, :]), idx.core)


@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_hub2_engine_maintains_index_through_apply_delta(small_undirected, backend):
    jg = small_undirected
    tg = port_graph(jg)
    idx = hub2.build_hub_index(tg, 8, device="cpu")
    upd = hub2.hub_index_updater(threshold=0.5, backend=backend, block=16)
    eng = hub2.make_hub2_engine(tg, idx, capacity=2, index_fn=upd, backend=backend,
                                block=16, device="cpu")
    jeng = jhub2.make_hub2_engine(jg, jhub2.build_hub_index(jg, 8), capacity=2,
                                  index_fn=jhub2.hub_index_updater(threshold=0.5))
    q = np.asarray([1, 50], np.int32)
    rng = np.random.default_rng(9)
    for _ in range(3):
        a, b = _non_edge(jg, rng)
        info = eng.apply_delta(adds=[(a, b), (b, a)])
        jinfo = jeng.apply_delta(adds=[(a, b), (b, a)])
        assert info["index"]["mode"] == "incremental"
        assert info["index"]["affected_hubs"] == jinfo["index"]["affected_hubs"]
        assert info["content_hash"] == jinfo["content_hash"]
        jg = jeng.graph
        for f in ("hub_dist", "core"):
            np.testing.assert_array_equal(getattr(eng.index, f).numpy(),
                                          np.asarray(getattr(jeng.index, f)))
        _check_answer(eng.query(q), {k: np.asarray(v) for k, v in jeng.query(
            jnp.asarray(q)).items()})
    bare = hub2.make_hub2_engine(tg, idx, capacity=2, device="cpu")
    with pytest.raises(ValueError, match="index maintainer"):
        bare.apply_delta(adds=[(0, 1)])


# =============================================== serving-layer invariants
@pytest.mark.parametrize("spr", SPR)
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_versioned_parity_pin(spr, backend):
    """Scripted mutations with queries in flight: every answer equals the
    JAX engine's at that query's pinned version."""
    jg0 = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg0), capacity=3, steps_per_round=spr,
                               backend=backend, block=16, device="cpu")
    q_tail, q_mid = [48, 59], [48, 57]
    id0 = eng.submit(np.asarray(q_tail, np.int32))
    id1 = eng.submit(np.asarray(q_mid, np.int32))
    eng.run_round()
    assert int(eng.runtime.live.sum()) == 2
    info1 = eng.apply_delta(adds=[(48, 58)])
    assert info1["version"] == 1 and 0 in info1["editions"]
    id2 = eng.submit(np.asarray(q_tail, np.int32))
    eng.run_round()
    info2 = eng.apply_delta(adds=[(0, 59)], dels=[(48, 58)])
    assert info2["version"] == 2
    id3 = eng.submit(np.asarray(q_tail, np.int32))
    res = eng.run_until_drained()
    jg1 = jg0.apply_delta(adds=[(48, 58)])
    jg2 = jg1.apply_delta(adds=[(0, 59)], dels=[(48, 58)])
    assert info2["content_hash"] == jg2.content_hash()
    for qid, q, gg in [(id0, q_tail, jg0), (id1, q_mid, jg0), (id2, q_tail, jg1),
                       (id3, q_tail, jg2)]:
        _check_answer(res[qid], _jax_answer(gg, q))
    assert int(res[id0]["dist"]) != int(res[id2]["dist"])
    assert eng.apply_delta()["editions"] == [3]


def test_suspended_query_resumes_on_pinned_version():
    jg = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=2, device="cpu")
    qid0 = eng.submit(np.asarray([48, 59], np.int32))
    eng.run_round()
    victim = int(np.flatnonzero(eng.runtime.live)[0])
    eng.runtime.suspend([victim])
    eng.apply_delta(adds=[(48, 59)])
    qid1 = eng.submit(np.asarray([48, 59], np.int32))
    res = eng.run_until_drained()
    assert int(res[qid0]["dist"]) == 11 and int(res[qid1]["dist"]) == 1
    _check_answer(res[qid0], _jax_answer(jg, [48, 59]))
    _check_answer(res[qid1], _jax_answer(jg.apply_delta(adds=[(48, 59)]), [48, 59]))


def test_jax_version1_suspend_payload_resumes_in_the_port():
    """A payload the JAX engine suspended at graph version 1 resumes in the
    port's engine on its version 1 edition, after the port moved on to
    version 2, and answers as the JAX engine does."""
    jg = _tail_graph()
    jeng = jppsp.make_bfs_engine(jg, capacity=2)
    jeng.apply_delta(adds=[(48, 58)])
    jqid = jeng.submit(jnp.asarray([48, 59], jnp.int32))
    jeng.run_round()
    slot = int(np.flatnonzero(np.asarray(jeng.runtime.live))[0])
    steps = int(np.asarray(jeng._slots["step"])[slot])
    (payload,) = jeng.slot_suspend([slot])
    assert payload["v"] == 1
    jeng.runtime.restore_pending(99, np.asarray([48, 59], np.int32), payload=payload,
                                 steps_done=steps, seq=99)
    want = {k: np.asarray(v) for k, v in jeng.run_until_drained()[99].items()}

    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=2, device="cpu")
    eng.apply_delta(adds=[(48, 58)])
    eng.apply_delta(adds=[(0, 59)], prune=False)
    eng.runtime.restore_pending(7, np.asarray([48, 59], np.int32), payload=payload,
                                steps_done=steps, seq=0)
    assert eng._resume_refs == {1: 1}
    got = eng.run_until_drained()[7]
    _check_answer(got, want)
    assert int(got["dist"]) == 2 and eng._resume_refs == {}
    with pytest.raises(RuntimeError, match="no such edition"):
        eng.slot_register_resume({"v": 5, "state": payload["state"]})
    del jqid


def test_cache_never_serves_cross_version():
    jg = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=2, result_cache=8, device="cpu")
    st = eng.runtime.stats
    q = np.asarray([48, 59], np.int32)
    r0 = eng.query(q)
    eng.submit(q)
    assert st.cache_hits == 1
    info = eng.apply_delta(adds=[(48, 59)])
    assert info["cache_invalidated"] >= 1
    assert st.cache_invalidations == info["cache_invalidated"]
    qid2 = eng.submit(q)
    assert st.cache_hits == 1
    r2 = eng.run_until_drained()[qid2]
    assert int(r2["dist"]) == 1
    info2 = eng.apply_delta(dels=[(48, 59)])
    assert info2["content_hash"] == jg.content_hash()
    qid3 = eng.submit(q)
    assert st.cache_hits == 1
    _check_answer(eng.run_until_drained()[qid3], r0)


def test_cache_entry_from_pinned_retirement_survives_revert():
    jg = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=2, result_cache=8, device="cpu")
    st = eng.runtime.stats
    q = np.asarray([48, 59], np.int32)
    qid0 = eng.submit(q)
    eng.run_round()
    eng.apply_delta(adds=[(49, 48)])
    r0 = eng.run_until_drained()[qid0]
    eng.apply_delta(dels=[(49, 48)])
    assert eng.graph.content_hash() == jg.content_hash()
    qid1 = eng.submit(q)
    assert st.cache_hits == 1
    _check_answer(eng.runtime.results[qid1], r0)


def test_apply_delta_argument_errors(small_directed):
    eng = ppsp.make_bfs_engine(port_graph(_tail_graph()), capacity=2, device="cpu")
    d = eng.graph.make_delta(adds=[(0, 59)])
    with pytest.raises(ValueError, match="not both"):
        eng.apply_delta(d, dels=[(0, 1)])
    beng = ppsp.make_bibfs_engine(port_graph(small_directed), capacity=2, device="cpu")
    with pytest.raises(ValueError, match="unknown views"):
        beng.apply_delta(adds=[(0, 1)], aux_deltas={"nope": None})
    over = ppsp.make_bfs_engine(port_graph(small_directed), capacity=2, device="cpu",
                                propagate_override={"default": lambda sr, x, f=None: x})
    with pytest.raises(ValueError, match="propagate_override"):
        over.apply_delta(adds=[(0, 1)])


@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_bibfs_aux_view_follows_delta(small_directed, backend):
    jg = small_directed
    eng = ppsp.make_bibfs_engine(port_graph(jg), capacity=2, backend=backend, block=16,
                                 device="cpu")
    q = [1, 40]
    eng.query(np.asarray(q, np.int32))
    a, b = _non_edge(jg, np.random.default_rng(13))
    es, ed = np.asarray(jg.src), np.asarray(jg.dst)
    delta = dict(adds=[(a, b)], dels=[(int(es[7]), int(ed[7]))])
    eng.apply_delta(**delta)
    jg1 = jg.apply_delta(**delta)
    _same_graph(eng.graph, jg1)
    rev = eng.aux_graphs["rev"]
    jrev = jg.reverse().apply_delta(jg.make_delta(**delta).reversed())
    _same_graph(rev, jrev)
    _check_answer(eng.query(np.asarray(q, np.int32)),
                  _jax_answer(jg1, q, factory=jppsp.make_bibfs_engine))
    if backend == "cuda":
        for view, g_ in (("default", eng.graph), ("rev", rev)):
            t = eng.export_tables()[view]["min_right"]
            fresh = g_.to_packed_blocks(16, MIN_RIGHT)
            assert torch.equal(t.entries, fresh.entries) and torch.equal(t.row_ptr, fresh.row_ptr)


# ===================================================== journal + recovery
def test_mutation_journal_roundtrip(tmp_path):
    p = str(tmp_path / "j.wal")
    j = QueryJournal(p)
    adds = np.asarray([[0, 1], [2, 3]], np.int32)
    j.mutation(version=1, parent_hash="aa", content_hash="bb", adds=adds,
               add_w=np.asarray([1.5, 2.5], np.float32), dels=np.zeros((0, 2), np.int32))
    j.close()
    (rec,) = QueryJournal.replay(p)
    assert rec["type"] == "mutation" and rec["version"] == 1
    assert rec["parent_hash"] == "aa" and rec["content_hash"] == "bb"
    np.testing.assert_array_equal(np.asarray(rec["adds"]).reshape(-1, 2), adds)
    np.testing.assert_array_equal(np.asarray(rec["add_w"]), [1.5, 2.5])
    assert np.asarray(rec["dels"]).size == 0


def test_apply_delta_record_chain_checks():
    eng = ppsp.make_bfs_engine(port_graph(_tail_graph()), capacity=2, device="cpu")
    base = dict(type="mutation", version=1, adds=np.zeros((0, 2), np.int32),
                add_w=np.zeros((0,)), dels=np.zeros((0, 2), np.int32))
    with pytest.raises(RuntimeError, match="chain mismatch"):
        eng.apply_delta_record(dict(base, parent_hash="0" * 64, content_hash="f" * 64))
    with pytest.raises(RuntimeError, match="diverged"):
        eng.apply_delta_record(dict(base, parent_hash=eng.graph.content_hash(),
                                    content_hash="f" * 64))


def _fingerprint(eng):
    res = {q: {k: np.asarray(v).tolist() for k, v in r.items()}
           for q, r in eng.runtime.results.items()}
    return res, dict(eng.runtime.status), dict(eng.runtime.steps)


SUBS = [(np.asarray([48, 59], np.int32), {}), (np.asarray([48, 57], np.int32), {}),
        (np.asarray([5, 20], np.int32), {})]


def _on_round(eng, rounds):
    # guard on version: a replayed mutation must not be applied twice
    if rounds >= 2 and eng.graph.version == 0:
        eng.apply_delta(adds=[(48, 58)])


@pytest.mark.parametrize("crash", [0, 1, 3, 5])
def test_recovery_replays_mutations_as_jax(tmp_path, crash):
    """Crash recovery with a mid-stream mutation equals the uninterrupted
    run and the JAX package's uninterrupted run."""
    jg = _tail_graph()
    jbase, _ = jsupervise.run_with_recovery(
        lambda: jppsp.make_bfs_engine(jg, capacity=3), str(tmp_path / "j.wal"), SUBS,
        snapshot_every=2, on_round=_on_round)
    want = _fingerprint(jbase)
    tg = port_graph(jg)
    inj = FailureInjector(fail_at_steps={crash}) if crash else None
    eng, info = run_with_recovery(
        lambda: ppsp.make_bfs_engine(tg, capacity=3, device="cpu"),
        str(tmp_path / "t.wal"), SUBS, snapshot_every=2, injector=inj, on_round=_on_round)
    assert _fingerprint(eng) == want
    assert eng.graph.version == 1 and eng.graph.content_hash() == jbase.graph.content_hash()
    if crash >= 3:
        assert info["mutations_replayed"] == 1


def test_port_recovers_a_jax_journal_with_mutations(tmp_path):
    """A journal the JAX engine wrote (submits, snapshots pinning version
    0, a mutation record, retirements) before it crashed is replayed by
    the port: the mutation through the hash chain, the snapshots on the
    version 0 edition; the result equals the JAX package's own recovery."""
    jg = _tail_graph()
    jpath = str(tmp_path / "jax.wal")
    with pytest.raises(Exception):
        jsupervise.run_with_recovery(
            lambda: jppsp.make_bfs_engine(jg, capacity=3), jpath, SUBS, snapshot_every=2,
            on_round=_on_round, injector=JFailureInjector(fail_at_steps={4}), max_restarts=0)
    recs = QueryJournal.replay(jpath)
    assert [r["type"] for r in recs].count("mutation") == 1
    assert any(r["type"] == "snapshot" and r["payload"]["v"] == 0 for r in recs)
    # the JAX package's own recovery of a copy of the same journal
    jcopy = str(tmp_path / "jax_copy.wal")
    with open(jpath, "rb") as a, open(jcopy, "wb") as b:
        b.write(a.read())
    jeng, jinfo = jsupervise.run_with_recovery(
        lambda: jppsp.make_bfs_engine(jg, capacity=3), jcopy, SUBS, snapshot_every=2,
        on_round=_on_round)
    eng, info = run_with_recovery(
        lambda: ppsp.make_bfs_engine(port_graph(jg), capacity=3, device="cpu"), jpath, SUBS,
        snapshot_every=2, on_round=_on_round)
    assert info["mutations_replayed"] == jinfo["mutations_replayed"] == 1
    assert info["resumed_from_snapshot"] == jinfo["resumed_from_snapshot"] >= 1
    assert _fingerprint(eng) == _fingerprint(jeng)
    assert eng.graph.content_hash() == jeng.graph.content_hash()


def test_recover_refuses_mutations_without_replay(tmp_path):
    p = str(tmp_path / "j.wal")
    j = QueryJournal(p)
    j.mutation(version=1, parent_hash="p", content_hash="c", adds=np.zeros((0, 2), np.int32),
               add_w=np.zeros(0, np.int32), dels=np.zeros((0, 2), np.int32))
    j.close()

    class NoReplay:
        pass

    class Runtime:
        program = NoReplay()

    with pytest.raises(RuntimeError, match="cannot replay"):
        recover(Runtime(), p)


# ================================== shape-stable editions (arg_carried)
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_arg_carried_zero_shape_changes(backend):
    """Ten in-capacity mutations: no edition changes shape, every answer
    equals the JAX engine's at that version; an overflow changes shape
    once."""
    jg = _tail_graph()
    rng = np.random.default_rng(3)
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=3, arg_carried=True,
                               edge_capacity=jg.num_edges + 20, backend=backend, block=16,
                               device="cpu")
    q = np.asarray([48, 59], np.int32)
    _check_answer(eng.query(q), _jax_answer(jg, [48, 59]))
    base = dict(eng.shape_counts)
    assert base == {0: 1} and eng.stats.shape_changes == 0
    for _ in range(10):
        a, b = (int(v) for v in rng.integers(0, 48, 2))
        if a == b:
            b = (a + 1) % 48
        eng.apply_delta(adds=[(a, b)])
        jg = jg.apply_delta(adds=[(a, b)])
        _check_answer(eng.query(q), _jax_answer(jg, [48, 59]))
    assert dict(eng.shape_counts) == base and eng.stats.shape_changes == 0
    big = [(i, 49 + (i % 10)) for i in range(40)]
    eng.apply_delta(adds=big)
    jg = jg.apply_delta(adds=big)
    _check_answer(eng.query(q), _jax_answer(jg, [48, 59]))
    assert eng.stats.shape_changes == 1 and len(eng.shape_counts) == 2
    run = eng._editions[eng._current_version].run_graph
    assert run.nnz == jg.num_edges and run.edge_capacity > jg.num_edges + 20


def test_constant_editions_count_their_shape_changes():
    eng = ppsp.make_bfs_engine(port_graph(_tail_graph()), capacity=2, arg_carried=False,
                               device="cpu")
    eng.apply_delta(adds=[(0, 59)])
    eng.apply_delta(adds=[(1, 59)], dels=[(0, 59)])  # same edge count: same shapes
    assert eng.stats.shape_changes == 1 and sorted(eng.shape_counts) == [0, 1]


def test_arg_carried_mode_resolution():
    g = port_graph(_tail_graph())
    mk = lambda **kw: ppsp.make_bfs_engine(g, capacity=2, device="cpu", **kw)
    # 'auto' is off in the port whatever the threshold: eager torch
    # compiles nothing, so padding would only cost scatter work
    assert not mk()._arg_carried
    assert not mk(arg_carried_threshold=1)._arg_carried
    assert not mk(arg_carried=False)._arg_carried
    assert mk(arg_carried=True)._arg_carried
    with pytest.raises(ValueError, match="carriable"):
        mk(arg_carried=True, propagate_override={"default": lambda sr, x, f=None: x})
    # a view built by hand without the CSR view cannot be padded: True
    # refuses
    from repro_torch.apps import keyword

    tokens = np.zeros((g.n, 2), np.int32)
    kw_auto = keyword.make_keyword_engine(g, tokens, capacity=2, device="cpu",
                                          arg_carried_threshold=1)
    assert not kw_auto._arg_carried
    with pytest.raises(ValueError, match="CSR view"):
        keyword.make_keyword_engine(g, tokens, capacity=2, device="cpu", arg_carried=True)
    # the legacy round is not carriable, as in the JAX engine
    assert not mk(legacy=True)._arg_carried
    with pytest.raises(ValueError, match="carriable"):
        mk(legacy=True, arg_carried=True)


@pytest.mark.parametrize("arg_carried", [False, True])
def test_background_warmup_moves_first_use_work(arg_carried):
    """warmup=True: apply_delta leaves the new edition's first-use work to
    a thread while the old edition serves its in-flight query; after the
    thread, the new version's first round does none of it."""
    jg = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=3, warmup=True, backend="cuda",
                               block=16, arg_carried=arg_carried, device="cpu")
    qin = eng.submit(np.asarray([48, 59], np.int32))
    eng.run_round()
    eng.apply_delta(adds=[(48, 58)])
    assert eng.stats.warmups == 1
    assert int(eng.run_until_drained()[qin]["dist"]) == 11
    assert eng.wait_warmup(timeout=300)
    ed = eng._editions[eng._current_version]
    assert ed.run is not None
    for be in ed.run.values():
        for t in be.tables.values():
            assert t.entries.device == eng.device
    qid = eng.submit(np.asarray([48, 59], np.int32))
    res = eng.run_until_drained()
    assert int(res[qid]["dist"]) == 2
    _check_answer(res[qid], _jax_answer(jg.apply_delta(adds=[(48, 58)]), [48, 59]))


def test_suspend_across_two_mutations_refcount():
    jg = _tail_graph()
    eng = ppsp.make_bfs_engine(port_graph(jg), capacity=2, device="cpu")
    qid0 = eng.submit(np.asarray([48, 59], np.int32))
    qid1 = eng.submit(np.asarray([48, 57], np.int32))
    eng.run_round()
    victims = np.flatnonzero(eng.runtime.live).tolist()
    assert len(victims) == 2
    eng.runtime.suspend(victims)
    assert eng._resume_refs == {0: 2}
    assert eng.apply_delta(adds=[(48, 59)])["editions"] == [0, 1]
    assert eng.apply_delta(adds=[(48, 58)])["editions"] == [0, 2]
    qid2 = eng.submit(np.asarray([48, 59], np.int32))
    res = eng.run_until_drained()
    assert eng._resume_refs == {}
    assert [int(res[q]["dist"]) for q in (qid0, qid1, qid2)] == [11, 9, 1]
    _check_answer(res[qid0], _jax_answer(jg, [48, 59]))
    assert eng.apply_delta()["editions"] == [3]


def test_result_cache_bucketed_invalidation():
    for C, mod in ((ResultCache, None), (jruntime.ResultCache, jruntime)):
        miss = _MISS if mod is None else mod._MISS
        c = C(8)
        c.put("aa:1", 1)
        c.put("aa:2", 2)
        c.put("bb:3", 3)
        assert c.invalidate_except("bb") == 2
        assert len(c) == 1 and c.get("bb:3") == 3 and c.get("aa:1") is miss
        c2 = C(2)
        c2.put("v1:a", 1)
        c2.put("v1:b", 2)
        c2.put("v2:c", 3)
        assert len(c2) == 2 and c2.invalidate_except("v2") == 1
        c2.put("v2:d", 4)
        assert c2.invalidate(lambda k: k.endswith("d")) == 1
        assert c2.invalidate_except("zz") == 1 and len(c2) == 0
    eng = ppsp.make_bfs_engine(port_graph(_tail_graph()), capacity=2, result_cache=8,
                               device="cpu")
    eng.query(np.asarray([48, 59], np.int32))
    assert eng.stats.cache_invalidation_ms == 0.0
    info = eng.apply_delta(adds=[(48, 59)])
    assert info["cache_invalidated"] == 1 and eng.stats.cache_invalidation_ms > 0.0


def test_store_keeps_the_lineage(tmp_path):
    """A graph saved at version 2 boots with its version and parent hash,
    and journal replay chains on it."""
    from repro_torch.core.store import Store, load_engine_store, save_engine_store

    tg = port_graph(_tail_graph()).apply_delta(adds=[(0, 59)]).apply_delta(adds=[(1, 59)])
    store = Store(str(tmp_path / "s"))
    meta = save_engine_store(store, tg)["graph"]
    assert meta["graph_version"] == 2 and meta["parent_hash"] == tg.parent_hash
    got = load_engine_store(store, device="cpu")["graph"]
    assert (got.version, got.parent_hash) == (2, tg.parent_hash)
    _same_graph(got, _tail_graph().apply_delta(adds=[(0, 59)]).apply_delta(adds=[(1, 59)]))
    eng = ppsp.make_bfs_engine(got, capacity=2, device="cpu")
    nxt = got.apply_delta(adds=[(2, 59)])
    eng.apply_delta_record(dict(parent_hash=got.content_hash(), content_hash=nxt.content_hash(),
                                adds=[[2, 59]], add_w=[1], dels=np.zeros((0, 2), np.int32)))
    assert eng.graph.version == 3
