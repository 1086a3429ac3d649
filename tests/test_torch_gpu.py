"""The hand-written CUDA kernel on the card: built from the repo's source,
held against its plain PyTorch version, and reached by the engine's
``cuda`` plan.  Run on a machine with a GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.apps import keyword, ppsp, reach, terrain, xmlkw
from repro_torch.core.graph import (Graph, barabasi_albert, grid_terrain, random_dag,
                                    random_graph, random_tree)
from repro_torch.core.semiring import BY_NAME
from repro_torch.kernels import frontier, ops

pytestmark = pytest.mark.gpu

CASES = [("min_plus", torch.int32), ("min_right", torch.int32),
         ("max_right", torch.int32), ("max_plus", torch.int32),
         ("sum_times", torch.int32), ("min_plus", torch.float32),
         ("max_plus", torch.float32), ("sum_times", torch.float32)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frontier.load()
    return torch.device("cuda")


def _graph(dtype, add_id, kind, rng, cuda):
    """V=700 (no multiple of B), or V=4096 with hubs whose rows span
    several work items.  ``dups``: duplicate edges the packer must
    combine, a lone edge whose weight is add_id and a duplicate pair that
    combines to add_id, which it must drop."""
    dups = kind == "dups"
    if kind == "hubs":
        g = barabasi_albert(4096, 3, seed=int(rng.integers(1000)), device="cpu")
    else:
        g = random_graph(700, 3.0, seed=int(rng.integers(1000)), device="cpu")
    s, d, _ = g._edges_np()
    if dups:
        extra = rng.integers(0, len(s), 200)
        s, d = np.concatenate([s, s[extra], s[:1]]), np.concatenate([d, d[extra], d[:1]])
    if dtype == torch.float32:  # |t| > 32: add_id + t passes add_id
        w = (64 * rng.standard_normal(len(s))).astype(np.float32)
    else:
        w = rng.integers(1, 9, len(s)).astype(np.int32)
    if dups:
        w[len(s) // 2] = add_id
        w[0], w[-1] = (add_id, add_id) if add_id else (w[-1], -w[-1])
    return Graph.from_edges(s, d, g.n_real, w=w, weight_dtype=w.dtype, device=cuda)


@pytest.mark.parametrize("sr_name,dtype", CASES, ids=[f"{s}-{str(d)[6:]}" for s, d in CASES])
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("q", [1, 5, 11])
@pytest.mark.parametrize("kind", ["simple", "dups", "hubs"])
def test_kernel_matches_plain(cuda, sr_name, dtype, block, q, kind):
    """Packed inputs, gated with a mask by the per-slot bitmap and by the
    per-source-block live table, dense, and all-dead in both forms; Q=11
    spans two Q-tiles.  Exact, except float sum_times to 1e-4 (atomic sum
    order); the outputs left at add_id are the same in every case."""
    rng = np.random.default_rng(block * 31 + q)
    sr = BY_NAME[sr_name]
    g = _graph(dtype, sr.identity(dtype), kind, rng, cuda)
    if dtype == torch.float32:
        x = torch.from_numpy(rng.standard_normal((q, g.n)).astype(np.float32)).to(cuda)
    else:
        xn = rng.integers(0, 20, (q, g.n)).astype(np.int32)
        xn[rng.random((q, g.n)) < 0.5] = sr.add_id
        x = torch.from_numpy(xn).to(cuda)
    pb = g.to_packed_blocks(block, sr)
    mask = torch.from_numpy(rng.random((q, g.n)) < 0.2).to(cuda)
    nb = pb.num_dst_blocks
    dead = torch.zeros((nb, pb.max_bpr), dtype=torch.bool, device=cuda)
    dead_live = torch.zeros(nb, dtype=torch.bool, device=cuda)
    for m, gate in ((mask, dict(active=ops.block_activity(pb, mask))),
                    (mask, dict(live=frontier.block_live(mask, nb, block))),
                    (None, {}), (mask, dict(active=dead)), (mask, dict(live=dead_live))):
        got = frontier.propagate_blocks(pb, sr, x, m, **gate)
        want = frontier.propagate_blocks_plain(pb, sr, x, m, **gate)
        add_id = sr.identity(dtype)
        assert torch.equal(got == add_id, want == add_id)
        if dtype == torch.float32 and sr_name == "sum_times":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(got, want)
        if any(t is dead or t is dead_live for t in gate.values()):
            assert (got == add_id).all()


@pytest.mark.parametrize("q", [0, 1, 5, 11])
@pytest.mark.parametrize("n,block", [(700, 16), (700, 128), (4096, 128), (300, 1024)])
def test_block_live_kernel_matches_the_reduction(cuda, q, n, block):
    """The liveness kernel equals the mask reduced over the lanes and over
    each source block's columns, the tail block (V no multiple of B) cut
    at V; with no lane every block is dead."""
    rng = np.random.default_rng(q * 7 + n + block)
    nb = -(-n // block)
    mask = torch.from_numpy(rng.random((q, n)) < 0.002).to(cuda)
    if q:
        mask[q - 1, n - 1] = True  # the tail block's last column
    got = frontier.block_live(mask, nb, block)
    pad = torch.zeros((q, nb * block), dtype=torch.bool, device=cuda)
    pad[:, :n] = mask
    want = pad.reshape(q, nb, block).any(-1).any(0)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(got, frontier.block_live_plain(mask, nb, block))
    assert bool(got[-1]) == (q > 0)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    g = random_graph(64, 2.0, seed=1, device=cuda)
    sr = BY_NAME["min_right"]
    pb = g.to_packed_blocks(16, sr)
    x = torch.zeros((2, g.n), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        frontier.propagate_blocks(pb, sr, x)
    with pytest.raises(TypeError):
        frontier.propagate_blocks(pb, sr, x.float())
    with pytest.raises(TypeError, match="pack_blocks"):
        frontier.propagate_blocks(g.to_blocks(16, sr.add_id), sr, x.int())


def test_engine_cuda_plan_launches_the_kernel(cuda):
    g = random_graph(300, 3.0, seed=2, device=cuda)
    pairs = np.random.default_rng(0).integers(0, 300, (12, 2)).astype(np.int32)
    results = {}
    for backend in ("coo", "cuda"):
        eng = ppsp.make_bibfs_engine(g, capacity=4, backend=backend, block=16)
        for p in pairs:
            eng.submit(p)
        before = frontier.launches()
        results[backend] = eng.run_until_drained()
        launched = frontier.launches() - before
        if backend == "cuda":
            assert launched >= eng.stats.rounds > 0
        else:
            assert launched == 0
    for qid, r in results["coo"].items():
        assert int(results["cuda"][qid]["dist"]) == int(r["dist"])


def _app_engine(app, backend, cuda):
    """One small engine per query class of the second slice, and its
    queries (seeded)."""
    rng = np.random.default_rng(3)
    kw = dict(capacity=4, backend=backend, block=16, device=cuda)
    if app == "terrain":
        g, coords = grid_terrain(20, 20, eps_subdiv=2, seed=0, device=cuda)
        qs = rng.integers(0, g.n_real, (8, 2)).astype(np.int32)
        return terrain.make_terrain_engine(g, coords, **kw), qs
    if app == "reach":
        dag = random_dag(600, 2.5, seed=0, device=cuda)
        qs = rng.integers(0, dag.n_real, (24, 2)).astype(np.int32)
        return reach.make_reach_engine(dag, reach.build_reach_index(dag), **kw), qs
    qs = np.full((12, keyword.MAXK), -1, np.int32)
    qs[:, :3] = rng.integers(0, 12, (12, 3))
    qs[::2, 2] = -1
    if app == "keyword":
        g = barabasi_albert(800, 3, seed=1, device=cuda)
        tokens = keyword.make_vertex_text(g.n, 200, 4, seed=2)
        return keyword.make_keyword_engine(g, tokens, **kw), qs
    tree, parent = random_tree(900, max_fanout=8, seed=0, device=cuda)
    idx = xmlkw.build_xml_index(parent, keyword.make_vertex_text(900, 200, 4, seed=1),
                                tree.n, device=cuda)
    return xmlkw.make_xml_engine(getattr(xmlkw, app), tree, idx, **kw), qs


@pytest.mark.parametrize("app", ["terrain", "keyword", "reach", "SLCANaive",
                                 "SLCALevelAligned", "MaxMatch"])
def test_app_cuda_plan_matches_coo(cuda, app):
    """Each query class through the kernel: answers identical to coo's
    (float32 terrain distances too: min is exact), at least one launch a
    round."""
    results = {}
    for backend in ("coo", "cuda"):
        eng, qs = _app_engine(app, backend, cuda)
        for q in qs:
            eng.submit(q)
        before = frontier.launches()
        results[backend] = eng.run_until_drained()
        launched = frontier.launches() - before
        assert (launched >= eng.stats.rounds > 0) if backend == "cuda" else launched == 0
    assert sorted(results["coo"]) == sorted(results["cuda"])
    for qid, r in results["coo"].items():
        for k, v in r.items():
            np.testing.assert_array_equal(results["cuda"][qid][k], v, err_msg=f"{qid} {k}")


@pytest.mark.parametrize("sr_name,dtype", [("min_right", torch.int32),
                                           ("min_plus", torch.float32)])
def test_splice_on_the_card_matches_a_fresh_table(cuda, sr_name, dtype):
    """A packed table spliced after each delta equals to_packed_blocks of
    the mutated graph, and the kernel on the spliced (and slot/entry
    padded) table equals its plain version and coo."""
    from repro_torch.core.graph import pad_packed_slots

    sr = BY_NAME[sr_name]
    rng = np.random.default_rng(11)
    g = _graph(dtype, sr.add_id, "hubs", rng, cuda)
    pb = g.to_packed_blocks(128, sr)
    for _ in range(3):
        s, d, w = g._edges_np()
        adds = [(int(a), int(b)) for a, b in rng.integers(0, g.n_real, (64, 2)) if a != b]
        dels = list({(int(s[i]), int(d[i])) for i in rng.choice(len(s), 64, replace=False)})
        delta = g.make_delta(adds, dels, w=np.ones(len(adds), w.dtype))
        g = g.apply_delta(delta)
        pb = g.update_packed_blocks(pb, sr, delta.touched_dst_blocks(128))
        fresh = g.to_packed_blocks(128, sr)
        for f in ("src_ids", "nslots", "row_ptr", "entries", "w"):
            a, b = getattr(pb, f), getattr(fresh, f)
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f
        x = torch.from_numpy(rng.integers(0, 20, (8, g.n)).astype(np.int32)).to(cuda, dtype)
        m = torch.from_numpy(rng.random((8, g.n)) < 0.3).to(cuda)
        padded = pad_packed_slots(pb, pb.max_bpr + 2, pb.entries.numel() + 999)
        live = frontier.block_live(m, pb.num_dst_blocks, 128)
        for t in (pb, padded):
            for gate in (dict(active=ops.block_activity(t, m)), dict(live=live)):
                got = frontier.propagate_blocks(t, sr, x, m, **gate)
                assert torch.equal(got, frontier.propagate_blocks_plain(t, sr, x, m, **gate))
                assert torch.equal(got, ops.CooBackend(g).propagate(sr, x, m))


def test_gated_coo_on_the_card(cuda):
    """The gated COO gather on the card equals plain COO and the kernel,
    for chunks smaller and larger than the active edge set; the kernel's
    plan gates by one block_live launch."""
    g = barabasi_albert(4096, 3, seed=5, device=cuda)
    sr = BY_NAME["min_right"]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 20, (8, g.n)).astype(np.int32)).to(cuda)
    m = torch.from_numpy(rng.random((8, g.n)) < 0.05).to(cuda)
    want = ops.CooBackend(g).propagate(sr, x, m)
    for chunk in (64, 1 << 20):
        assert torch.equal(ops.CooBackend(g, gather_edges=chunk).propagate(sr, x, m), want)
    kern = ops.make_backend("cuda", g, block=128)
    before = frontier.propagate_blocks.gating.copy()
    live_before = frontier.block_live.shapes.copy()
    assert torch.equal(kern.propagate(sr, x, m), want)
    assert frontier.propagate_blocks.gating - before == {"live": 1}
    assert frontier.block_live.shapes - live_before == {8: 1}
