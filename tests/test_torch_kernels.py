"""Kernel-level parity across packages: the port's COO propagation, tile
loop and CUDA kernel wrapper (its plain version on these CPU tensors, over
the packed layout) against the JAX package's COO reference and its Pallas
kernel run in interpret mode, on the same seeded inputs.  Integers match
bit for bit; floats to rtol = atol = 1e-4, for finite x (the domain where
dropping the add-identity entries of a tile is exact)."""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.apps import ppsp as jppsp
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph
from repro.core.semiring import BY_NAME as J_BY_NAME
from repro.core.semiring import INF
from repro.kernels import frontier as jfrontier
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.apps import ppsp
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import PackedBlocks, pack_blocks, pad_packed_slots
from repro_torch.core.semiring import BY_NAME
from repro_torch.kernels import frontier, ops, ref

from _torch_common import assert_same, assert_same_results, port_blocks, port_graph, rand_x

SEMIRINGS = ["min_plus", "min_right", "max_plus", "max_right", "sum_times"]


def _graph(sr_name, n, seed, rng):
    g = random_graph(n, 3.0, seed=seed)
    if sr_name == "sum_times":
        g = JGraph.from_edges(np.asarray(g.src), np.asarray(g.dst), g.n_real,
                              w=rng.standard_normal(g.num_edges),
                              weight_dtype=np.float32)
    return g


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_coo_matches_jax(sr_name, masked):
    rng = np.random.default_rng(7)
    jg = _graph(sr_name, 40, 5, rng)
    x = rand_x(rng, sr_name, jg.n, 3)
    mask = rng.random(x.shape) < 0.4 if masked else None
    want = jref.propagate_coo(jg, J_BY_NAME[sr_name], jnp.asarray(x),
                              None if mask is None else jnp.asarray(mask))
    got = ref.propagate_coo(port_graph(jg), BY_NAME[sr_name], torch.from_numpy(x),
                            None if mask is None else torch.from_numpy(mask))
    assert_same(got.numpy(), want, x.dtype == np.float32)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("n,block", [(40, 8), (65, 16), (128, 16)])
@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("gated", ["gated", "live", "dense", "dead"])
def test_propagate_blocks_matches_pallas(sr_name, n, block, q, gated):
    """Gated: per-tile activity plus an in-tile per-lane mask; live: the
    same mask with the per-source-block live table in place of the
    per-tile bitmap (and equal to the bitmap form); dense: every tile
    visited, no mask; dead: an all-dead bitmap.  The packed plain version
    against the Pallas kernel in interpret mode and against the port's
    dense tile loop, on the same tiles."""
    rng = np.random.default_rng(n * 17 + q)
    jg = _graph(sr_name, n, n + q, rng)
    jsr, sr = J_BY_NAME[sr_name], BY_NAME[sr_name]
    x = rand_x(rng, sr_name, jg.n, q)
    jbs = jg.to_blocks(block, jsr.add_id, dtype=np.asarray(jg.w).dtype)
    bs = port_blocks(jbs)
    pb = port_graph(jg).to_packed_blocks(block, sr)
    mask = jmask = act = jact = None
    if gated in ("gated", "live"):
        mask = rng.random(x.shape) < 0.3
        jmask = jnp.asarray(mask)
        jact = jops.block_activity(jbs, jmask)
        act = ops.block_activity(pb, torch.from_numpy(mask))
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
        mask = torch.from_numpy(mask)
    elif gated == "dead":
        act = torch.zeros((pb.num_dst_blocks, pb.max_bpr), dtype=torch.bool)
        jact = jnp.zeros(act.shape, jnp.int32)
    want = jfrontier.propagate_blocks(jbs, jsr, jnp.asarray(x), jmask, jact,
                                      interpret=True)
    got = frontier.propagate_blocks(pb, sr, torch.from_numpy(x), mask, act)
    if gated == "live":
        live = frontier.block_live(mask, pb.num_dst_blocks, block)
        by_live = frontier.propagate_blocks(pb, sr, torch.from_numpy(x), mask, live=live)
        assert torch.equal(by_live, got)
        got = by_live
    assert_same(got.numpy(), want, x.dtype == np.float32)
    tiles = ref.propagate_blocks_ref(bs, sr, torch.from_numpy(x), mask, act)
    assert_same(got.numpy(), tiles.numpy(), x.dtype == np.float32)
    if gated == "dead":
        assert (got == sr.identity(got.dtype)).all()


LIVE_CASES = [("min_plus", np.int32), ("min_right", np.int32), ("max_right", np.int32),
              ("max_plus", np.int32), ("sum_times", np.int32), ("min_plus", np.float32),
              ("max_plus", np.float32), ("sum_times", np.float32)]


def _live_case(sr_name, dtype, seed):
    """A random graph whose V (70) is no multiple of B = 16, weights and
    lanes of ``dtype`` in the domain where dropping a tile's add-identity
    entries is exact, and a mask lighting about a third of the lanes."""
    rng = np.random.default_rng(seed)
    g0 = random_graph(70, 3.0, seed=seed)
    e = g0.num_edges
    w = (rng.integers(1, 9, e) if dtype == np.int32 else rng.random(e) * 8 + 1).astype(dtype)
    jg = JGraph.from_edges(np.asarray(g0.src), np.asarray(g0.dst), g0.n_real, w=w,
                           weight_dtype=dtype)
    q = 5
    if dtype == np.int32 and sr_name != "sum_times":
        x = rand_x(rng, sr_name, jg.n, q)
    elif sr_name == "sum_times":
        x = (rng.integers(-4, 5, (q, jg.n)) if dtype == np.int32
             else rng.standard_normal((q, jg.n))).astype(dtype)
    else:
        x = (rng.random((q, jg.n)) * 20).astype(dtype)
        x[rng.random(x.shape) < 0.5] = J_BY_NAME[sr_name].add_id
    return jg, x, rng.random(x.shape) < 0.3


@pytest.mark.parametrize("sr_name,dtype", LIVE_CASES,
                         ids=[f"{s}-{np.dtype(d).name}" for s, d in LIVE_CASES])
@pytest.mark.parametrize("padded", [False, True], ids=["table", "padded"])
def test_live_gate_matches_pallas(sr_name, dtype, padded):
    """The per-source-block live table in both dtypes, with a tail block
    (V = 70, B = 16), on a packed table as built and as ``pad_packed_slots``
    pads it for argument-carried editions: the plain version against the
    Pallas kernel in interpret mode (gated by its per-tile bitmap) and
    against the port's per-slot bitmap form."""
    jg, x, mask = _live_case(sr_name, dtype, seed=21 + len(sr_name))
    assert jg.n % 16
    jsr, sr = J_BY_NAME[sr_name], BY_NAME[sr_name]
    jbs = jg.to_blocks(16, jsr.add_id, dtype=dtype)
    pb = port_graph(jg).to_packed_blocks(16, sr)
    if padded:
        pb = pad_packed_slots(pb, pb.max_bpr + 3, pb.entries.numel() + 17)
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    live = frontier.block_live(tmask, pb.num_dst_blocks, 16)
    want = jfrontier.propagate_blocks(jbs, jsr, jnp.asarray(x), jnp.asarray(mask),
                                      jops.block_activity(jbs, jnp.asarray(mask)),
                                      interpret=True)
    got = frontier.propagate_blocks(pb, sr, tx, tmask, live=live)
    assert_same(got.numpy(), want, dtype == np.float32)
    act = ops.block_activity(pb, tmask)
    assert torch.equal(got, frontier.propagate_blocks(pb, sr, tx, tmask, act))


@pytest.mark.parametrize("q", [1, 5, 11])
def test_block_live_reduces_each_source_block(q):
    """``block_live`` is the mask reduced over the lanes and each source
    block's columns, the tail block cut at V; looked up through src_ids
    and cut to the real slots it is ``block_activity``'s bitmap."""
    jg = random_graph(70, 3.0, seed=q)
    pb = port_graph(jg).to_packed_blocks(16, BY_NAME["min_right"])
    nb = pb.num_dst_blocks
    mask = torch.zeros((q, jg.n), dtype=torch.bool)
    mask[q - 1, jg.n - 1] = True                 # the tail block only
    mask[0, 17] = True
    want = [bool(mask[:, b * 16:(b + 1) * 16].any()) for b in range(nb)]
    live = frontier.block_live(mask, nb, 16)
    assert live.dtype == torch.bool and live.tolist() == want
    assert want[-1] and want[1] and not want[0]
    valid = ops.block_activity(pb, None)
    assert torch.equal(valid & live[pb.src_ids.long()], ops.block_activity(pb, mask))
    assert not frontier.block_live(mask[:0], nb, 16).any()
    with pytest.raises(ValueError, match="V="):
        frontier.block_live(mask, 1, 16)
    with pytest.raises(ValueError, match="not both"):
        frontier.propagate_blocks(pb, BY_NAME["min_right"], torch.zeros((q, jg.n), dtype=torch.int32),
                                  mask, ops.block_activity(pb, mask), live)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_all_dead_live_table_leaves_add_id(sr_name):
    """An all-false live table leaves every output at add_id, whatever the
    mask lets through; an all-true one gates nothing."""
    rng = np.random.default_rng(12)
    jg = _graph(sr_name, 65, 12, rng)
    sr = BY_NAME[sr_name]
    x = torch.from_numpy(rand_x(rng, sr_name, jg.n, 3))
    pb = port_graph(jg).to_packed_blocks(16, sr)
    mask = torch.ones(x.shape, dtype=torch.bool)
    dead = torch.zeros(pb.num_dst_blocks, dtype=torch.bool)
    got = frontier.propagate_blocks(pb, sr, x, mask, live=dead)
    assert (got == sr.identity(got.dtype)).all()
    full = frontier.propagate_blocks(pb, sr, x, mask, live=~dead)
    assert torch.equal(full, frontier.propagate_blocks(pb, sr, x, mask))
    assert not (full == sr.identity(full.dtype)).all()


class _Shapes(TorchDispatchMode):
    """Records the shape and dtype of every tensor each aten op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((str(func), tuple(t.shape), t.dtype))
        return out


def test_cuda_plan_gates_by_the_live_table(monkeypatch):
    """The ``cuda`` plan's gated propagate (its plain version on these CPU
    tensors) passes the per-source-block live table on every call with a
    frontier: no ``block_activity``, no (nb, max_bpr) tensor, no int64
    copy of ``src_ids``.  Without a frontier, or with ``gate=False``, it
    passes no table.  Answers equal the JAX masked COO reference."""
    def refuse(*args, **kwargs):
        raise AssertionError("the cuda plan built the per-slot bitmap")

    rng = np.random.default_rng(13)
    jg = _graph("min_plus", 150, 13, rng)
    sr = BY_NAME["min_plus"]
    x = rand_x(rng, "min_plus", jg.n, 4)
    mask = rng.random(x.shape) < 0.15
    tg = port_graph(jg)
    be = ops.make_backend("cuda", tg, block=16)
    pb = be.table_for(sr)
    grid = (pb.num_dst_blocks, pb.max_bpr)
    monkeypatch.setattr(ops, "block_activity", refuse)
    gating = frontier.propagate_blocks.gating
    before = gating.copy()
    with _Shapes() as rec:
        got = be.propagate(sr, torch.from_numpy(x), torch.from_numpy(mask))
    assert gating - before == collections.Counter(live=1)
    assert rec.seen and not [s for s in rec.seen if s[1] == grid]
    assert not [s for s in rec.seen
                if s[2] == torch.int64 and int(np.prod(s[1])) == grid[0] * grid[1]]
    want = jref.propagate_coo(jg, J_BY_NAME["min_plus"], jnp.asarray(x), jnp.asarray(mask))
    assert_same(got.numpy(), want, False)
    before = gating.copy()
    be.propagate(sr, torch.from_numpy(x))
    ops.make_backend("cuda", tg, block=16, gate=False).propagate(
        sr, torch.from_numpy(x), torch.from_numpy(mask))
    assert gating - before == collections.Counter(none=2)


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
@pytest.mark.parametrize("gate", [True, False], ids=["gated", "dense"])
def test_tile_backends_match_jax_coo(sr_name, backend, gate):
    """The functional ``propagate`` through the port's tile plans, gated
    and dense, equals the JAX masked COO reference."""
    rng = np.random.default_rng(3)
    jg = _graph(sr_name, 70, 3, rng)
    x = rand_x(rng, sr_name, jg.n, 4)
    mask = rng.random(x.shape) < 0.15
    want = jref.propagate_coo(jg, J_BY_NAME[sr_name], jnp.asarray(x), jnp.asarray(mask))
    tg = port_graph(jg)
    bs = tg.to_blocks(16, BY_NAME[sr_name].add_id)
    got = ops.propagate(tg, BY_NAME[sr_name], torch.from_numpy(x),
                        torch.from_numpy(mask), blocks=bs, backend=backend, gate=gate)
    assert_same(got.numpy(), want, x.dtype == np.float32)


def test_block_activity_matches_jax():
    """Padding slots are dead; only tiles sourced from blocks holding a
    frontier vertex in some lane are live — in both packages."""
    jg = random_graph(64, 3.0, seed=11)
    jbs = jg.to_blocks(16, J_BY_NAME["min_right"].add_id)
    bs = port_blocks(jbs)
    np.testing.assert_array_equal(ops.block_activity(bs, None).numpy(),
                                  np.asarray(jops.block_activity(jbs, None)))
    mask = np.zeros((2, jg.n), bool)
    mask[0, 2 * 16: 3 * 16] = True
    mask[1, 5] = True
    got = ops.block_activity(bs, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.block_activity(jbs, jnp.asarray(mask))))
    assert (got <= ops.block_activity(bs, None).numpy()).all()


def test_float_min_plus_matches_pallas():
    rng = np.random.default_rng(4)
    g0 = random_graph(50, 3.0, seed=9)
    w = rng.random(g0.num_edges).astype(np.float32) + 0.1
    jg = JGraph.from_edges(np.asarray(g0.src), np.asarray(g0.dst), g0.n_real,
                           w=w, weight_dtype=np.float32)
    x = np.full((2, jg.n), float(INF), np.float32)
    x[0, 3] = 0.0
    x[1, 7] = 0.0
    jbs = jg.to_blocks(16, float(INF), dtype=np.float32)
    want = jfrontier.propagate_blocks(jbs, J_BY_NAME["min_plus"], jnp.asarray(x),
                                      interpret=True)
    got = frontier.propagate_blocks(pack_blocks(port_blocks(jbs), BY_NAME["min_plus"]),
                                    BY_NAME["min_plus"], torch.from_numpy(x))
    assert_same(got.numpy(), want, True)


def test_make_backend_refusals():
    tg = port_graph(random_graph(20, 2.0, seed=1))
    with pytest.raises(ValueError, match="'cuda'"):
        ops.make_backend("pallas", tg)
    with pytest.raises(ValueError, match=r"needs mesh=.*Graph\.padded"):
        ops.make_backend("sharded", tg)  # ported: a mesh is needed, as in JAX
    assert ops.make_backend("coo_gated", tg).gather_edges == 512
    with pytest.raises(ValueError, match="blocks="):
        ops.propagate(tg, BY_NAME["min_right"], torch.zeros((1, tg.n), dtype=torch.int32),
                      backend="cuda")


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    """CPU tensors run the plain version and count no launch; a tensor on
    any device other than the CPU or a GPU is refused, never run plain."""
    tg = port_graph(random_graph(40, 3.0, seed=2))
    sr = BY_NAME["min_right"]
    pb = tg.to_packed_blocks(8, sr)
    x = torch.full((2, tg.n), INF, dtype=torch.int32)
    x[:, 0] = 0
    before = frontier.launches()
    got = frontier.propagate_blocks(pb, sr, x)
    want = frontier.propagate_blocks_plain(pb, sr, x)
    assert torch.equal(got, want)
    assert frontier.launches() == before
    with pytest.raises(ValueError, match="device"):
        frontier.propagate_blocks(pb, sr, x.to("meta"))
    with pytest.raises(TypeError, match="pack_blocks"):
        frontier.propagate_blocks(tg.to_blocks(8, sr.add_id), sr, x)
    with pytest.raises(ValueError, match="weights"):
        frontier.propagate_blocks(pb, BY_NAME["min_plus"], x)


def test_cuda_plan_never_builds_a_dense_table(monkeypatch):
    """The ``cuda`` plan (its plain version on these CPU tensors) builds
    packed tables from the edge list, never ``Graph.to_blocks``, and
    answers BiBFS as the JAX package's ``coo`` plan does."""
    def refuse(*args, **kwargs):
        raise AssertionError("the cuda plan built a dense tile table")

    monkeypatch.setattr(tgraph.Graph, "to_blocks", refuse)
    jg = random_graph(120, 2.5, seed=6)
    pairs = np.random.default_rng(6).integers(0, jg.n_real, (10, 2)).astype(np.int32)
    results = []
    for eng in (jppsp.make_bibfs_engine(jg, capacity=4),
                ppsp.make_bibfs_engine(port_graph(jg), capacity=4, backend="cuda",
                                       block=16, device="cpu")):
        for p in pairs:
            eng.submit(p)
        results.append(eng.run_until_drained())
    assert_same_results(results[1], results[0])
    tables = [t for view in eng.export_tables().values() for t in view.values()]
    assert tables and all(isinstance(t, PackedBlocks) for t in tables)
    assert eng.table_bytes() == sum(t.nbytes for t in tables)


# ------------------------------------------------------------ gated COO
def _gated_case(sr_name, seed=5, n=70, q=4, frontier_p=0.15):
    """The JAX tests' masked case: a graph, x and a sparse frontier."""
    rng = np.random.default_rng(seed)
    jg = _graph(sr_name, n, seed, rng)
    x = rand_x(rng, sr_name, jg.n, q)
    mask = rng.random((q, jg.n)) < frontier_p
    return jg, x, mask


@pytest.mark.parametrize("sr_name", SEMIRINGS)
@pytest.mark.parametrize("chunk", [7, 64, 4096])
def test_coo_gather_matches_jax(sr_name, chunk):
    """The gated COO gather (chunked active-edge reduction) equals the JAX
    package's gated gather and plain COO for any chunk: smaller than the
    active set (many chunks) and larger than E."""
    jg, x, mask = _gated_case(sr_name)
    jsr, sr = J_BY_NAME[sr_name], BY_NAME[sr_name]
    want = jops.propagate(jg, jsr, jnp.asarray(x), jnp.asarray(mask), gather_edges=chunk)
    tg, tx, tm = port_graph(jg), torch.from_numpy(x), torch.from_numpy(mask)
    got = ops.propagate(tg, sr, tx, tm, gather_edges=chunk)
    floating = x.dtype == np.float32
    assert_same(got.numpy(), want, floating)
    assert_same(got.numpy(), jref.propagate_coo(jg, jsr, jnp.asarray(x), jnp.asarray(mask)),
                floating)
    # the same on the capacity-padded graph (inert padding)
    padded = ops.propagate(tg.with_capacity(tg.num_edges + 33), sr, tx, tm,
                           gather_edges=chunk)
    assert_same(padded.numpy(), got.numpy(), floating)


def test_coo_gather_empty_and_full_frontier():
    jg, x, _ = _gated_case("min_right", seed=9)
    tg = port_graph(jg)
    for mask in (np.zeros(x.shape, bool), np.ones(x.shape, bool)):
        want = jref.propagate_coo(jg, J_BY_NAME["min_right"], jnp.asarray(x),
                                  jnp.asarray(mask))
        got = ops.propagate(tg, BY_NAME["min_right"], torch.from_numpy(x),
                            torch.from_numpy(mask), gather_edges=32)
        assert_same(got.numpy(), want, False)


def test_coo_gather_syncs_once_and_refuses_without_csr(monkeypatch):
    """One compaction (one nonzero) per gated propagate; a graph without
    the CSR view is refused."""
    jg, x, mask = _gated_case("min_right")
    tg = port_graph(jg)
    calls = []
    orig = torch.Tensor.nonzero
    monkeypatch.setattr(torch.Tensor, "nonzero",
                        lambda self, *a, **k: calls.append(1) or orig(self, *a, **k))
    ref.propagate_coo_gated(tg, BY_NAME["min_right"], torch.from_numpy(x),
                            torch.from_numpy(mask), 7)
    assert len(calls) == 1
    import dataclasses
    bare = dataclasses.replace(tg, csr_row=None)
    with pytest.raises(ValueError, match="CSR"):
        ref.propagate_coo_gated(bare, BY_NAME["min_right"], torch.from_numpy(x),
                                torch.from_numpy(mask), 7)
