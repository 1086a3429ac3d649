"""Kernel-level parity across packages: the port's COO propagation, tile
loop and CUDA kernel wrapper (its plain version on these CPU tensors, over
the packed layout) against the JAX package's COO reference and its Pallas
kernel run in interpret mode, on the same seeded inputs.  Integers match
bit for bit; floats to rtol = atol = 1e-4, for finite x (the domain where
dropping the add-identity entries of a tile is exact)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

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
from repro_torch.core.graph import PackedBlocks, pack_blocks
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
@pytest.mark.parametrize("gated", ["gated", "dense", "dead"])
def test_propagate_blocks_matches_pallas(sr_name, n, block, q, gated):
    """Gated: per-tile activity plus an in-tile per-lane mask; dense: every
    tile visited, no mask; dead: an all-dead bitmap.  The packed plain
    version against the Pallas kernel in interpret mode and against the
    port's dense tile loop, on the same tiles."""
    rng = np.random.default_rng(n * 17 + q)
    jg = _graph(sr_name, n, n + q, rng)
    jsr, sr = J_BY_NAME[sr_name], BY_NAME[sr_name]
    x = rand_x(rng, sr_name, jg.n, q)
    jbs = jg.to_blocks(block, jsr.add_id, dtype=np.asarray(jg.w).dtype)
    bs = port_blocks(jbs)
    pb = port_graph(jg).to_packed_blocks(block, sr)
    mask = jmask = act = jact = None
    if gated == "gated":
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
    assert_same(got.numpy(), want, x.dtype == np.float32)
    tiles = ref.propagate_blocks_ref(bs, sr, torch.from_numpy(x), mask, act)
    assert_same(got.numpy(), tiles.numpy(), x.dtype == np.float32)
    if gated == "dead":
        assert (got == sr.identity(got.dtype)).all()


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.make_backend("coo_gated", tg)
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
    before = frontier.propagate_blocks.launches
    got = frontier.propagate_blocks(pb, sr, x)
    want = frontier.propagate_blocks_plain(pb, sr, x)
    assert torch.equal(got, want)
    assert frontier.propagate_blocks.launches == before
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
