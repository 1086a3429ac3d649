"""Kernel-level parity across packages: the port's COO propagation, tile
loop and CUDA kernel wrapper (its plain version on these CPU tensors)
against the JAX package's COO reference and its Pallas kernel run in
interpret mode, on the same seeded inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph
from repro.core.semiring import BY_NAME as J_BY_NAME
from repro.core.semiring import INF
from repro.kernels import frontier as jfrontier
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.semiring import BY_NAME
from repro_torch.kernels import frontier, ops, ref

from _torch_common import assert_same, port_blocks, port_graph, rand_x

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
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "dense"])
def test_propagate_blocks_matches_pallas(sr_name, n, block, q, gated):
    """Gated: per-tile activity plus an in-tile per-lane mask; dense: every
    tile visited, no mask.  Against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n * 17 + q)
    jg = _graph(sr_name, n, n + q, rng)
    jsr, sr = J_BY_NAME[sr_name], BY_NAME[sr_name]
    x = rand_x(rng, sr_name, jg.n, q)
    jbs = jg.to_blocks(block, jsr.add_id, dtype=np.asarray(jg.w).dtype)
    bs = port_blocks(jbs)
    if gated:
        mask = rng.random(x.shape) < 0.3
        jact = jops.block_activity(jbs, jnp.asarray(mask))
        act = ops.block_activity(bs, torch.from_numpy(mask))
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
        want = jfrontier.propagate_blocks(jbs, jsr, jnp.asarray(x), jnp.asarray(mask),
                                          jact, interpret=True)
        got = frontier.propagate_blocks(bs, sr, torch.from_numpy(x),
                                        torch.from_numpy(mask), act)
    else:
        want = jfrontier.propagate_blocks(jbs, jsr, jnp.asarray(x), interpret=True)
        got = frontier.propagate_blocks(bs, sr, torch.from_numpy(x))
    assert_same(got.numpy(), want, x.dtype == np.float32)


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
    got = frontier.propagate_blocks(port_blocks(jbs), BY_NAME["min_plus"],
                                    torch.from_numpy(x))
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
    bs = tg.to_blocks(8, BY_NAME["min_right"].add_id)
    x = torch.full((2, tg.n), INF, dtype=torch.int32)
    x[:, 0] = 0
    before = frontier.propagate_blocks.launches
    got = frontier.propagate_blocks(bs, BY_NAME["min_right"], x)
    want = frontier.propagate_blocks_plain(bs, BY_NAME["min_right"], x)
    assert torch.equal(got, want)
    assert frontier.propagate_blocks.launches == before
    with pytest.raises(ValueError, match="device"):
        frontier.propagate_blocks(bs, BY_NAME["min_right"], x.to("meta"))
