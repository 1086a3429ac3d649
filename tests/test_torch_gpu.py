"""The hand-written CUDA kernel on the card: built from the repo's source,
held against its plain PyTorch version, and reached by the engine's
``cuda`` plan.  Run on a machine with a GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.apps import ppsp
from repro_torch.core.graph import Graph, barabasi_albert, random_graph
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
    """Packed inputs, gated with a mask, dense, and all-dead; Q=11 spans
    two Q-tiles.  Exact, except float sum_times to 1e-4 (atomic sum
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
    dead = torch.zeros((pb.num_dst_blocks, pb.max_bpr), dtype=torch.bool, device=cuda)
    for m, act in ((mask, ops.block_activity(pb, mask)), (None, None), (mask, dead)):
        got = frontier.propagate_blocks(pb, sr, x, m, act)
        want = frontier.propagate_blocks_plain(pb, sr, x, m, act)
        add_id = sr.identity(dtype)
        assert torch.equal(got == add_id, want == add_id)
        if dtype == torch.float32 and sr_name == "sum_times":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(got, want)
        if act is dead:
            assert (got == add_id).all()


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
        before = frontier.propagate_blocks.launches
        results[backend] = eng.run_until_drained()
        launched = frontier.propagate_blocks.launches - before
        if backend == "cuda":
            assert launched >= eng.stats.rounds > 0
        else:
            assert launched == 0
    for qid, r in results["coo"].items():
        assert int(results["cuda"][qid]["dist"]) == int(r["dist"])
