"""The hand-written CUDA kernel on the card: built from the repo's source,
held against its plain PyTorch version, and reached by the engine's
``cuda`` plan.  Run on a machine with a GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test here skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.apps import ppsp
from repro_torch.core.graph import Graph, random_graph
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


@pytest.mark.parametrize("sr_name,dtype", CASES, ids=[f"{s}-{str(d)[6:]}" for s, d in CASES])
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("q", [1, 5, 11])
def test_kernel_matches_plain(cuda, sr_name, dtype, block, q):
    """Gated with a mask, dense, and all-dead; V=700 is no multiple of B,
    and Q=11 spans two Q-tiles."""
    rng = np.random.default_rng(block * 31 + q)
    sr = BY_NAME[sr_name]
    g = random_graph(700, 3.0, seed=q, device=cuda)
    if dtype == torch.float32:
        s, d, _ = g._edges_np()
        w = rng.random(len(s)).astype(np.float32) + 0.1
        g = Graph.from_edges(s, d, 700, w=w, weight_dtype=np.float32, device=cuda)
        x = torch.from_numpy(rng.standard_normal((q, g.n)).astype(np.float32)).to(cuda)
    else:
        xn = rng.integers(0, 20, (q, g.n)).astype(np.int32)
        xn[rng.random((q, g.n)) < 0.5] = sr.add_id
        x = torch.from_numpy(xn).to(cuda)
    bs = g.to_blocks(block, sr.add_id)
    mask = torch.from_numpy(rng.random((q, g.n)) < 0.2).to(cuda)
    dead = torch.zeros((bs.num_dst_blocks, bs.max_bpr), dtype=torch.bool, device=cuda)
    for m, act in ((mask, ops.block_activity(bs, mask)), (None, None), (mask, dead)):
        got = frontier.propagate_blocks(bs, sr, x, m, act)
        want = frontier.propagate_blocks_plain(bs, sr, x, m, act)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(got, want)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    g = random_graph(64, 2.0, seed=1, device=cuda)
    bs = g.to_blocks(16, BY_NAME["min_right"].add_id)
    x = torch.zeros((2, g.n), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        frontier.propagate_blocks(bs, BY_NAME["min_right"], x)
    with pytest.raises(TypeError):
        frontier.propagate_blocks(bs, BY_NAME["min_right"], x.float())


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
