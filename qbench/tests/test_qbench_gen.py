"""The generators: Graph500 Kronecker graphs, the frozen terrain and arrival
copies held against the port's, and the query streams."""
import numpy as np
import pytest
import torch

from qbench.gen import arrivals, kronecker, terrain
from qbench.gen.queries import PairStream


def test_kronecker_arcs_are_kernel_1s_undirected_graph():
    src, dst, n = kronecker.kronecker_graph(10, 16, 0.57, 0.19, 0.19, 1, 2**31 + 5, "cpu")
    assert n == 1024 and src.dtype == dst.dtype == torch.int32
    s, d = src.long(), dst.long()
    assert int(src.numel()) <= 2 * 16 * 1024
    assert bool((s != d).all()), "self-loops"
    assert bool((s >= 0).all() and (s < n).all() and (d >= 0).all() and (d < n).all())
    key = s * n + d
    assert torch.unique(key).numel() == key.numel(), "duplicate arcs"
    assert torch.equal(torch.sort(key).values, torch.sort(d * n + s).values), "one-way arcs"


def test_kronecker_is_seeded_and_a_seed_only_relabels():
    a = kronecker.kronecker_graph(9, 16, 0.57, 0.19, 0.19, 1, 7, "cpu")
    b = kronecker.kronecker_graph(9, 16, 0.57, 0.19, 0.19, 1, 7, "cpu")
    c = kronecker.kronecker_graph(9, 16, 0.57, 0.19, 0.19, 1, 8, "cpu")
    other = kronecker.kronecker_graph(9, 16, 0.57, 0.19, 0.19, 2, 7, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    deg = lambda g: torch.sort(torch.bincount(g[0].long(), minlength=g[2])).values
    assert a[0].numel() == c[0].numel() and torch.equal(deg(a), deg(c))
    assert not torch.equal(deg(a), deg(other))


def test_kronecker_skew_follows_the_quadrant_probabilities():
    """A = 0.57 puts most edges among low labels before the permutation:
    the most connected 1 % of vertices hold far more than 1 % of the arcs."""
    src, _, n = kronecker.kronecker_graph(12, 16, 0.57, 0.19, 0.19, 1, 3, "cpu")
    deg = torch.sort(torch.bincount(src.long(), minlength=n), descending=True).values
    assert deg[: n // 100].sum() > 0.1 * deg.sum()


@pytest.mark.parametrize("rows,cols,eps,seed", [(6, 7, 2, 0), (9, 9, 1, 3), (5, 8, 3, 2**31 + 11)])
def test_frozen_terrain_is_byte_equal_to_the_ports(rows, cols, eps, seed):
    from repro_torch.core.graph import Graph, grid_terrain

    coords, src, dst, w, n = terrain.terrain_arrays(rows, cols, eps, seed)
    g_ref, coords_ref = grid_terrain(rows, cols, eps_subdiv=eps, seed=seed, device="cpu")
    g = Graph.from_edges(src, dst, n, w=w, weight_dtype=np.float32, device="cpu")
    assert coords.tobytes() == coords_ref.tobytes()
    assert g.n == g_ref.n
    for f in ("src", "dst", "w", "csr_row", "csr_src", "csr_dst", "csr_w"):
        assert getattr(g, f).numpy().tobytes() == getattr(g_ref, f).numpy().tobytes(), f


@pytest.mark.parametrize("process", ["poisson", "constant", "mmpp"])
def test_frozen_arrivals_equal_the_ports(process):
    from repro_torch.launch import loadgen

    for seed in (0, 2**31 + 3):
        mine = arrivals.make_arrivals(process, 250.0, 500, seed=seed)
        theirs = loadgen.make_arrivals(process, 250.0, 500, seed=seed)
        assert mine.tobytes() == theirs.tobytes()


def test_pair_streams_are_seeded_and_apart():
    pool = np.arange(10, 1000, dtype=np.int32)
    take = lambda s: np.stack([s.next() for _ in range(5000)])
    a, b = take(PairStream(pool, 5, "window")), take(PairStream(pool, 5, "window"))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, take(PairStream(pool, 5, "warmup")))
    assert not np.array_equal(a, take(PairStream(pool, 6, "window")))
    assert np.isin(a, pool).all()


def test_an_unknown_pair_draw_is_refused():
    with pytest.raises(ValueError, match="stratified"):
        PairStream(np.arange(8, dtype=np.int32), 1, "window", {"draw": "stratified"})
