"""The references against brute force on small graphs, and their controls
against the references."""
import collections
import heapq

import numpy as np
import pytest
import torch

from qbench.apps.terrain import max_rel_gap
from qbench.ref.hops import first_meet_distances, hop_distances
from qbench.ref.sssp import arc_weights, sssp_distances


def random_arcs(n, m, seed, symmetric):
    rng = np.random.default_rng(seed)
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    if symmetric:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    return torch.as_tensor(s, dtype=torch.int32), torch.as_tensor(d, dtype=torch.int32)


def bfs(n, src, dst, s, t):
    adj = collections.defaultdict(list)
    for a, b in zip(src.tolist(), dst.tolist()):
        adj[a].append(b)
    dist = {s: 0}
    q = collections.deque([s])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist.get(t, -1)


def dijkstra(n, src, dst, w, s, t):
    adj = collections.defaultdict(list)
    for a, b, c in zip(src.tolist(), dst.tolist(), w.tolist()):
        adj[a].append((b, c))
    best = {s: 0.0}
    heap = [(0.0, s)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > best[u]:
            continue
        for v, c in adj[u]:
            if d + c < best.get(v, np.inf):
                best[v] = d + c
                heapq.heappush(heap, (d + c, v))
    return best.get(t, np.inf)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hop_distances_equal_bfs(seed, symmetric):
    n = 120
    src, dst = random_arcs(n, 150, seed, symmetric)
    rng = np.random.default_rng(seed + 10)
    s, t = rng.integers(0, n, 70), rng.integers(0, n, 70)
    s[0] = t[0]
    got = hop_distances(src, dst, n, s, t, lanes=16).numpy()
    want = [bfs(n, src, dst, int(a), int(b)) for a, b in zip(s, t)]
    assert got.tolist() == want
    assert (got == -1).any() and (got > 2).any()


def test_the_first_meet_control_misses_odd_distances():
    """It reads one hop long only where d(s, t) is odd and a vertex met at
    the same level from both sides has the lowest id."""
    n = 60
    src, dst = random_arcs(n, 90, 5, True)
    rng = np.random.default_rng(3)
    s, t = rng.integers(0, n, 200), rng.integers(0, n, 200)
    ref = hop_distances(src, dst, n, s, t).numpy()
    ctl = first_meet_distances(src, dst, n, s, t).numpy()
    assert ((ctl == ref) | (ctl == ref + 1)).all()
    assert (ctl[ref % 2 == 0] == ref[ref % 2 == 0]).all()
    assert (ctl != ref).any()


def test_sssp_equals_dijkstra_and_the_bfloat16_control_does_not():
    n = 150
    src, dst = random_arcs(n, 300, 4, True)
    rng = np.random.default_rng(9)
    coords = torch.as_tensor(rng.random((n, 3)) * [900.0, 900.0, 30.0], dtype=torch.float32)
    w = arc_weights(coords, src, dst, torch.float64)
    s, t = rng.integers(0, n, 40), rng.integers(0, n, 40)
    got = sssp_distances(src, dst, w, n, s, t, lanes=8).numpy()
    want = np.asarray([dijkstra(n, src, dst, w, int(a), int(b)) for a, b in zip(s, t)])
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = ~np.isinf(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
    ctl = sssp_distances(src, dst, arc_weights(coords, src, dst, torch.bfloat16), n, s, t)
    assert max_rel_gap(ctl.double().numpy(), got) > 1e-3


def test_max_rel_gap_reads_unreachable_and_zero():
    inf = np.inf
    assert max_rel_gap(np.array([inf, 0.0, 2.0]), np.array([inf, 0.0, 2.0])) == 0.0
    assert max_rel_gap(np.array([inf]), np.array([3.0])) == inf
    assert max_rel_gap(np.array([0.5]), np.array([0.0])) == 0.5
    assert max_rel_gap(np.array([101.0]), np.array([100.0])) == pytest.approx(0.01)
