"""Graph500 Kronecker graphs, generated on the device from a seed.

Follows the Graph500 reference generator (``kronecker_generator.m``):
``edgefactor * 2**scale`` edges, each placed bit by bit in one of four
quadrants with probabilities A, B, C and D = 1 - A - B - C, then the vertex
labels permuted and the edge list shuffled.  Kernel 1's undirected graph is
then formed as the spec allows: both arcs of every edge, self-loops and
duplicate arcs dropped.

The quadrant draws come from ``structure_seed`` and the permutation and the
shuffle from the run's ``seed``: every seed gets an isomorphic graph, the
same work under other labels, so a run's numbers do not move with the
graph the seed would otherwise draw.
"""
from __future__ import annotations

import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float, c: float,
                    structure: torch.Generator, labels: torch.Generator,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,) int64 endpoints of the ``edgefactor * 2**scale`` generated edges:
    quadrants drawn from ``structure``, permutation and shuffle from
    ``labels``."""
    m = int(edgefactor) << int(scale)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = torch.zeros(m, dtype=torch.int64, device=device)
    jj = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(int(scale)):
        ii_bit = torch.rand(m, generator=structure, device=device) > ab
        thresh = torch.where(ii_bit, c_norm, a_norm)
        jj_bit = torch.rand(m, generator=structure, device=device) > thresh
        ii += ii_bit.to(torch.int64) << bit
        jj += jj_bit.to(torch.int64) << bit
    perm = torch.randperm(1 << int(scale), generator=labels, device=device)
    ii, jj = perm[ii], perm[jj]
    shuffle = torch.randperm(m, generator=labels, device=device)
    return ii[shuffle], jj[shuffle]


def undirected_arcs(u: torch.Tensor, v: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Both arcs of every edge, self-loops and duplicates dropped, sorted by
    (source, destination): int32 ``(src, dst)``."""
    s = torch.cat([u, v])
    d = torch.cat([v, u])
    keep = s != d
    key = torch.unique(s[keep] * n + d[keep])
    return (key // n).to(torch.int32), (key % n).to(torch.int32)


def kronecker_graph(scale: int, edgefactor: int, a: float, b: float, c: float,
                    structure_seed: int, seed: int,
                    device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The arcs of kernel 1's undirected graph and its vertex count."""
    gens = []
    for sd in (structure_seed, seed):
        gens.append(torch.Generator(device=device))
        gens[-1].manual_seed(int(sd))
    u, v = kronecker_edges(scale, edgefactor, a, b, c, *gens, device)
    n = 1 << int(scale)
    src, dst = undirected_arcs(u, v, n)
    return src, dst, n
