"""Weighted shortest-path distances d(s, t) by plain label correction.

Arc weights are the 3D-Euclidean lengths between the endpoints' positions,
worked out here from the positions.  From each source, every vertex whose
distance fell in the last pass relaxes its out-arcs; a lane stops when its
target's distance is no larger than the least distance among the vertices
that still have to relax (weights are non-negative, so no later pass can
lower it) or when nothing is left to relax.  +inf means unreachable.

``dtype`` sets the precision of the weights and of the distances: the
benchmark's reference works in float64; its control, the same search in
bfloat16, is the precision below the float32 that the configuration states.
"""
from __future__ import annotations

import torch


def arc_weights(coords: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """(E,) ``|coords[dst] - coords[src]|`` computed in float64, cast to ``dtype``."""
    d = coords[dst.long()].double() - coords[src.long()].double()
    return d.square().sum(1).sqrt().to(dtype)


def sssp_distances(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int,
                   sources, targets, lanes: int = 32) -> torch.Tensor:
    """(K,) distance from each source to its target in ``w``'s dtype."""
    dev, dtype = src.device, w.dtype
    order = torch.argsort(src.long(), stable=True)
    s_sorted, d_sorted, w_sorted = src.long()[order], dst.long()[order], w[order]
    row = torch.searchsorted(s_sorted, torch.arange(n + 1, device=dev))
    s_all = torch.as_tensor(sources, dtype=torch.long, device=dev)
    t_all = torch.as_tensor(targets, dtype=torch.long, device=dev)
    out = torch.full((len(s_all),), float("inf"), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    for lo in range(0, len(s_all), lanes):
        s, t = s_all[lo:lo + lanes], t_all[lo:lo + lanes]
        b = len(s)
        rows = torch.arange(b, device=dev)
        dist = torch.full((b, n), float("inf"), dtype=dtype, device=dev)
        dist[rows, s] = 0
        changed = torch.zeros((b, n), dtype=torch.bool, device=dev)
        changed[rows, s] = True
        while True:
            pending = torch.where(changed, dist, inf).amin(1)
            open_ = changed.any(1) & (dist[rows, t] > pending)
            if not bool(open_.any()):
                break
            changed &= open_[:, None]
            verts = changed.any(0).nonzero().squeeze(1)
            starts, ends = row[verts], row[verts + 1]
            counts = ends - starts
            first = torch.repeat_interleave(starts - (counts.cumsum(0) - counts), counts)
            arcs = first + torch.arange(int(counts.sum()), device=dev)
            a_src, a_dst, a_w = s_sorted[arcs], d_sorted[arcs], w_sorted[arcs]
            cand = torch.where(changed[:, a_src], dist[:, a_src] + a_w, inf)
            best = torch.full((b, n), float("inf"), dtype=dtype, device=dev)
            best.scatter_reduce_(1, a_dst.expand(b, -1), cand, reduce="amin")
            changed = best < dist
            dist = torch.minimum(dist, best)
        out[lo:lo + lanes] = dist[rows, t]
    return out
