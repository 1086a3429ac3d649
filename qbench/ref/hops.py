"""Hop distances d(s, t) by plain level-synchronous BFS, and the control.

``hop_distances`` runs BFS from each source over the directed arcs
``src -> dst``, a batch of sources at a time, until every target of the
batch is reached or no frontier is left: -1 means unreachable.

``first_meet_distances`` is the control.  It runs bidirectional BFS level
by level, as a port might to save the work, but answers with the first
vertex (lowest id) where the two searches meet instead of the meet with
the least ``ds + dt``.  That breaks the configuration's guarantee of exact
distances: when d(s, t) is odd, a vertex met at the same level from both
sides reads one hop too many.
"""
from __future__ import annotations

import torch


def _expand(frontier: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            n: int) -> torch.Tensor:
    """(B, n) bool: the vertices one arc away from each lane's frontier."""
    act = frontier.any(0)
    sel = act[src].nonzero().squeeze(1)
    s_a, d_a = src[sel], dst[sel]
    msg = frontier[:, s_a].to(torch.uint8)
    out = torch.zeros((frontier.shape[0], n), dtype=torch.uint8, device=frontier.device)
    out.scatter_reduce_(1, d_a.expand(frontier.shape[0], -1), msg, reduce="amax")
    return out.bool()


def hop_distances(src: torch.Tensor, dst: torch.Tensor, n: int,
                  sources, targets, lanes: int = 32) -> torch.Tensor:
    """(K,) int64 hop distance from each source to its target (-1: none)."""
    dev = src.device
    src, dst = src.long(), dst.long()
    s_all = torch.as_tensor(sources, dtype=torch.long, device=dev)
    t_all = torch.as_tensor(targets, dtype=torch.long, device=dev)
    out = torch.full((len(s_all),), -1, dtype=torch.int64, device=dev)
    for lo in range(0, len(s_all), lanes):
        s, t = s_all[lo:lo + lanes], t_all[lo:lo + lanes]
        rows = torch.arange(len(s), device=dev)
        dist = torch.full((len(s), n), -1, dtype=torch.int64, device=dev)
        dist[rows, s] = 0
        frontier = torch.zeros((len(s), n), dtype=torch.bool, device=dev)
        frontier[rows, s] = True
        level = 0
        while True:
            reached = dist[rows, t] >= 0
            frontier &= ~reached[:, None]
            if not bool(frontier.any()):
                break
            level += 1
            new = _expand(frontier, src, dst, n) & (dist < 0)
            dist[new] = level
            frontier = new
        out[lo:lo + lanes] = dist[rows, t]
    return out


def first_meet_distances(src: torch.Tensor, dst: torch.Tensor, n: int,
                         sources, targets, lanes: int = 32) -> torch.Tensor:
    """(K,) int64: the control's answers (-1: the searches never met)."""
    dev = src.device
    src, dst = src.long(), dst.long()
    s_all = torch.as_tensor(sources, dtype=torch.long, device=dev)
    t_all = torch.as_tensor(targets, dtype=torch.long, device=dev)
    out = torch.full((len(s_all),), -1, dtype=torch.int64, device=dev)
    for lo in range(0, len(s_all), lanes):
        s, t = s_all[lo:lo + lanes], t_all[lo:lo + lanes]
        rows = torch.arange(len(s), device=dev)
        ds = torch.full((len(s), n), -1, dtype=torch.int64, device=dev)
        dt = torch.full((len(s), n), -1, dtype=torch.int64, device=dev)
        ds[rows, s] = 0
        dt[rows, t] = 0
        ff = torch.zeros((len(s), n), dtype=torch.bool, device=dev)
        fb = torch.zeros((len(s), n), dtype=torch.bool, device=dev)
        ff[rows, s] = True
        fb[rows, t] = True
        ans = torch.full((len(s),), -1, dtype=torch.int64, device=dev)
        level = 0
        while True:
            meet = (ds >= 0) & (dt >= 0)
            found = meet.any(1)
            first = meet.to(torch.uint8).argmax(1)
            take = found & (ans < 0)
            ans[take] = (ds[rows, first] + dt[rows, first])[take]
            open_ = (ans < 0) & ff.any(1) & fb.any(1)
            if not bool(open_.any()):
                break
            ff &= open_[:, None]
            fb &= open_[:, None]
            level += 1
            nf = _expand(ff, src, dst, n) & (ds < 0)
            nb = _expand(fb, dst, src, n) & (dt < 0)
            ds[nf] = level
            dt[nb] = level
            ff, fb = nf, nb
        out[lo:lo + lanes] = ans
    return out
