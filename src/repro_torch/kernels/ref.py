"""Plain PyTorch oracles for frontier propagation.

``propagate_coo`` is the reference semantics of one Pregel superstep with a
combiner: edge-parallel message generation, then a ``scatter_reduce`` keyed
by destination.  ``propagate_coo_gated`` reduces over the active
out-edges only (the frontier's, through the CSR view), in fixed-size
chunks.  ``propagate_blocks_ref`` is the same function on the
block-sparse layout, the plain tile loop the CUDA kernel in
``frontier.py`` must match: bit-exactly on integer semirings and to float
tolerance on float ones.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.graph import BlockSparse, Graph
from repro_torch.core.semiring import INF, Semiring


def apply_mul(sr: Semiring, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The semiring's ``mul``; integer plus saturates at ±INF, never wraps."""
    integer = not x.dtype.is_floating_point
    if sr.name in ("min_plus", "max_plus"):
        w = w.to(x.dtype)
        if not integer:
            return x + w
        if sr.name == "min_plus":
            return torch.where((x >= INF) | (w >= INF), INF, x + w)
        return torch.where((x <= -INF) | (w <= -INF), -INF, x + w)
    if sr.name in ("min_right", "max_right"):
        return x
    if sr.name == "sum_times":
        return x * w.to(x.dtype)
    raise ValueError(sr.name)


def _coo(sr: Semiring, x, frontier, src, dst, w, n):
    """``propagate_coo`` on prepared int64 edge indices."""
    if frontier is not None:
        x = torch.where(frontier, x, sr.identity(x.dtype))
    flat = x.reshape(-1, x.shape[-1])
    msgs = apply_mul(sr, flat[:, src], w)
    return sr.segment_combine(msgs, dst, n).reshape(x.shape)


def coo_indices(graph: Graph):
    """The ``(src, dst, w)`` that ``_coo`` reads, indices in int64: the
    logical prefix only, so capacity padding (the tail of a
    ``Graph.with_capacity`` graph) is never gathered or scattered."""
    ne = graph.num_edges
    return graph.src[:ne].long(), graph.dst[:ne].long(), graph.w[:ne]


def propagate_coo(graph: Graph, sr: Semiring, x: torch.Tensor,
                  frontier=None) -> torch.Tensor:
    """One superstep: x (..., V) -> combined incoming messages (..., V).

    ``frontier`` (..., V) bool masks which sources emit; a masked source
    contributes the add-identity.  Leading axes are lanes (C slots): they
    are flattened and reduced in one ``scatter_reduce``.  Capacity padding
    (``Graph.with_capacity``) is inert.
    """
    return _coo(sr, x, frontier, *coo_indices(graph), graph.n)


def propagate_coo_gated(graph: Graph, sr: Semiring, x: torch.Tensor, frontier,
                        chunk: int) -> torch.Tensor:
    """Frontier-gated superstep: reduce over the ACTIVE out-edges only.

    The edges whose source is active in any lane (through the CSR view)
    are compacted once (``nonzero``, the one device->host sync of this
    call: the JAX package runs a ``while_loop`` whose trip count the
    device decides), then consumed in ``chunk``-sized gathers, each
    reduced by ``scatter_reduce`` into the accumulator; the tail of the
    last chunk points at a dummy segment ``n`` that is sliced off.  Exact
    for any frontier size; reduction work follows the frontier, not E.
    Lanes share one edge subset and each lane is masked to the
    add-identity outside its own frontier, as in :func:`propagate_coo`.
    """
    if graph.csr_row is None:
        raise ValueError("graph has no CSR view; rebuild via Graph.from_edges")
    n, add_id = graph.n, sr.identity(x.dtype)
    frontier = torch.broadcast_to(frontier, x.shape)
    xf = x.reshape(-1, n)
    ff = frontier.reshape(-1, n)
    xm = torch.where(ff, xf, add_id)
    live = torch.zeros(n + 1, dtype=torch.bool, device=x.device)
    live[:n] = ff.any(0)  # capacity padding's source n is never live
    ids = live[graph.csr_src.long()].nonzero().squeeze(1)
    total = ids.numel()
    if total % chunk:
        ids = torch.cat([ids, ids.new_full((chunk - total % chunk,), -1)])
    acc = torch.full((xm.shape[0], n + 1), add_id, dtype=x.dtype, device=x.device)
    for lo in range(0, ids.numel(), chunk):
        eid = ids[lo:lo + chunk]
        valid = eid >= 0
        eid = eid.clamp(min=0)
        s = graph.csr_src[eid].long().clamp(max=n - 1)
        d = torch.where(valid, graph.csr_dst[eid].long(), n)
        msgs = apply_mul(sr, xm[:, s], graph.csr_w[eid])
        acc.scatter_reduce_(1, d.expand(msgs.shape), msgs, reduce=sr.reduce,
                            include_self=True)
    return acc[:, :n].reshape(x.shape)


def _tile_part(sr: Semiring, xs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(Q, N, B) x (N, B, B) -> (Q, N, B): the partial combine of N tiles."""
    add_id = sr.identity(xs.dtype)
    if sr.name in ("min_plus", "max_plus"):
        xe = xs[..., :, None]
        te = t[None].to(xs.dtype)
        s = xe + te
        if not xs.dtype.is_floating_point:
            if sr.name == "min_plus":
                s = torch.where((xe >= INF) | (te >= INF), add_id, s)
            else:
                s = torch.where((xe <= -INF) | (te <= -INF), add_id, s)
        return s.amin(-2) if sr.name == "min_plus" else s.amax(-2)
    if sr.name in ("min_right", "max_right"):
        masked = torch.where(t[None] != add_id, xs[..., :, None], add_id)
        return masked.amin(-2) if sr.name == "min_right" else masked.amax(-2)
    if sr.name == "sum_times":
        # elementwise product and sum: full fp32, no TF32 matmul path
        return (xs[..., :, None] * t[None].to(xs.dtype)).sum(-2, dtype=xs.dtype)
    raise ValueError(sr.name)


def propagate_blocks_ref(bs: BlockSparse, sr: Semiring, x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain tile loop on the block-sparse layout. x: (Q, V) -> (Q, V).

    Loops over the slot axis k, each step combining every destination
    block's k-th tile at once; ``mask`` (Q, V) bool applies the per-lane
    frontier inside each tile (a masked source contributes the identity),
    ``active`` (nb, max_bpr) bool drops dead tiles from the accumulate.
    """
    q, v = x.shape
    b, nb = bs.block, bs.num_dst_blocks
    vp = nb * b
    add_id = sr.identity(x.dtype)
    xb = torch.full((q, vp), add_id, dtype=x.dtype, device=x.device)
    xb[:, :v] = x
    if mask is not None:
        mb = torch.zeros((q, vp), dtype=torch.bool, device=x.device)
        mb[:, :v] = mask
        xb = torch.where(mb, xb, add_id)
    xb = xb.reshape(q, nb, b)
    acc = torch.full((q, nb, b), add_id, dtype=x.dtype, device=x.device)
    src_ids = bs.src_ids.long()
    for k in range(bs.max_bpr):
        part = _tile_part(sr, xb[:, src_ids[:, k]], bs.tiles[:, k])
        if active is not None:
            part = torch.where(active[:, k, None], part, add_id)
        acc = sr.add(acc, part)
    return acc.reshape(q, vp)[:, :v]
