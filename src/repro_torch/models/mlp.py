"""Feed-forward layers (``repro.models.mlp``): the SwiGLU MLP and the
sort-based capacity MoE.

MoE dispatch is the JAX package's sort-based capacity scheme (no (T, E,
C) one-hot): token->expert assignments are sorted by expert id (a stable
sort, as ``jnp.argsort``), ranked within their expert, dropped beyond
capacity, and scattered into an (E, C, D) buffer.  The experts are then
two dense per-expert einsums over every expert's weights, and the
results scatter back weighted by the router probabilities.  Assignments
over capacity fall through on the residual stream.

Dispatch runs per *token block* (``n_blocks``), as in JAX, where the
block axis follows a mesh's data sharding (``batch_shards()``; one block
without a mesh).  On a mesh the routing plan and the buffer fill, and
the collect, run on each rank's blocks (``local_map_batch``: DTensor has
no rule for the sort or the index writes), and only the (blocks, E, C,
D) buffer crosses the mesh to meet the expert-sharded weights.  Capacity
is per (block, expert), ``ceil(T_b * K / E * capacity_factor)``,
computed on the host from the static token count, so a decode step's C
slots share it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, einsum, local_map_batch, mm, shard


def init_mlp(generator, d_model: int, d_ff: int, dtype, lead: tuple = ()):
    """``lead`` prefixes every shape (the stacked super-block axis)."""
    return dict(
        w_gate_colp=dense_init(generator, lead + (d_model, d_ff), dtype=dtype),
        w_up_colp=dense_init(generator, lead + (d_model, d_ff), dtype=dtype),
        w_down_rowp=dense_init(generator, lead + (d_ff, d_model), dtype=dtype),
    )


def mlp(params, x):
    h = F.silu(mm(x, params["w_gate_colp"])) * mm(x, params["w_up_colp"])
    h = shard(h, "batch", "seq", "ffn")
    return mm(h, params["w_down_rowp"])


def init_moe(generator, cfg, dtype, lead: tuple = ()):
    """The router (float32, as in JAX), the (E, D, F) expert weights and,
    with ``n_shared_experts``, one shared MLP of their summed width."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    p = dict(
        w_router_rep=dense_init(generator, lead + (d, e), dtype=torch.float32),
        w_gate_exp=dense_init(generator, lead + (e, d, f), dtype=dtype),
        w_up_exp=dense_init(generator, lead + (e, d, f), dtype=dtype),
        w_down_exp=dense_init(generator, lead + (e, f, d), dtype=dtype),
    )
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, f * cfg.n_shared_experts, dtype, lead)
    return p


def moe(params, x2d: torch.Tensor, cfg, n_blocks: int = 1):
    """x2d: (T, D) flat tokens -> (T, D).  Aux-free top-k routing.

    ``n_blocks`` must divide T (else one block); dispatch is local per
    block.  Capacity is per (block, expert): C = ceil(T_b*K/E * factor).
    """
    T, D = x2d.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    if n_blocks <= 0 or T % n_blocks:
        n_blocks = 1
    Tb = T // n_blocks
    cap = max(1, int(math.ceil(Tb * K / E * cfg.capacity_factor)))

    xb = shard(x2d.reshape(n_blocks, Tb, D), "batch", None, None)
    buf, *plan = local_map_batch(lambda a, w: _dispatch(a, w, E, K, cap), [xb],
                                 [params["w_router_rep"]], n_out=6)
    # the one mesh crossing: block-sharded tokens meet expert-sharded weights
    buf = shard(buf, "batch", "experts", None, None)
    h = einsum("becd,edf->becf", buf, params["w_gate_exp"])
    u = einsum("becd,edf->becf", buf, params["w_up_exp"])
    h = shard(F.silu(h) * u, "batch", "experts", None, None)
    out_buf = einsum("becf,efd->becd", h, params["w_down_exp"])
    out_buf = shard(out_buf, "batch", None, None, None)
    y = local_map_batch(lambda *a: _collect(*a, Tb=Tb, dtype=x2d.dtype), [out_buf, *plan])
    y = shard(y, "batch", None, None).reshape(T, D)
    if "shared" in params:
        y = y + mlp(params["shared"], x2d)
    return y


def _dispatch(xb, w_router, E: int, K: int, cap: int):
    """Every block's routing plan (pure index math) and its filled (nb, E,
    cap, D) buffer; dropped assignments add zeros.  Returns (buf, tok_s,
    wgt_s, keep, slot_e, slot_c), each with the block axis first."""
    n_blocks, Tb, D = xb.shape
    dev = xb.device
    probs = torch.softmax(xb.float() @ w_router.float(), dim=-1)
    # lax.top_k puts the lower index first among equal values: a stable
    # descending sort does the same
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :K], topi[..., :K]  # (nb, Tb, K)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    eid = topi.reshape(n_blocks, Tb * K)
    wgt = topw.reshape(n_blocks, Tb * K)
    tok = torch.arange(Tb, device=dev).repeat_interleave(K).expand(n_blocks, -1)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    tok_s = torch.gather(tok, 1, order)
    wgt_s = torch.gather(wgt, 1, order)
    seg_start = torch.searchsorted(eid_s, eid_s, right=False)
    rank = torch.arange(Tb * K, device=dev) - seg_start
    keep = rank < cap
    slot_e = torch.where(keep, eid_s, E - 1)
    slot_c = torch.where(keep, rank, cap - 1)
    bidx = torch.arange(n_blocks, device=dev)[:, None].expand(-1, Tb * K)

    vals = torch.where(keep[..., None], xb[bidx, tok_s], 0).to(xb.dtype)
    buf = torch.zeros((n_blocks, E, cap, D), dtype=xb.dtype, device=dev)
    buf.index_put_((bidx, slot_e, slot_c), vals, accumulate=True)
    return buf, tok_s, wgt_s, keep, slot_e, slot_c


def _collect(out_buf, tok_s, wgt_s, keep, slot_e, slot_c, Tb: int, dtype):
    """Each kept assignment's expert output, weighted, back to its token:
    (nb, Tb, D) in ``dtype``."""
    n_blocks, _, _, D = out_buf.shape
    bidx = torch.arange(n_blocks, device=out_buf.device)[:, None].expand_as(tok_s)
    w = torch.where(keep, wgt_s, 0.0).to(dtype)
    g = out_buf[bidx, slot_e, slot_c] * w[..., None]
    y = torch.zeros((n_blocks, Tb, D), dtype=dtype, device=out_buf.device)
    y.index_put_((bidx, tok_s), g.to(dtype), accumulate=True)
    return y
