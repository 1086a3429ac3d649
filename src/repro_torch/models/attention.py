"""Attention (``repro.models.attention``): chunked causal attention, decode
attention and full attention, as torch ops.

The JAX package computes attention itself in plain ``jnp`` (no kernel),
and so does this module: ``causal_attention`` loops in Python over query
chunks with an online softmax over key chunks, visiting only the lower
block-triangle (and, for a local window, only chunks inside it), which
bounds the scores at (B, H, q_chunk, kv_chunk) per step.  Decode attends
one query token against the whole KV cache with a position mask, through
grouped-query einsums that never repeat the cache.

Dtypes follow JAX's promotion, made explicit because torch's ``einsum``
wants one dtype: scores are float32 (JAX's ``preferred_element_type``),
and the weighted sum of values is taken in the promoted dtype of the
probabilities (cast to the query's dtype) and the values, so a bfloat16
query against a float32 cache gives a float32 result, as in JAX.

On a mesh (``models/common.py``'s sharding layer) the inputs are
DTensors.  ``causal_attention`` then runs on each rank's shard of the
batch and heads (``local_map``: attention is local to a (row, head)),
except on the ``kv_shard`` path, which keeps the keys sharded over the
sequence and the scores over the key axis, as JAX does for head counts
that do not divide the model axis: its softmax (``_softmax``) reduces
over the sharded axis in two small all-reduces (max and sum), and the
weighted sum of values in one more.  Decode keeps the cache sharded over
the sequence the same way.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (_fit, einsum, get_mesh, is_dtensor, logical_spec,
                                       placements, shard)
from repro_torch.models.common import softcap as _softcap

NEG_INF = -1e30


def _chunk_scores(q, k, scale, cap):
    # float32 scores: the products of two bfloat16 values are exact in
    # float32, so this equals JAX's bf16 einsum with f32 accumulation
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return _softcap(s, cap)


def _softmax(s):
    """Softmax over the last axis.  On a DTensor it is spelled out, so a
    key axis sharded over the mesh costs an all-reduce of the row maxima
    and one of the row sums (DTensor's own softmax gathers the whole
    axis first)."""
    if not is_dtensor(s):
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _gqa(k, H: int):
    """(B, S, KV, D) keys or values for H query heads: each KV head repeated
    H // KV times in place (``repeat_interleave`` as expand and reshape,
    which DTensor has rules for; on a mesh the heads are gathered first)."""
    B, S, KV, D = k.shape
    k = shard(k, "batch", None, None, None)
    return k[:, :, :, None, :].expand(B, S, KV, H // KV, D).reshape(B, S, H, D)


def causal_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    local_window: int = 0,  # 0 = global
    attn_softcap: float = 0.0,
    causal: bool = True,
    kv_shard: bool = False,
) -> torch.Tensor:
    """``kv_shard=True`` selects the key-axis-sharded path for head counts
    that do not divide the model axis (llava/arctic: 56 heads): keys stay
    sharded over the sequence ('seq_shard') and the scores over the key
    axis, query chunk by query chunk against all S keys.  Without a mesh
    it computes the same attention."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:  # GQA: broadcast kv heads across groups
        k, v = _gqa(k, H), _gqa(v, H)
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, local_window=local_window,
              attn_softcap=attn_softcap, causal=causal)
    if kv_shard and causal and S > q_chunk:
        return _kv_sharded(q, k, v, q_chunk, local_window, attn_softcap)
    return _per_head(lambda a, b, c: _causal(a, b, c, **kw), q, k, v)


def _per_head(fn, q, k, v):
    """``fn(q, k, v)``; on DTensors, on each rank's shard of the batch and
    heads (attention is local to a (row, head)): the one place q, k and v
    are redistributed."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    mesh = get_mesh()
    pl = placements(mesh, _fit(logical_spec("batch", None, "heads", None), q.shape))
    return local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl),
                     redistribute_inputs=True, device_mesh=mesh)(q, k, v)


def _kv_sharded(q, k, v, q_chunk, local_window, attn_softcap):
    """JAX's kv_shard loop: each query chunk's scores against all S keys,
    masked, with the keys and scores sharded over the key axis."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    k = shard(k, "batch", "seq_shard", None, None)
    v = shard(v, "batch", "seq_shard", None, None)
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for lo in range(0, S, q_chunk):
        qc = min(q_chunk, S - lo)
        s = _chunk_scores(q[:, lo : lo + qc], k, scale, attn_softcap)  # (B, H, qc, S)
        qpos = lo + torch.arange(qc, device=q.device)[:, None]
        mask = kpos <= qpos
        if local_window:
            mask &= kpos > qpos - local_window
        s = torch.where(mask, s, NEG_INF)
        s = shard(s, "batch", None, None, "seq_shard")
        outs.append(einsum("bhqk,bkhd->bqhd", _softmax(s).to(q.dtype), v))
    return torch.cat(outs, dim=1)


def _causal(q, k, v, *, q_chunk, kv_chunk, local_window, attn_softcap, causal):
    """Causal (or full) attention over q's heads; k and v have as many."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    if S <= q_chunk or not causal:
        s = _chunk_scores(q, k, scale, attn_softcap)
        if causal:
            ones = torch.ones((S, S), dtype=torch.bool, device=dev)
            mask = ones.tril()
            if local_window:
                mask &= ones.triu(-local_window + 1)
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)

    if S % q_chunk or S % kv_chunk:
        # ragged sequence (e.g. VLM patch-prefix + tokens): pad to the chunk
        # grid.  Padded q rows are sliced off below; padded k positions sit
        # beyond every real qpos so the causal mask already excludes them.
        pad = (-S) % math.lcm(q_chunk, kv_chunk)

        def padded(t):
            return torch.cat([t, t.new_zeros((B, pad) + tuple(t.shape[2:]))], dim=1)

        out = _causal(padded(q), padded(k), padded(v), q_chunk=q_chunk,
                      kv_chunk=kv_chunk, local_window=local_window,
                      attn_softcap=attn_softcap, causal=causal)
        return out[:, :S]
    nq = S // q_chunk
    Dv = v.shape[-1]
    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk : (i + 1) * q_chunk]
        q_lo = i * q_chunk
        j_hi = ((i + 1) * q_chunk - 1) // kv_chunk  # last kv chunk visible
        j_lo = 0
        if local_window:
            j_lo = max(0, (q_lo - local_window + 1) // kv_chunk)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_chunk, H, Dv), dtype=torch.float32, device=dev)
        qpos = q_lo + torch.arange(q_chunk, device=dev)[:, None]
        for j in range(j_lo, j_hi + 1):
            kj = k[:, j * kv_chunk : (j + 1) * kv_chunk]
            vj = v[:, j * kv_chunk : (j + 1) * kv_chunk]
            s = _chunk_scores(qi, kj, scale, attn_softcap)  # (B,H,qc,kc)
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = kpos <= qpos
            if local_window:
                mask &= kpos > qpos - local_window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr.transpose(1, 2)[:, :, :, None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, vj.float())
            m = m_new
        safe_l = torch.clamp_min(l, 1e-20)
        outs.append((acc / safe_l.transpose(1, 2)[:, :, :, None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, Smax, KV, D)
    v_cache: torch.Tensor,  # (B, Smax, KV, D)
    pos: torch.Tensor,  # (B,) index of the query token
    *,
    local_window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Single-token attention through grouped-query einsums: the (B, 1, KV,
    G, D) query meets each KV head's cache once, with no repeat of the
    cache across the G query heads of its group.  On a mesh the scores stay
    sharded over the cache's sequence axis ('seq_shard'), as in JAX."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(D)
    # on a mesh the query's heads are gathered (one token's worth): the
    # cache is sharded over its sequence, not its heads
    q = shard(q, "batch", None, None, None)
    qg = q.reshape(B, 1, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * scale
    s = _softcap(s, attn_softcap)
    kpos = torch.arange(S, device=q.device).view(1, 1, 1, 1, S)
    p5 = pos.view(B, 1, 1, 1, 1)
    mask = kpos <= p5
    if local_window:
        mask = mask & (kpos > p5 - local_window)
    s = torch.where(mask, s, NEG_INF)
    s = shard(s, "batch", None, None, None, "seq_shard")
    o = einsum("bkgqs,bskd->bqkgd", _softmax(s).to(q.dtype), v_cache)
    return o.reshape(B, 1, H, v_cache.shape[-1])


def full_attention(q, k, v, *, attn_softcap: float = 0.0, mask=None):
    """Non-causal attention (encoder self-attn, cross-attn); on a mesh, on
    each rank's shard of the batch and heads, as ``causal_attention``."""
    H = q.shape[2]
    if k.shape[2] != H:
        k, v = _gqa(k, H), _gqa(v, H)
    return _per_head(lambda a, b, c: _full(a, b, c, attn_softcap, mask), q, k, v)


def _full(q, k, v, attn_softcap, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _chunk_scores(q, k, scale, attn_softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
