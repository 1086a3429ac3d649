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
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import einsum
from repro_torch.models.common import softcap as _softcap

NEG_INF = -1e30


def _chunk_scores(q, k, scale, cap):
    # float32 scores: the products of two bfloat16 values are exact in
    # float32, so this equals JAX's bf16 einsum with f32 accumulation
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return _softcap(s, cap)


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
    """``kv_shard=True`` is the JAX package's key-axis-sharded path for head
    counts that do not divide a mesh's model axis; without a mesh JAX never
    takes it, and the port refuses it."""
    if kv_shard:
        raise NotImplementedError(
            "kv_shard=True shards keys over a mesh axis, which waits for the "
            "mesh tooling (ROADMAP.md §1, *TPU-mesh tooling*)")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:  # GQA: broadcast kv heads across groups
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
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

        out = causal_attention(
            padded(q), padded(k), padded(v),
            q_chunk=q_chunk, kv_chunk=kv_chunk, local_window=local_window,
            attn_softcap=attn_softcap, causal=causal,
        )
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
    cache across the G query heads of its group."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * scale
    s = _softcap(s, attn_softcap)
    kpos = torch.arange(S, device=q.device).view(1, 1, 1, 1, S)
    p5 = pos.view(B, 1, 1, 1, 1)
    mask = kpos <= p5
    if local_window:
        mask = mask & (kpos > p5 - local_window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = einsum("bkgqs,bskd->bqkgd", p.to(q.dtype), v_cache)
    return o.reshape(B, 1, H, v_cache.shape[-1])


def full_attention(q, k, v, *, attn_softcap: float = 0.0, mask=None):
    """Non-causal attention (encoder self-attn, cross-attn)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    KV = k.shape[2]
    H = q.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    s = _chunk_scores(q, k, scale, attn_softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
