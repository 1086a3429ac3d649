"""Model assembly (``repro.models.transformer``) for the dense and vlm
families.

Parameters are a dict of tensors with the JAX package's keys and shapes,
so carrying weights across (``carry.params_from_numpy``) is a copy.
Layers are grouped into *super-blocks* of ``len(attn_pattern)`` layers:
with ``scan_layers`` and more than one super-block, ``blocks`` holds one
dict per pattern position whose tensors are stacked over super-blocks
(leading axis), and any remainder layers sit unrolled in ``rem_blocks``;
otherwise every layer is in ``rem_blocks``.  ``_run_layers`` loops in
Python over the stacked super-blocks, then over ``rem_blocks``, as JAX's
``lax.scan`` does.

Modes:
  forward(params, cfg, batch)                 -> logits over token positions
  loss_fn(params, cfg, batch)                 -> scalar CE loss (forward only)
  init_cache(cfg, B, max_len)                 -> decode cache pytree
  serve_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``serve_step`` writes the new key/value entries into the cache's tensors
in place and returns the same cache; a JAX step returns a new one with
the same values.

The moe, ssm, hybrid and audio families and MLA come with their own slice
(ROADMAP.md §1, *LM families*): ``init_params``, ``init_cache`` and the
server refuse them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import dense_init, mm, rms_norm, rope_angles, rotate, softcap


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a config whose layers this package cannot run yet."""
    if cfg.family in ("moe", "ssm", "hybrid", "audio") or cfg.use_mla:
        what = "MLA" if cfg.use_mla else f"the {cfg.family} family"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP.md §1, *LM families*)")


# ---------------------------------------------------------------- pattern
def layer_pattern(cfg: ArchConfig) -> list[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.block_pattern:
        return [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    return [cfg.attn_pattern[i % len(cfg.attn_pattern)] for i in range(cfg.n_layers)]


def _plen(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return 1
    if cfg.block_pattern:
        return len(cfg.block_pattern)
    return len(cfg.attn_pattern)


def n_stacked(cfg: ArchConfig) -> int:
    """Super-blocks stacked in ``blocks`` (0: every layer is unrolled)."""
    n_super = cfg.n_layers // _plen(cfg)
    return n_super if (cfg.scan_layers and n_super > 1) else 0


# ------------------------------------------------------------- init layers
def init_attn_layer(generator, cfg: ArchConfig, dtype, lead: tuple = ()):
    """One attention layer (non-MLA, no cross-attention); ``lead``
    prefixes every shape (the stacked super-block axis)."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device

    def norm():
        return torch.zeros(lead + (d,), dtype=torch.float32, device=dev)

    return dict(
        ln1_rep=norm(),
        wq_colp=dense_init(generator, lead + (d, H * hd), dtype=dtype),
        wk_colp=dense_init(generator, lead + (d, KV * hd), dtype=dtype),
        wv_colp=dense_init(generator, lead + (d, KV * hd), dtype=dtype),
        wo_rowp=dense_init(generator, lead + (H * hd, d), dtype=dtype),
        ln2_rep=norm(),
        mlp=mlp_lib.init_mlp(generator, d, cfg.d_ff, dtype, lead),
    )


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` (seeded by the caller) on
    its own device, then moved to ``resolve_device(device)``."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    n_super = n_stacked(cfg)
    plen = _plen(cfg)
    params: dict[str, Any] = dict(
        embed_embed=dense_init(generator, (cfg.vocab_padded, cfg.d_model), in_axis=-1,
                               dtype=dtype),
        final_norm_rep=torch.zeros((cfg.d_model,), dtype=torch.float32),
    )
    if not cfg.tie_embeddings:
        params["lm_head_colp"] = dense_init(generator, (cfg.d_model, cfg.vocab_padded),
                                            dtype=dtype)
    params["blocks"] = [init_attn_layer(generator, cfg, dtype, (n_super,))
                        for _ in range(plen if n_super else 0)]
    n_rem = cfg.n_layers - n_super * plen
    params["rem_blocks"] = [init_attn_layer(generator, cfg, dtype) for _ in range(n_rem)]
    return tree_map(lambda t: t.to(dev), params)


# --------------------------------------------------------------- caching
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zero KV caches: a local layer's is a ring buffer of
    ``min(max_len, local_window)`` positions."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    pat = layer_pattern(cfg)

    def one(kind, lead=()):
        length = min(max_len, cfg.local_window) if kind == "local" else max_len
        shape = lead + (batch, length, cfg.n_kv_heads, cfg.hd)
        return dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))

    plen = _plen(cfg)
    n_super = n_stacked(cfg)
    return dict(
        blocks=[one(pat[p], (n_super,)) for p in range(plen if n_super else 0)],
        rem_blocks=[one(pat[n_super * plen + i])
                    for i in range(cfg.n_layers - n_super * plen)],
    )


# ----------------------------------------------------------- layer apply
def apply_attn_layer(p, x, cfg: ArchConfig, kind: str, angles, cache=None, pos=None):
    """x: (B, S, D).  Train/prefill when cache is None; else single-token
    decode writing the cache at pos (B,).  ``angles``: ``rope_angles`` of
    the token positions (``pos[:, None]`` in decode), None without RoPE."""
    B, S, D = x.shape
    H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv_heads
    window = cfg.local_window if kind == "local" else 0
    h = rms_norm(x, p["ln1_rep"], cfg.norm_eps)
    q = mm(h, p["wq_colp"]).reshape(B, S, H, hd)
    k = mm(h, p["wk_colp"]).reshape(B, S, KV, hd)
    v = mm(h, p["wv_colp"]).reshape(B, S, KV, hd)
    if cfg.rope:
        q = rotate(q, angles)
        k = rotate(k, angles)
    if cache is not None:
        bidx = torch.arange(B, device=x.device)
        length = cache["k"].shape[1]
        # a local layer's ring buffer; a negative position (a dead slot's
        # pos - 1) wraps to the last entry, as a JAX index does
        slot = pos % length
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        # ring buffer: all slots valid once warm; the window equals the
        # buffer length, so the mask is the position's
        qpos = torch.clamp_max(pos, length - 1) if kind == "local" else pos
        o = attn_lib.decode_attention(q, cache["k"], cache["v"], qpos,
                                      local_window=0, attn_softcap=cfg.attn_softcap)
    else:
        o = attn_lib.causal_attention(
            q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            local_window=window, attn_softcap=cfg.attn_softcap)
    # a bfloat16 residual plus a float32 attention output is float32, as in JAX
    x = x + mm(o.reshape(B, S, H * hd), p["wo_rowp"])
    h2 = rms_norm(x, p["ln2_rep"], cfg.norm_eps)
    return x + mlp_lib.mlp(p["mlp"], h2), cache


# ----------------------------------------------------------- full model
def _run_layers(params, x, cfg: ArchConfig, positions, cache=None, pos=None):
    check_ported(cfg)
    pat = layer_pattern(cfg)
    plen = _plen(cfg)
    n_super = n_stacked(cfg)
    # every layer rotates by the same positions: the angles are computed
    # once here (JAX recomputes them per layer; the values are the same)
    angles = None
    if cfg.rope:
        angles = rope_angles(positions if cache is None else pos[:, None], cfg.hd,
                             cfg.rope_theta)
    for i in range(n_super if params["blocks"] else 0):
        for j in range(plen):
            pj = tree_map(lambda t: t[i], params["blocks"][j])
            cj = None if cache is None else tree_map(lambda t: t[i], cache["blocks"][j])
            x, _ = apply_attn_layer(pj, x, cfg, pat[j], angles, cj, pos)
    for i, p in enumerate(params["rem_blocks"]):
        ci = None if cache is None else cache["rem_blocks"][i]
        x, _ = apply_attn_layer(p, x, cfg, pat[n_super * plen + i], angles, ci, pos)
    return x, cache


def _logits(params, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        logits = mm(x, params["embed_embed"].T)
    else:
        logits = mm(x, params["lm_head_colp"])
    return softcap(logits.float(), cfg.final_softcap)


def forward(params, cfg: ArchConfig, batch: dict):
    """Returns logits over the token positions of batch['tokens']."""
    emb = params["embed_embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device)
    x = emb[tokens]
    n_prefix = 0
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=emb.device)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=emb.device)
    x, _ = _run_layers(params, x, cfg, positions)
    x = rms_norm(x, params["final_norm_rep"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    return _logits(params, cfg, x)


def loss_fn(params, cfg: ArchConfig, batch: dict):
    """Mean next-token cross-entropy; its backward comes with the training
    slice (ROADMAP.md §1, *LM training*)."""
    logits = forward(params, cfg, batch)
    targets = torch.as_tensor(batch["targets"], device=logits.device).long()
    lp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(lp, -1, targets[..., None])[..., 0]
    return -ll.mean()


def prefill(params, cfg: ArchConfig, batch: dict):
    """Prefill forward (no targets): returns last-position logits."""
    return forward(params, cfg, batch)[:, -1]


def serve_step(params, cfg: ArchConfig, cache: dict, tokens, pos):
    """One decode step: tokens (B, 1), pos (B,) -> (logits (B, V), cache)."""
    x = params["embed_embed"][tokens]
    x, cache = _run_layers(params, x, cfg, None, cache=cache, pos=pos)
    x = rms_norm(x, params["final_norm_rep"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
