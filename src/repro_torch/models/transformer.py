"""Model assembly (``repro.models.transformer``) for all ten architectures.

Parameters are a dict of tensors with the JAX package's keys and shapes,
so carrying weights across (``carry.params_from_numpy``) is a copy.
Layers are grouped into *super-blocks* of ``len(block_pattern)`` (else
``len(attn_pattern)``; 1 for ssm) layers: with ``scan_layers`` and more
than one super-block, ``blocks`` holds one dict per pattern position
whose tensors are stacked over super-blocks (leading axis), and any
remainder layers sit unrolled in ``rem_blocks``; otherwise every layer
is in ``rem_blocks``.  ``_run_layers`` loops in Python over the stacked
super-blocks, then over ``rem_blocks``, as JAX's ``lax.scan`` does.

Layer kinds: attention (``global``/``local``/``attn``; MLA when
``use_mla``; the FFN an MLP, or a MoE with arctic's dense residual
beside it; cross-attention to the encoder's output in whisper's
decoder), ``rec`` (RG-LRU, ``models/rglru.py``) and ``ssm`` (Mamba2 SSD,
``models/ssm.py``).

Modes:
  forward(params, cfg, batch)                 -> logits over token positions
  loss_fn(params, cfg, batch)                 -> scalar CE loss (train_step)
  init_cache(cfg, B, max_len)                 -> decode cache pytree
  serve_step(params, cfg, cache, tokens, pos) -> (logits, cache)

``serve_step`` writes the new key/value entries, latent (MLA) entries
and recurrent and conv states into the cache's tensors in place (a
stacked layer's state is a view into the stacked tensor, written with
``copy_``) and returns the same cache; a JAX step returns a new one with
the same values.

``remat=True`` (``loss_fn``'s default, as in JAX) wraps each stacked
super-block and each unrolled layer in ``torch.utils.checkpoint``: its
activations are recomputed in the backward pass instead of kept, as
``jax.checkpoint`` does; the values are the same.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (batch_shards, dense_init, divides_model, is_dtensor,
                                       local_map_batch, mm, rms_norm, rope_angles, rotate, shard,
                                       sinusoidal_embed, softcap)


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
def init_attn_layer(generator, cfg: ArchConfig, dtype, lead: tuple = (),
                    cross: bool = False):
    """One attention layer (MLA when ``cfg.use_mla``; cross-attention
    weights when ``cross``); ``lead`` prefixes every shape (the stacked
    super-block axis)."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dev = generator.device

    def norm():
        return torch.zeros(lead + (d,), dtype=torch.float32, device=dev)

    def w(*shape):
        return dense_init(generator, lead + shape, dtype=dtype)

    if cfg.use_mla:
        p = dict(
            ln1_rep=norm(),
            wq_a_rep=w(d, cfg.q_lora_rank),
            wq_b_colp=w(cfg.q_lora_rank, H * (cfg.nope_head_dim + cfg.rope_head_dim)),
            wkv_a_rep=w(d, cfg.kv_lora_rank + cfg.rope_head_dim),
            wkv_b_colp=w(cfg.kv_lora_rank, H * 2 * cfg.nope_head_dim),
            wo_rowp=w(H * cfg.nope_head_dim, d),
        )
    else:
        p = dict(ln1_rep=norm(), wq_colp=w(d, H * hd), wk_colp=w(d, KV * hd),
                 wv_colp=w(d, KV * hd), wo_rowp=w(H * hd, d))
    if cross:
        p.update(ln_x_rep=norm(), xq_colp=w(d, H * hd), xk_colp=w(d, KV * hd),
                 xv_colp=w(d, KV * hd), xo_rowp=w(H * hd, d))
    p["ln2_rep"] = norm()
    if cfg.n_experts:
        p["moe"] = mlp_lib.init_moe(generator, cfg, dtype, lead)
        if cfg.moe_dense_residual or cfg.d_ff:
            p["mlp"] = mlp_lib.init_mlp(generator, d, cfg.d_ff, dtype, lead)
    else:
        p["mlp"] = mlp_lib.init_mlp(generator, d, cfg.d_ff, dtype, lead)
    return p


def init_rec_layer(generator, cfg: ArchConfig, dtype, lead: tuple = ()):
    dev = generator.device
    return dict(
        ln1_rep=torch.zeros(lead + (cfg.d_model,), dtype=torch.float32, device=dev),
        rglru=rglru_lib.init_rglru(generator, cfg, dtype, lead),
        ln2_rep=torch.zeros(lead + (cfg.d_model,), dtype=torch.float32, device=dev),
        mlp=mlp_lib.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, lead),
    )


def init_ssm_layer(generator, cfg: ArchConfig, dtype, lead: tuple = ()):
    return dict(
        ln1_rep=torch.zeros(lead + (cfg.d_model,), dtype=torch.float32,
                            device=generator.device),
        ssm=ssm_lib.init_ssm(generator, cfg, dtype, lead),
    )


def _init_one(kind: str, generator, cfg: ArchConfig, dtype, lead: tuple = ()):
    if kind == "ssm":
        return init_ssm_layer(generator, cfg, dtype, lead)
    if kind == "rec":
        return init_rec_layer(generator, cfg, dtype, lead)
    return init_attn_layer(generator, cfg, dtype, lead, cross=cfg.cross_attention)


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator`` (seeded by the caller) on
    its own device, then moved to ``resolve_device(device)``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    pat = layer_pattern(cfg)
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
    params["blocks"] = [_init_one(pat[j], generator, cfg, dtype, (n_super,))
                        for j in range(plen if n_super else 0)]
    params["rem_blocks"] = [_init_one(pat[i], generator, cfg, dtype)
                            for i in range(n_super * plen, cfg.n_layers)]
    if cfg.encoder_layers:
        params["encoder"] = dict(
            blocks=[init_attn_layer(generator, cfg, dtype)
                    for _ in range(cfg.encoder_layers)],
            final_norm_rep=torch.zeros((cfg.d_model,), dtype=torch.float32),
        )
    return tree_map(lambda t: t.to(dev), params)


# --------------------------------------------------------------- caching
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zero decode caches: an attention layer's keys and values (a local
    layer's a ring buffer of ``min(max_len, local_window)`` positions), an
    MLA layer's latent ``ckv`` and unrotated ``krope``, an SSD layer's
    float32 ``state`` and a recurrent layer's float32 ``h``, each with
    the last ``conv_kernel - 1`` conv inputs; whisper's ``enc_out``."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    pat = layer_pattern(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def one(kind, lead=()):
        if kind == "ssm":
            din = cfg.ssm_expand * cfg.d_model
            nh = din // cfg.ssm_head_dim
            return dict(
                state=zeros(*lead, batch, nh, cfg.ssm_head_dim, cfg.ssm_state,
                            dt=torch.float32),
                conv=zeros(*lead, batch, cfg.conv_kernel - 1, din + 2 * cfg.ssm_state))
        if kind == "rec":
            w = cfg.rglru_width or cfg.d_model
            return dict(h=zeros(*lead, batch, w, dt=torch.float32),
                        conv=zeros(*lead, batch, cfg.conv_kernel - 1, w))
        if cfg.use_mla:
            return dict(ckv=zeros(*lead, batch, max_len, cfg.kv_lora_rank),
                        krope=zeros(*lead, batch, max_len, cfg.rope_head_dim))
        length = min(max_len, cfg.local_window) if kind == "local" else max_len
        shape = lead + (batch, length, cfg.n_kv_heads, cfg.hd)
        return dict(k=zeros(*shape), v=zeros(*shape))

    plen = _plen(cfg)
    n_super = n_stacked(cfg)
    cache = dict(
        blocks=[one(pat[p], (n_super,)) for p in range(plen if n_super else 0)],
        rem_blocks=[one(pat[i]) for i in range(n_super * plen, cfg.n_layers)],
    )
    if cfg.encoder_layers:
        cache["enc_out"] = zeros(batch, cfg.encoder_seq, cfg.d_model)
    return cache


# ----------------------------------------------------------- layer apply
def _write(cache, key: str, pos, value) -> torch.Tensor:
    """Write ``value`` (B, ...) at each row's ``pos`` of ``cache[key]`` (B,
    L, ...) in place; a negative position (a dead slot's pos - 1) wraps to
    the last entry, as a JAX index does; a local layer's ring wraps at L.
    A DTensor cache (sharded over L on a mesh) takes the write as a select
    over its positions, which is local to every shard (DTensor has no
    rule for an index write)."""
    t = cache[key]
    L = t.shape[1]
    if is_dtensor(t):
        hit = torch.arange(L, device=t.device)[None, :] == (pos % L)[:, None]
        hit = hit.reshape(tuple(hit.shape) + (1,) * (t.ndim - 2))
        return t.copy_(torch.where(hit, value[:, None].to(t.dtype), t))
    bidx = torch.arange(t.shape[0], device=t.device)
    t[bidx, pos % L] = value.to(t.dtype)
    return t


def _embed(table, tokens):
    """``table[tokens]``; on a mesh, looked up on each rank's rows of the
    batch against the whole (gathered) table (DTensor's rule for the
    index's backward builds a global-size gradient)."""
    return local_map_batch(lambda t, e: e[t], [tokens], [table])


def _log_likelihood(logits, targets):
    """Each token's log-probability of its target, (B, S)."""
    lp = torch.log_softmax(logits, dim=-1)
    return torch.gather(lp, -1, targets[..., None])[..., 0]


def _residual(x, y):
    """``x + y`` on the residual stream.  On a mesh the sum is held at
    (batch, replicated) placements: a row-parallel projection's partial
    sum is all-reduced here, as GSPMD does, where DTensor would otherwise
    reduce-scatter it over the sequence at the next norm."""
    return shard(x + y, "batch", "seq", None)


def _heads(t, n: int, d: int):
    """(B, S, n * d) -> (B, S, n, d).  On a mesh the n * d dim stays sharded
    over the model axis only where n heads split evenly over it (DTensor
    cannot split a dim sharded unevenly; GSPMD regroups it silently)."""
    t = shard(t, "batch", "seq", "heads" if divides_model(n) else None)
    return t.reshape(t.shape[0], t.shape[1], n, d)


def _merge_heads(o):
    """(B, S, n, d) -> (B, S, n * d), held sharded over the model axis only
    where the n heads split evenly over it, so that the gradient's split
    back into heads is even too."""
    B, S, n, d = o.shape
    return shard(o.reshape(B, S, n * d), "batch", "seq", "heads" if divides_model(n) else None)


def _mla(p, h, cfg: ArchConfig, window: int, angles, cache, pos):
    """Multi-head latent attention (deepseek-v2): queries and keys of
    nope + rope widths, values of nope width.  The cache holds the latent
    ``ckv`` and the unrotated ``krope``, rotated by ``arange(Sk)`` at
    every step.  Returns the attention output (B, S, H * nope)."""
    B, S, _ = h.shape
    H, nope, rope = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = _heads(mm(mm(h, p["wq_a_rep"]), p["wq_b_colp"]), H, nope + rope)
    q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
    kv_a = mm(h, p["wkv_a_rep"])  # (B, S, kv_lora + rope)
    ckv, k_rope1 = torch.split(kv_a, [cfg.kv_lora_rank, rope], dim=-1)
    if cache is not None:
        # on a mesh the latent cache is gathered over its sequence shards to
        # meet the column-parallel up-projection
        ckv = shard(_write(cache, "ckv", pos, ckv[:, 0]), "batch", None, None)
        k_rope1 = shard(_write(cache, "krope", pos, k_rope1[:, 0]), "batch", None, None)
    Sk = ckv.shape[1]
    kv = _heads(mm(ckv, p["wkv_b_colp"]), H, 2 * nope)
    k_nope, v = torch.split(kv, [nope, nope], dim=-1)
    k_angles = angles
    if cache is not None:
        k_angles = rope_angles(torch.arange(Sk, device=h.device), rope, cfg.rope_theta)
    k_rope = rotate(k_rope1[:, :, None, :], k_angles)
    k = torch.cat([k_nope, k_rope.expand(B, Sk, H, rope)], dim=-1)
    q = torch.cat([q_nope, rotate(q_rope, angles)], dim=-1)
    if cache is not None:
        # on a mesh the per-step keys and values are sharded over the
        # sequence, as a cache is
        k, v = (shard(t, "batch", "seq_shard", None, None) for t in (k, v))
        o = attn_lib.decode_attention(q, k, v, pos, local_window=window,
                                      attn_softcap=cfg.attn_softcap)
    else:
        o = attn_lib.causal_attention(
            q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            local_window=window, attn_softcap=cfg.attn_softcap)
    return _merge_heads(o)


def apply_attn_layer(p, x, cfg: ArchConfig, kind: str, angles, cache=None, pos=None,
                     enc_out=None):
    """x: (B, S, D).  Train/prefill when cache is None; else single-token
    decode writing the cache at pos (B,).  ``angles``: ``rope_angles`` of
    the token positions (``pos[:, None]`` in decode) at the rotated width
    (``rope_head_dim`` under MLA), None without RoPE.  ``enc_out``: the
    encoder's output, attended to by a layer with cross-attention."""
    B, S, D = x.shape
    H, hd, KV = cfg.n_heads, cfg.hd, cfg.n_kv_heads
    window = cfg.local_window if kind == "local" else 0
    h = rms_norm(x, p["ln1_rep"], cfg.norm_eps)
    if cfg.use_mla:
        o = _mla(p, h, cfg, window, angles, cache, pos)
    else:
        kv_shard = not divides_model(H)  # 56 heads on an 8-way axis etc.
        q = _heads(mm(h, p["wq_colp"]), H, hd)
        k = _heads(mm(h, p["wk_colp"]), KV, hd)
        v = _heads(mm(h, p["wv_colp"]), KV, hd)
        q = shard(q, "batch", "seq", "heads", None)
        if cfg.rope:
            q = rotate(q, angles)
            k = rotate(k, angles)
        if cache is not None:
            length = cache["k"].shape[1]
            k_all, v_all = _write(cache, "k", pos, k[:, 0]), _write(cache, "v", pos, v[:, 0])
            # ring buffer: all slots valid once warm; the window equals the
            # buffer length, so the mask is the position's
            qpos = torch.clamp_max(pos, length - 1) if kind == "local" else pos
            o = attn_lib.decode_attention(q, k_all, v_all, qpos,
                                          local_window=0, attn_softcap=cfg.attn_softcap)
        else:
            o = attn_lib.causal_attention(
                q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                local_window=window, attn_softcap=cfg.attn_softcap, kv_shard=kv_shard)
        o = _merge_heads(o)
    # a bfloat16 residual plus a float32 attention output is float32, as in JAX
    x = _residual(x, mm(o, p["wo_rowp"]))
    if enc_out is not None and "xq_colp" in p:
        hx = rms_norm(x, p["ln_x_rep"], cfg.norm_eps)
        Se = enc_out.shape[1]
        xq = _heads(mm(hx, p["xq_colp"]), H, hd)
        xk = _heads(mm(enc_out, p["xk_colp"]), KV, hd)
        xv = _heads(mm(enc_out, p["xv_colp"]), KV, hd)
        xo = attn_lib.full_attention(xq, xk, xv, attn_softcap=cfg.attn_softcap)
        x = _residual(x, mm(_merge_heads(xo), p["xo_rowp"]))
    h2 = rms_norm(x, p["ln2_rep"], cfg.norm_eps)
    if cfg.n_experts:
        # blocked dispatch keeps training-scale routing shard-local; at
        # decode T is tiny (one token a row), so it routes globally
        nb = 1 if cache is not None else batch_shards()
        nb = nb if B % nb == 0 else 1  # dispatch blocks align to data shards
        x2d = h2.reshape(B * S, D)
        y = mlp_lib.moe(p["moe"], x2d, cfg, n_blocks=nb)
        if is_dtensor(y):  # back to the rows' layout, which (B, S) can unflatten
            y = y.redistribute(y.device_mesh, x2d.placements)
        y = y.reshape(B, S, D)
        if "mlp" in p:
            y = y + mlp_lib.mlp(p["mlp"], h2)
    else:
        y = mlp_lib.mlp(p["mlp"], h2)
    return _residual(x, y), cache


def _store(cache, **new):
    """Write new states into the cache's tensors (views of stacked ones)."""
    if cache is not None:
        for key, value in new.items():
            cache[key].copy_(value)
    return cache


def apply_rec_layer(p, x, cfg: ArchConfig, cache=None):
    h = rms_norm(x, p["ln1_rep"], cfg.norm_eps)
    hs = cache["h"] if cache is not None else None
    cs = cache["conv"] if cache is not None else None
    y, new_h, new_conv = rglru_lib.rglru_block(p["rglru"], h, cfg, hs, cs)
    x = _residual(x, y)
    h2 = rms_norm(x, p["ln2_rep"], cfg.norm_eps)
    x = _residual(x, mlp_lib.mlp(p["mlp"], h2))
    return x, _store(cache, h=new_h, conv=new_conv)


def apply_ssm_layer(p, x, cfg: ArchConfig, cache=None):
    h = rms_norm(x, p["ln1_rep"], cfg.norm_eps)
    st = cache["state"] if cache is not None else None
    cs = cache["conv"] if cache is not None else None
    y, new_state, new_conv = ssm_lib.ssm_block(p["ssm"], h, cfg, st, cs)
    return _residual(x, y), _store(cache, state=new_state, conv=new_conv)


def _apply_one(kind, p, x, cfg, angles, cache, pos, enc_out):
    if kind == "ssm":
        return apply_ssm_layer(p, x, cfg, cache)
    if kind == "rec":
        return apply_rec_layer(p, x, cfg, cache)
    return apply_attn_layer(p, x, cfg, kind, angles, cache, pos, enc_out)


# ----------------------------------------------------------- full model
def _run_layers(params, x, cfg: ArchConfig, positions, cache=None, pos=None,
                enc_out=None, remat: bool = False):
    pat = layer_pattern(cfg)
    plen = _plen(cfg)
    n_super = n_stacked(cfg)
    # every layer rotates by the same positions: the angles are computed
    # once here (JAX recomputes them per layer; the values are the same)
    angles = None
    if cfg.rope:
        dim = cfg.rope_head_dim if cfg.use_mla else cfg.hd
        angles = rope_angles(positions if cache is None else pos[:, None], dim,
                             cfg.rope_theta)

    def superblock(x, i):
        for j in range(plen):
            pj = tree_map(lambda t: t[i], params["blocks"][j])
            cj = None if cache is None else tree_map(lambda t: t[i], cache["blocks"][j])
            x, _ = _apply_one(pat[j], pj, x, cfg, angles, cj, pos, enc_out)
        return x

    def layer(x, i):
        ci = None if cache is None else cache["rem_blocks"][i]
        return _apply_one(pat[n_super * plen + i], params["rem_blocks"][i], x, cfg,
                          angles, ci, pos, enc_out)[0]

    def run(fn, x, i):
        return checkpoint(fn, x, i, use_reentrant=False) if remat else fn(x, i)

    for i in range(n_super if params["blocks"] else 0):
        x = run(superblock, x, i)
    for i in range(len(params["rem_blocks"])):
        x = run(layer, x, i)
    return x, cache


def encode(params, cfg: ArchConfig, frames):
    """Whisper encoder over (stubbed) frame embeddings (B, Se, D)."""
    Se = frames.shape[1]
    pe = sinusoidal_embed(torch.arange(Se, device=frames.device), cfg.d_model)
    x = frames + pe[None].to(frames.dtype)
    B, _, D = x.shape
    for p in params["encoder"]["blocks"]:
        h = rms_norm(x, p["ln1_rep"], cfg.norm_eps)
        q = _heads(mm(h, p["wq_colp"]), cfg.n_heads, cfg.hd)
        k = _heads(mm(h, p["wk_colp"]), cfg.n_kv_heads, cfg.hd)
        v = _heads(mm(h, p["wv_colp"]), cfg.n_kv_heads, cfg.hd)
        o = attn_lib.full_attention(q, k, v)
        x = _residual(x, mm(_merge_heads(o), p["wo_rowp"]))
        h2 = rms_norm(x, p["ln2_rep"], cfg.norm_eps)
        x = _residual(x, mlp_lib.mlp(p["mlp"], h2))
    return rms_norm(x, params["encoder"]["final_norm_rep"], cfg.norm_eps)


def _logits(params, cfg: ArchConfig, x):
    if cfg.tie_embeddings:
        logits = mm(x, params["embed_embed"].T)
    else:
        logits = mm(x, params["lm_head_colp"])
    return shard(softcap(logits.float(), cfg.final_softcap), "batch", "seq", "vocab")


def forward(params, cfg: ArchConfig, batch: dict, remat: bool = False):
    """Returns logits over the token positions of batch['tokens'] (audio:
    after encoding batch['frames']; vlm: after the batch['patches']
    prefix).  ``remat`` recomputes each layer's activations in the
    backward pass."""
    emb = params["embed_embed"]
    tokens = torch.as_tensor(batch["tokens"], device=emb.device)
    S = tokens.shape[1]
    x = shard(_embed(emb, tokens), "batch", "seq", None)
    enc_out = None
    n_prefix = 0
    if cfg.family == "audio":
        enc_out = encode(params, cfg, torch.as_tensor(batch["frames"], device=emb.device))
        pe = sinusoidal_embed(torch.arange(S, device=emb.device), cfg.d_model)
        x = x + pe[None].to(x.dtype)
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=emb.device)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        n_prefix = patches.shape[1]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=emb.device)
    x, _ = _run_layers(params, x, cfg, positions, enc_out=enc_out, remat=remat)
    x = rms_norm(x, params["final_norm_rep"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    return _logits(params, cfg, x)


def loss_fn(params, cfg: ArchConfig, batch: dict, remat: bool = True):
    """Mean next-token cross-entropy over batch['targets'], differentiable
    by autograd (``train/train_step.py``); ``remat`` as in ``forward``."""
    logits = forward(params, cfg, batch, remat=remat)
    targets = batch["targets"]
    if not is_dtensor(targets):
        targets = torch.as_tensor(targets, device=logits.device)
    # per row, as the lookup: DTensor's rule for the gather's backward
    # builds a global-size gradient of the logits
    return -local_map_batch(_log_likelihood, [logits, targets.long()]).mean()


def prefill(params, cfg: ArchConfig, batch: dict):
    """Prefill forward (no targets): returns last-position logits."""
    return forward(params, cfg, batch)[:, -1]


def serve_step(params, cfg: ArchConfig, cache: dict, tokens, pos):
    """One decode step: tokens (B, 1), pos (B,) -> (logits (B, V), cache).
    Audio attends to ``cache["enc_out"]`` (zeros unless the caller writes
    an encoding there)."""
    x = _embed(params["embed_embed"], tokens)
    enc_out = None
    if cfg.family == "audio":
        enc_out = cache["enc_out"]
        x = x + sinusoidal_embed(pos[:, None], cfg.d_model).to(x.dtype)
    x, cache = _run_layers(params, x, cfg, None, cache=cache, pos=pos, enc_out=enc_out)
    x = rms_norm(x, params["final_norm_rep"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
