"""Mamba2 SSD block (``repro.models.ssm``), state-space duality,
arXiv:2405.21060.

Chunked SSD: the sequence is split into chunks; within a chunk the dual
quadratic (attention-like) form runs as einsums, and chunk-final states
pass through a sequential recurrence over chunks (JAX's ``lax.scan``, a
Python loop here) with a carried (H, P, N) state per batch row.  Decode
is the pure recurrence h = dA * h + dt * B ⊗ x.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, mm, rms_norm


def _segsum(x):
    """(..., L) -> (..., L, L) lower-triangular inclusive segment sums."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def init_ssm(generator, cfg, dtype, lead: tuple = ()):
    """``lead`` prefixes every shape (the stacked super-block axis)."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    n = cfg.ssm_state
    dev = generator.device

    def const(size, value):
        return torch.full(lead + (size,), value, dtype=torch.float32, device=dev)

    return dict(
        w_in_colp=dense_init(generator, lead + (d, 2 * din + 2 * n + nh), dtype=dtype),
        conv_rep=dense_init(generator, lead + (cfg.conv_kernel, din + 2 * n), dtype=dtype),
        a_log_rep=const(nh, 0.0),
        d_skip_rep=const(nh, 1.0),
        dt_bias_rep=const(nh, 0.0),
        norm_rep=const(din, 0.0),
        w_out_rowp=dense_init(generator, lead + (din, d), dtype=dtype),
    )


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: (B, S, C), w: (K, C).
    Returns (y, new_state) where state is the last K-1 inputs."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        dt = torch.promote_types(state.dtype, x.dtype)
        xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    S = x.shape[1]
    ys = sum(xp[:, i : i + S] * w[i][None, None, :] for i in range(K))
    return F.silu(ys), xp[:, -(K - 1):]


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD over chunks.  x: (b, s, h, p); dt: (b, s, h); A: (h,);
    B, C: (b, s, n).  Returns (y, final_state (b, h, p, n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    dA = dtc * (-torch.exp(A))[None, None, None, :]  # (b,nc,l,h) negative

    # intra-chunk (dual quadratic form)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (b,nc,h,l,l)
    scores = torch.einsum("bcln,bcmn->bclm", Cc, Bc)  # (b,nc,l,l)
    M = scores[:, :, None] * L  # (b,nc,h,l,l)
    y_diag = torch.einsum("bchlm,bcmh,bcmhp->bclhp", M, dtc, xc)

    # chunk-final states
    dA_cum = torch.cumsum(dA, dim=2)  # (b,nc,l,h)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,nc,l,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, dtc * decay_to_end, xc)

    # inter-chunk recurrence over chunk boundaries: the state entering
    # each chunk, then the final one
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (b,nc,h,p,n)

    # contribution of the entering state to each position
    in_decay = torch.exp(dA_cum)  # (b,nc,l,h)
    y_off = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, in_decay, entering)
    return (y_diag + y_off).reshape(b, s, h, p), carry


def ssm_block(params, x, cfg, state=None, conv_state=None):
    """Full Mamba2 block.  Train/prefill (S > 1): chunked SSD from a zero
    state.  Decode: x (B, 1, D) with the carried (state, conv_state).
    Returns (out, new_state, new_conv_state)."""
    b, s, d = x.shape
    din = cfg.ssm_expand * d
    nh = din // cfg.ssm_head_dim
    n = cfg.ssm_state
    zxbcdt = mm(x, params["w_in_colp"])
    z, xs, B, C, dt = torch.split(zxbcdt, [din, din, n, n, nh], dim=-1)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, params["conv_rep"], conv_state)
    xs, B, C = torch.split(conv_out, [din, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias_rep"])  # (b,s,nh)
    xh = xs.reshape(b, s, nh, cfg.ssm_head_dim)
    A = params["a_log_rep"]

    if s > 1:
        # pad after the softplus, so a padded step has dt = 0: it neither
        # decays nor feeds the state
        pad = (-s) % cfg.ssm_chunk

        def padded(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) if pad else t

        y, new_state = ssd_chunked(padded(xh).float(), padded(dt), A,
                                   padded(B).float(), padded(C).float(), cfg.ssm_chunk)
        y = y[:, :s]
    else:  # decode recurrence
        dt0 = dt[:, 0]
        dA = torch.exp(dt0 * (-torch.exp(A))[None, :])  # (b,nh)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt0, B[:, 0].float(), xh[:, 0].float())
        new_state = state * dA[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), new_state)[:, None]

    y = y + xh.float() * params["d_skip_rep"][None, None, :, None]
    y = y.reshape(b, s, din)
    y = rms_norm(y * F.silu(z.float()), params["norm_rep"])
    return mm(y.to(x.dtype), params["w_out_rowp"]), new_state, new_conv
