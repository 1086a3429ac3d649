"""Shared model components (``repro.models.common``): norms, RoPE, init.

Plain functions on tensors, computed in the JAX package's dtypes: norms
and rotary angles in float32, results cast back to the input's dtype.
The JAX module's logical-axis sharding helpers (``set_mesh``, ``shard``,
``param_spec``, ...) are GSPMD notions of the TPU mesh and wait for their
slice (ROADMAP.md §1, *TPU-mesh tooling*); on one device they are no-ops
in JAX, so the numbers here are the same.
"""
from __future__ import annotations

import math

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion: a bfloat16 x float32 product
    is computed and returned in float32 (torch's ``matmul`` wants one
    dtype, so the narrower operand is cast up)."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in the promoted dtype of both operands, as
    JAX's ``einsum`` takes mixed dtypes (torch's wants one)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope_angles(positions, dh: int, theta: float = 10000.0):
    """The (cos, sin) of RoPE's angles, (B|1, S, 1, Dh/2) float32, for
    positions (S,) or (B, S) int32: computed once, they serve every layer
    and both q and k."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None]  # (1, S)
    f = pos[:, :, None] * inv[None, None, :]  # (B|1, S, Dh/2)
    return torch.cos(f)[:, :, None, :], torch.sin(f)[:, :, None, :]


def rotate(x, angles):
    """RoPE with precomputed ``rope_angles``. x: (B, S, H, Dh)."""
    c, s = angles
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """RoPE computed on the fly (no table).

    x: (B, S, H, Dh); positions: (S,) or (B, S) int32."""
    return rotate(x, rope_angles(positions, x.shape[-1], theta))


def sinusoidal_embed(positions, d_model: int):
    """Whisper-style sinusoidal position embeddings. positions: (S,) or (B,S)."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16):
    """Normal x 1/sqrt(fan_in), drawn in float32 from ``generator`` on its
    device, then cast to ``dtype``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(std).to(dtype)  # in place: no second float32 copy
