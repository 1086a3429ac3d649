"""Gradient compression: int8 quantization with error feedback
(``repro.train.compress``).

Gradients are quantized to int8 with a per-tensor absmax scale before
they would cross the data-parallel all-reduce, which quarters its bytes
against float32.  The quantization error is carried in a float32 residual
added to the next step's gradient (error feedback, Karimireddy et al.).
On one device the compression is applied to the gradients themselves, so
its numerics and convergence are what the tests hold.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.runtime import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor):
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_grads(grads, err_state):
    """Returns (decompressed grads as seen after the all-reduce, new error
    state)."""

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(err_state, [o[1] for o in out]))


def compressed_bytes(params) -> tuple[int, int]:
    """(uncompressed fp32 bytes, compressed int8+scale bytes) per all-reduce."""
    leaves = tree_leaves(params)
    return sum(p.numel() * 4 for p in leaves), sum(p.numel() + 4 for p in leaves)
