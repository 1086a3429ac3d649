"""Feed-forward layers (``repro.models.mlp``): the SwiGLU MLP.

The JAX module's sort-based capacity MoE (``init_moe``, ``moe``) serves
the moe family, which comes with its own slice; here both raise.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import dense_init, mm

_MOE = ("the sort-based MoE dispatch is not ported yet "
        "(ROADMAP.md §1, *LM families*)")


def init_mlp(generator, d_model: int, d_ff: int, dtype, lead: tuple = ()):
    """``lead`` prefixes every shape (the stacked super-block axis)."""
    return dict(
        w_gate_colp=dense_init(generator, lead + (d_model, d_ff), dtype=dtype),
        w_up_colp=dense_init(generator, lead + (d_model, d_ff), dtype=dtype),
        w_down_rowp=dense_init(generator, lead + (d_ff, d_model), dtype=dtype),
    )


def mlp(params, x):
    h = F.silu(mm(x, params["w_gate_colp"])) * mm(x, params["w_up_colp"])
    return mm(h, params["w_down_rowp"])


def init_moe(*args, **kwargs):
    raise NotImplementedError(_MOE)


def moe(*args, **kwargs):
    raise NotImplementedError(_MOE)
