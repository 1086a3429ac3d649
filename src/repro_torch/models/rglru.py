"""RG-LRU recurrent block (``repro.models.rglru``; Griffin /
RecurrentGemma, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)
a_t = exp(-c · softplus(Λ) · r_t),  r/i = input-dependent sigmoid gates.

Prefill runs the recurrence as a sequential loop over the sequence (JAX
uses an associative scan; the sums come out in another order, within
1e-4); decode is the single-step recurrence.  The surrounding block is
Griffin's gated unit: out = W_out( GeLU(W_a x) ⊙ RGLRU(conv1d(W_b x)) ),
with JAX's default GeLU, the tanh approximation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, mm
from repro_torch.models.ssm import _causal_conv

C_FACTOR = 8.0


def init_rglru(generator, cfg, dtype, lead: tuple = ()):
    """``lead`` prefixes every shape (the stacked super-block axis)."""
    d = cfg.d_model
    w = cfg.rglru_width or d
    return dict(
        w_gate_colp=dense_init(generator, lead + (d, w), dtype=dtype),
        w_branch_colp=dense_init(generator, lead + (d, w), dtype=dtype),
        conv_rep=dense_init(generator, lead + (cfg.conv_kernel, w), dtype=dtype),
        w_r_rep=dense_init(generator, lead + (w, w), dtype=dtype),
        w_i_rep=dense_init(generator, lead + (w, w), dtype=dtype),
        lam_rep=torch.full(lead + (w,), 0.5, dtype=torch.float32, device=generator.device),
        w_out_rowp=dense_init(generator, lead + (w, d), dtype=dtype),
    )


def _gates(lam, r):
    """a_t and sqrt(1 - a_t^2) of the recurrence."""
    a = torch.exp(-C_FACTOR * F.softplus(lam)[None, None, :] * r)
    return a, torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))


def _rglru_scan(x, r, i, lam):
    """x, r, i: (B, S, W) float32.  Returns (y, final_h), from h = 0."""
    a, norm = _gates(lam, r)
    gated = norm * (i * x)
    h = torch.zeros_like(gated[:, 0])
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1)
    return y, y[:, -1]


def rglru_block(params, x, cfg, h_state=None, conv_state=None):
    """x: (B, S, D).  Decode when S == 1 with carried states.  Returns
    (out, new_h, new_conv_state)."""
    gate = F.gelu(mm(x, params["w_gate_colp"]), approximate="tanh")
    b = mm(x, params["w_branch_colp"])
    b, new_conv = _causal_conv(b, params["conv_rep"], conv_state)
    bf = b.float()
    r = torch.sigmoid(bf @ params["w_r_rep"].float())
    i = torch.sigmoid(bf @ params["w_i_rep"].float())
    if x.shape[1] > 1:
        y, new_h = _rglru_scan(bf, r, i, params["lam_rep"])
    else:
        a, norm = _gates(params["lam_rep"], r)
        y = a * h_state[:, None] + norm * (i * bf)
        new_h = y[:, 0]
    return mm(gate * y.to(x.dtype), params["w_out_rowp"]), new_h, new_conv
