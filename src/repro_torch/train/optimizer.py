"""AdamW with bf16 moments and the cosine schedule (``repro.train.optimizer``).

The arithmetic is the JAX package's, in float32: the global-norm clip
scale, the bias corrections, the moments ``m32``/``v32`` rounded to
``moment_dtype`` only when stored, and the new parameters cast back to
each parameter's own dtype.  Weight decay applies to every leaf with
``ndim >= 2``, as in JAX: under the stacked layout a norm scale is
``(n_super, d)`` and is decayed, while an unrolled one, ``(d,)``, is not.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.runtime import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "bfloat16"  # bf16 moments halve optimizer memory


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to 0 at ``total_steps``;
    a float32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))


def adamw_init(params, cfg: OptConfig) -> dict:
    md = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=md, device=p.device)
    return dict(step=torch.zeros((), dtype=torch.int32, device=dev),
                mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The float32 norm over every leaf, summed in ``tree_leaves`` order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def adamw_update(grads, opt_state, params, cfg: OptConfig, in_place: bool = False):
    """Returns (new_params, new_opt_state, metrics).  ``in_place`` writes
    the new parameters and moments into the given tensors (JAX's buffer
    donation) and returns them; otherwise the inputs are left unchanged."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    md = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        if in_place:
            return p.copy_(newp), m.copy_(m32), v.copy_(v32)
        return newp.to(p.dtype), m32.to(md), v32.to(md)

    out = [upd(*x) for x in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]))]
    new_params, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out])
                                  for i in range(3))
    return (new_params, dict(step=step, mu=new_mu, nu=new_nu),
            dict(grad_norm=gnorm, lr=lr))
