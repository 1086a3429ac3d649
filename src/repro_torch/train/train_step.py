"""Microbatched train step (``repro.train.train_step``): gradient
accumulation, remat and the compression hook.

Each microbatch's gradients come from ``torch.autograd.grad`` through
``loss_fn(remat=True)``; with more than one microbatch they are added
into float32 buffers, as JAX's ``lax.scan`` adds them (bf16 ``.grad``
accumulation would round after every addition), and the mean is taken
at the end.  With one microbatch the gradients keep the parameters'
dtype, as JAX's do.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import transformer as T
from repro_torch.train import compress as C
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: OptConfig,
    n_micro: int = 1,
    use_compression: bool = False,
    donate: bool = True,
    as_fn: bool = False,
):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  batch['tokens'/'targets']: (B, S) with B divisible by
    n_micro; extra modality inputs (``frames``, ``patches``) are split
    across the microbatches too.  ``donate=True`` writes the new
    parameters, moments and error state into the given tensors (JAX's
    donated buffers) and returns them; ``donate=False`` leaves them
    unchanged.  ``as_fn`` is JAX's switch for jitting under explicit
    shardings and changes nothing here.  The metrics are 0-d tensors:
    ``loss``, ``grad_norm`` and ``lr``."""

    def grad_fn(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        loss = T.loss_fn(live, cfg, mb, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if n_micro == 1:
            loss, grads = grad_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grad_fn(params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g.div_(n_micro), grads)
            loss = loss / n_micro

        opt = {k: v for k, v in opt_state.items() if k != "err"}
        if use_compression:
            grads, new_err = C.compress_grads(grads, opt_state["err"])
            if donate:
                new_err = tree_map(lambda e, n: e.copy_(n), opt_state["err"], new_err)
        with torch.no_grad():
            new_params, new_opt, metrics = adamw_update(grads, opt, params, opt_cfg,
                                                        in_place=donate)
        if use_compression:
            new_opt["err"] = new_err
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def init_train_state(cfg: ArchConfig, opt_cfg: OptConfig, generator: torch.Generator,
                     use_compression: bool = False, device=None):
    """Parameters drawn from ``generator`` (``models/transformer.py::
    init_params``) on ``resolve_device(device)``, and their optimizer
    state (with the error-feedback residual when ``use_compression``)."""
    params = T.init_params(cfg, generator, device=resolve_device(device))
    opt_state = adamw_init(params, opt_cfg)
    if use_compression:
        opt_state["err"] = C.init_error_state(params)
    return params, opt_state
