"""Quegel on PyTorch and CUDA: the port of the JAX package ``repro``.

The module tree mirrors ``src/repro/`` so each counterpart is found under
the same name.  The JAX package stays the reference; this package imports
neither it nor JAX.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    With no CUDA device and no explicit ``device="cpu"`` this raises rather
    than carrying on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev
