"""The yardstick for a propagate call: the bytes its work needs, and the
chip's peaks.

The count depends on the work, not on the layout a backend keeps, so a
later kernel is read against the same bound.  For one call
``propagate(sr, x (Q, V), frontier (Q, V) bool)`` over a view whose arcs
run source -> destination, each input read once and the output written
once:

* every arc whose source is active in at least one lane: its source and
  destination index (int32 each) and, where the semiring reads it, its
  weight (``x``'s element size);
* ``x`` once for each (lane, active source);
* the frontier once (one byte a lane and vertex);
* the dense ``(Q, V)`` output once.

A call without a frontier has every source active in every lane.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

INDEX_BYTES = 4
WEIGHTED = frozenset({"min_plus", "max_plus", "sum_times"})
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def propagate_bytes(out_deg: torch.Tensor, semiring: str, x: torch.Tensor,
                    frontier: Optional[torch.Tensor]) -> torch.Tensor:
    """The call's bytes as an int64 scalar on ``x``'s device (no sync).

    ``out_deg`` (V,) is each vertex's out-degree in the propagated view.
    """
    flat = x.reshape(-1, x.shape[-1])
    q, v = flat.shape
    elem = x.element_size()
    arc_bytes = 2 * INDEX_BYTES + (elem if semiring in WEIGHTED else 0)
    if frontier is None:
        arcs = out_deg.sum(dtype=torch.int64)
        pairs = torch.tensor(q * v, dtype=torch.int64, device=x.device)
        frontier_bytes = 0
    else:
        f = torch.broadcast_to(frontier, x.shape).reshape(q, v)
        arcs = (out_deg.to(torch.int64) * f.any(0)).sum()
        pairs = f.sum(dtype=torch.int64)
        frontier_bytes = q * v
    return arcs * arc_bytes + pairs * elem + (frontier_bytes + q * v * elem)


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the device named ``kind``, if tabled."""
    return json.loads(PEAKS.read_text()).get(kind)
