"""Terrain shortest-path queries — paper §5.3.

The terrain substrate (``core.graph.grid_terrain``) is the paper's
transformed network: a DEM elevation mesh subdivided with per-cell
shortcut (diagonal) edges and 3D-Euclidean edge weights.

The query program is weighted SSSP (float32 min-plus relaxation) with the
paper's early-termination rule: track d_E^min, the least Euclidean
distance from s over the current wavefront (the aggregator); once
d_N(s, t) < d_E^min no later relaxation can improve d_N(s, t) (Euclidean
distance lower-bounds network distance), so t force-terminates.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import INF, MIN_PLUS

FINF = float(INF)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` with one rounding, from float64 parts.

    The product of two float32 values is exact in float64, but their sum
    with c can need more than 53 bits, and rounding to float64 then to
    float32 can then land one ulp off the single rounding.  The sum is
    rounded to odd in float64 instead (the error term of Knuth's TwoSum
    says which way to step when the rounded sum is inexact and even);
    53 >= 24 + 2 bits makes the rounding to float32 that follows the
    correctly rounded fma."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).double())
    return torch.where((err != 0) & even, step, s).float()


def euclidean(coords: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(A, V) float32 distances ``‖coords − coords[s]‖``, formed as XLA
    forms ``jnp.linalg.norm`` of a float32 (V, 3) row:
    ``sqrt(fma(z, z, fma(y, y, x * x)))`` in float32.

    Each fma is rounded once (:func:`_fma32`), and the square root is
    taken in float64 and rounded to float32, which is the correctly
    rounded float32 root (float32 ``torch.sqrt`` on an AVX-512 CPU is not
    correctly rounded).  ``torch.linalg.vector_norm`` gives XLA's values
    on the CPU but not on the H100 (4 % of them differ there), and the
    early-termination test reads them.  Shown equal to XLA's on the
    tested CPU inputs, and the card's equal to the host's in
    ``chip_smoke.py``.
    """
    d = coords[None, :, :] - coords[s][:, None, :]
    x, y, z = d.unbind(-1)
    acc = _fma32(z, z, _fma32(y, y, x * x))
    return torch.sqrt(acc.double()).float()


class TerrainSSSP(VertexProgram):
    """index = coords (V, 3) float32 vertex positions.

    The Euclidean distance from s is computed once at admission and kept
    in the state (``eu``), where the reference recomputes it every
    superstep (:func:`euclidean`).
    """

    def init(self, graph: Graph, query, index=None):
        s = query[:, 0].long()
        rows = torch.arange(s.shape[0], device=s.device)
        d = torch.full((s.shape[0], graph.n), FINF, dtype=torch.float32,
                       device=s.device)
        d[rows, s] = 0.0
        frontier = torch.zeros((s.shape[0], graph.n), dtype=torch.bool,
                               device=s.device)
        frontier[rows, s] = True
        eu = euclidean(index, s)
        return dict(d=d, frontier=frontier, eu=eu)

    def superstep(self, state, ctx: StepCtx):
        d, eu = state["d"], state["eu"]
        t = ctx.query[:, 1].long()
        got = ctx.propagate(MIN_PLUS, d, state["frontier"])
        improved = got < d
        d = torch.where(improved, got, d)
        # aggregator: least Euclidean distance from s over the new wavefront
        de_min = torch.where(improved, eu, FINF).amin(-1)
        early = d.gather(1, t[:, None])[:, 0] < de_min  # t calls force_terminate()
        done = early | ~improved.any(-1)
        return dict(d=d, frontier=improved, eu=eu), done

    def extract(self, state, query):
        t = query[:, 1].long()
        return dict(dist=state["d"].gather(1, t[:, None])[:, 0],
                    visited=(state["d"] < FINF).sum(-1, dtype=torch.int32))


def make_terrain_engine(graph: Graph, coords, capacity: int = 8, **kw):
    """``coords`` (V, 3) float32, numpy or a tensor."""
    return QuegelEngine(
        graph, TerrainSSSP(), capacity,
        index=(coords if isinstance(coords, torch.Tensor)
               else torch.from_numpy(np.asarray(coords, np.float32))),
        example_query=np.zeros((2,), np.int32),
        **kw,
    )
