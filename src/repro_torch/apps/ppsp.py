"""PPSP (point-to-point shortest path) queries — paper §5.1.1.

BFS and bidirectional BFS vertex programs on unweighted graphs, batched over
the engine's C slots.  Distances are hop counts; the result is d(s, t) (INF
when unreachable).

Superstep numbering: the paper's superstep 1 only broadcasts from `s`; the
dense formulation fuses broadcast+receive, so superstep i here is the
paper's superstep i+1 (wavefront at distance i after round i).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import INF, MIN_RIGHT


def _sources(graph: Graph, v: torch.Tensor):
    """(A,) vertex ids -> ((A, V) int32 distances 0 at v else INF,
    (A, V) bool one-hot frontier at v)."""
    rows = torch.arange(v.shape[0], device=v.device)
    dist = torch.full((v.shape[0], graph.n), INF, dtype=torch.int32, device=v.device)
    dist[rows, v.long()] = 0
    hot = torch.zeros((v.shape[0], graph.n), dtype=torch.bool, device=v.device)
    hot[rows, v.long()] = True
    return dist, hot


def _visited(*dists) -> torch.Tensor:
    reached = dists[0] < INF
    for d in dists[1:]:
        reached = reached | (d < INF)
    return reached.sum(-1, dtype=torch.int32)


class BFSProgram(VertexProgram):
    """Forward BFS from s until t is reached (paper's simplest PPSP)."""

    def init(self, graph: Graph, query, index=None):
        dist, frontier = _sources(graph, query[:, 0])
        return dict(dist=dist, frontier=frontier)

    def superstep(self, state, ctx: StepCtx):
        dist, frontier = state["dist"], state["frontier"]
        t = ctx.query[:, 1].long()
        got = ctx.propagate(MIN_RIGHT, dist, frontier)
        newly = (got < INF) & (dist >= INF)
        dist = torch.where(newly, ctx.step[:, None], dist)
        reached_t = dist.gather(1, t[:, None])[:, 0] < INF  # force_terminate()
        done = reached_t | ~newly.any(-1)
        return dict(dist=dist, frontier=newly), done

    def frontier_of(self, state):
        return state["frontier"]

    def extract(self, state, query):
        t = query[:, 1].long()
        return dict(dist=state["dist"].gather(1, t[:, None])[:, 0],
                    visited=_visited(state["dist"]))


class BiBFSProgram(VertexProgram):
    """Bidirectional BFS (paper §5.1.1): forward from s on G, backward from
    t on G^R; stop when some vertex is bi-reached (or a frontier empties —
    the paper's aggregator-based early stop for small CCs)."""

    def init(self, graph: Graph, query, index=None):
        ds, ff = _sources(graph, query[:, 0])
        dt, fb = _sources(graph, query[:, 1])
        best = torch.full((query.shape[0],), INF, dtype=torch.int32,
                          device=query.device)
        return dict(ds=ds, dt=dt, ff=ff, fb=fb, best=best)

    def superstep(self, state, ctx: StepCtx):
        ds, dt = state["ds"], state["dt"]
        got_f = ctx.propagate(MIN_RIGHT, ds, state["ff"])
        got_b = ctx.propagate(MIN_RIGHT, dt, state["fb"], which="rev")
        new_f = (got_f < INF) & (ds >= INF)
        new_b = (got_b < INF) & (dt >= INF)
        step = ctx.step[:, None]
        ds = torch.where(new_f, step, ds)
        dt = torch.where(new_b, step, dt)
        both = torch.where((ds < INF) & (dt < INF), ds + dt, INF)
        best = torch.minimum(state["best"], both.amin(-1))
        bi_reached = best < INF
        dead = ~new_f.any(-1) | ~new_b.any(-1)  # a direction went silent
        done = bi_reached | dead
        return dict(ds=ds, dt=dt, ff=new_f, fb=new_b, best=best), done

    def frontier_of(self, state):
        return dict(ff=state["ff"], fb=state["fb"])

    def extract(self, state, query):
        return dict(dist=torch.clamp(state["best"], max=INF),
                    visited=_visited(state["ds"], state["dt"]))


def make_bibfs_engine(graph: Graph, capacity: int = 8, **kw):
    """Constructor wiring the reverse-graph view; tile backends build their
    per-semiring tables inside the engine."""
    return QuegelEngine(
        graph, BiBFSProgram(), capacity,
        aux_graphs={"rev": graph.reverse()},
        example_query=np.zeros((2,), np.int32),
        **kw,
    )


def make_bfs_engine(graph: Graph, capacity: int = 8, **kw):
    return QuegelEngine(
        graph, BFSProgram(), capacity,
        example_query=np.zeros((2,), np.int32),
        **kw,
    )
