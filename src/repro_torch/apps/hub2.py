"""Hub²-Labeling for PPSP queries — paper §5.1.2.

The index: pick the k highest-degree vertices as hubs H.  Every vertex
keeps hub-distance labels L(v) = {<h, d(v,h)>} restricted to *core-hubs*
(hubs h with no other hub on any shortest v-h path); hubs keep labels to
all hubs.

As in the paper, **indexing is itself a Quegel job**: the query set is
{<h> | h in H}, each query a flagged BFS computing d(h, .) and the pre_H(.)
flag ("some shortest path from h passes another hub").  The engine batches
these k BFS queries C at a time under superstep-sharing.

Querying: d_ub = min_{h_s, h_t} d(s,h_s) + d(h_s,h_t) + d(h_t,t) from the
labels (folded into admission), then a BiBFS over the non-hub induced
subgraph with the early cutoff at superstep 1 + floor(d_ub / 2).

``load_or_build_hub_index`` boots the index from the durable store
(``core/store.py``) and builds it only on first use.
``maintain_hub_index`` carries the index across a graph mutation: with
the hub set fixed it re-labels only the hubs a delta can affect, or past
a threshold re-picks the hubs and re-labels them all, each time as the
same HubLabelBFS driven batched on the device through a propagation plan
(the ``cuda`` plan's kernel on spliced tables) rather than the engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import INF, MAX_RIGHT, MIN_RIGHT
from repro_torch.kernels import ops


@dataclasses.dataclass
class HubIndex:
    """The V-data index loaded before querying."""

    hub_ids: torch.Tensor  # (k,) int32 vertex ids of hubs
    is_hub: torch.Tensor  # (V,) bool
    hub_dist: torch.Tensor  # (k, V) int32 d(h, v), INF if unreachable
    core: torch.Tensor  # (k, V) bool — h is a core-hub of v (labels kept)

    @property
    def k(self) -> int:
        return int(self.hub_ids.shape[0])

    def hub_hub(self) -> torch.Tensor:
        """(k, k) pairwise hub distance matrix d(h_i, h_j)."""
        return self.hub_dist[:, self.hub_ids.long()]

    def to(self, device) -> "HubIndex":
        return HubIndex(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))


def pick_hubs(graph: Graph, k: int, mode: str = "degree") -> np.ndarray:
    """Top-k degree vertices (paper: in/out/sum for directed)."""
    if mode == "in":
        deg = graph.in_deg.cpu().numpy()
    elif mode == "out":
        deg = graph.out_deg.cpu().numpy()
    else:
        deg = graph.in_deg.cpu().numpy() + graph.out_deg.cpu().numpy()
    deg = deg[: graph.n_real]
    return np.argsort(-deg, kind="stable")[:k].astype(np.int32)


class HubLabelBFS(VertexProgram):
    """The indexing query <h>: BFS recording d(h, v) and pre_H(v).

    A vertex's outgoing flag is TRUE when a shortest path from h to it
    passes a hub other than h (itself counting if it is a hub) — receivers
    of a TRUE flag have h excluded from their core-hub set.
    """

    def __init__(self, is_hub: torch.Tensor):
        self.is_hub = is_hub

    def init(self, graph: Graph, query, index=None):
        h = query[:, 0].long()
        rows = torch.arange(h.shape[0], device=h.device)
        dist = torch.full((h.shape[0], graph.n), INF, dtype=torch.int32,
                          device=h.device)
        dist[rows, h] = 0
        frontier = torch.zeros((h.shape[0], graph.n), dtype=torch.bool,
                               device=h.device)
        frontier[rows, h] = True
        return dict(dist=dist, pre=torch.zeros_like(frontier), frontier=frontier)

    def superstep(self, state, ctx: StepCtx):
        dist, pre, frontier = state["dist"], state["pre"], state["frontier"]
        h = ctx.query[:, 0].long()
        # flag lane: a sender emits 1 iff it is a hub other than h, or its
        # own pre flag is set
        vid = torch.arange(dist.shape[1], device=dist.device)
        other_hub = self.is_hub.to(dist.device)[None, :] & (vid[None, :] != h[:, None])
        sender_flag = (other_hub | pre).to(torch.int32)
        got_d = ctx.propagate(MIN_RIGHT, dist, frontier)
        got_f = ctx.propagate(MAX_RIGHT, sender_flag, frontier)
        newly = (got_d < INF) & (dist >= INF)
        dist = torch.where(newly, ctx.step[:, None], dist)
        pre = pre | (newly & (got_f > 0))
        done = ~newly.any(-1)
        return dict(dist=dist, pre=pre, frontier=newly), done

    def frontier_of(self, state):
        return state["frontier"]

    def extract(self, state, query):
        return dict(dist=state["dist"], pre=state["pre"])


def build_hub_index(graph: Graph, k: int, capacity: int = 8,
                    backend: str = "coo", hubs=None, device=None,
                    **kw) -> HubIndex:
    """Run the |H| BFS queries through the engine and assemble the labels.

    HubLabelBFS mixes min_right (distance) and max_right (pre flag) on the
    same view; the tile plans build one table per semiring.  ``hubs`` pins
    an explicit hub set (default: ``pick_hubs(graph, k)``).
    """
    index, _ = _build_hub_index_counted(graph, k, capacity, backend, hubs=hubs,
                                        device=device, **kw)
    return index


def _build_hub_index_counted(graph: Graph, k: int, capacity: int = 8,
                             backend: str = "coo", hubs=None, device=None, **kw):
    """(HubIndex, engine rounds spent building) — the round count is what
    the store's zero-rebuild guarantee is asserted against."""
    dev = resolve_device(device)
    graph = graph.to(dev)
    hubs = pick_hubs(graph, k) if hubs is None else np.array(hubs, np.int32)
    is_hub_np = np.zeros(graph.n, dtype=bool)
    is_hub_np[hubs] = True
    is_hub = torch.from_numpy(is_hub_np).to(dev)
    eng = QuegelEngine(
        graph, HubLabelBFS(is_hub), capacity, backend=backend,
        example_query=np.zeros((1,), np.int32), device=dev, **kw,
    )
    qids = [eng.submit(np.asarray([h], np.int32)) for h in hubs]
    res = eng.run_until_drained()
    hub_dist = np.stack([np.asarray(res[q]["dist"]) for q in qids])  # (k, V)
    pre = np.stack([np.asarray(res[q]["pre"]) for q in qids])  # (k, V)
    # core-hub of v: reachable & no other hub on any shortest path; hubs
    # always keep all (reachable) hub labels
    core = (hub_dist < INF) & (~pre | is_hub_np[None, :])
    return HubIndex(
        hub_ids=torch.from_numpy(hubs).to(dev),
        is_hub=is_hub,
        hub_dist=torch.from_numpy(hub_dist).to(dev),
        core=torch.from_numpy(core).to(dev),
    ), eng.stats.rounds


def load_or_build_hub_index(store, graph: Graph, k: int, capacity: int = 8,
                            backend: str = "coo", name: str = "index",
                            device=None, **kw) -> tuple[HubIndex, dict]:
    """Boot the Hub² index from a durable store (``core/store.py``),
    building and persisting it only on first use.  Returns ``(index,
    info)`` with ``info = {built, index_rounds, graph_hash}`` —
    ``index_rounds`` is 0 on a store hit: restore is a load, not a
    rebuild.  The entry is bound to ``graph.content_hash()``: an entry
    written against another graph is rebuilt, never served."""
    ghash = graph.content_hash()
    m = store.manifest(name)
    if m is not None and m.get("meta", {}).get("graph_hash") == ghash:
        return store.get(name, device=device), {
            "built": False, "index_rounds": 0, "graph_hash": ghash}
    index, rounds = _build_hub_index_counted(graph, k, capacity, backend,
                                             device=device, **kw)
    store.put(name, index, meta={"graph_hash": ghash, "k": int(k)})
    return index, {"built": True, "index_rounds": int(rounds), "graph_hash": ghash}


# ------------------------------------------------ incremental maintenance
def _relabel_hubs(plan, is_hub: torch.Tensor, hub_ids: torch.Tensor, rows,
                  chunk: int = 256):
    """:class:`HubLabelBFS` for the ``rows`` hub queries over ``plan``'s
    graph, driven without the engine: ``chunk`` hubs at a time as one
    (chunk, V) frontier through ``plan.propagate``, every lane advancing
    each superstep (a finished lane's frontier is empty, so its rows stay
    put), one device->host sync per superstep.  The JAX package runs one
    host numpy BFS per hub; the rows are bit-identical.  Returns ``(dist,
    pre)``, (m, V) int32 and bool on the graph's device."""
    g = plan.graph
    dev = g.device
    hubs = hub_ids.to(dev)[torch.as_tensor(np.asarray(rows), device=dev).long()]
    prog = HubLabelBFS(is_hub.to(dev))
    propagate = lambda sr, x, frontier=None, which="default": plan.propagate(sr, x, frontier)
    dist_out = torch.empty((len(hubs), g.n), dtype=torch.int32, device=dev)
    pre_out = torch.empty((len(hubs), g.n), dtype=torch.bool, device=dev)
    for lo in range(0, len(hubs), chunk):
        q = hubs[lo:lo + chunk, None].to(torch.int32)
        st = prog.init(g, q)
        step = torch.zeros(len(q), dtype=torch.int32, device=dev)
        while True:
            step = step + 1
            st, _ = prog.superstep(st, StepCtx(g, q, step, propagate))
            if not bool(st["frontier"].any()):
                break
        dist_out[lo:lo + len(q)] = st["dist"]
        pre_out[lo:lo + len(q)] = st["pre"]
    return dist_out, pre_out


def affected_hubs(index: HubIndex, delta) -> np.ndarray:
    """Hub rows whose labels (dist or pre flags) can change under ``delta``.

    With ``d_h = hub_dist[h]`` on the PRE-mutation graph:

    * insert (u, v) affects h  iff  d_h[u] + 1 <= d_h[v] — strict ``<``
      shortens some distance; equality adds a shortest-path-DAG edge,
      which can only flip pre flags.
    * delete (u, v) affects h  iff  d_h[u] + 1 == d_h[v] — only edges on
      h's shortest-path DAG carry its BFS.

    Evaluated on the device over the delta's columns only, in int64 (INF
    + 1 never wraps).
    """
    hd = index.hub_dist
    aff = torch.zeros(hd.shape[0], dtype=torch.bool, device=hd.device)
    col = lambda a: hd[:, torch.as_tensor(np.asarray(a), device=hd.device).long()].long()
    if len(delta.add_src):
        aff |= (col(delta.add_src) + 1 <= col(delta.add_dst)).any(1)
    if len(delta.del_src):
        aff |= (col(delta.del_src) + 1 == col(delta.del_dst)).any(1)
    return np.nonzero(aff.cpu().numpy())[0]


def maintain_hub_index(graph: Graph, index: HubIndex, delta, *,
                       threshold: float = 0.01, capacity: int = 8,
                       backend: str = "coo", plan=None, chunk: int = 256, **kw):
    """Maintain a Hub² index across one ``Graph.apply_delta``.  Returns
    ``(new_index, info)``.

    Small deltas (``delta.size <= threshold * |E|``) take the incremental
    path: the hub set stays FIXED, only the rows ``affected_hubs`` names
    are re-labeled and ``core`` is recomputed for exactly those rows, into
    new arrays.  Past the threshold the hubs are re-picked from the new
    degrees and every row is re-labeled.  Both re-label through
    :func:`_relabel_hubs` over ``plan``, a propagation plan over
    ``graph`` (default ``ops.make_backend(backend, graph)``), ``chunk``
    hubs at a time; ``capacity`` is the JAX package's engine-rebuild slot
    count, accepted for its signature and unused here.

    Fixed-hub maintenance is sound — ``Hub2PPSP`` answers correctly under
    any hub set — but hub quality can drift; the rebuild threshold is
    also the quality backstop.  ``info``: mode ('incremental'|'rebuild'),
    k, frac (delta.size/|E|), affected_hubs (k on rebuild), threshold.
    """
    k = index.k
    frac = delta.size / max(1, graph.num_edges)
    base = dict(k=k, frac=float(frac), threshold=float(threshold))
    if plan is None:
        plan = ops.make_backend(backend, graph, block=kw.get("block", 128))
    dev = index.hub_dist.device

    def core_of(dist, pre, is_hub):
        return ((dist < INF) & (~pre | is_hub.to(pre.device)[None, :])).to(dev)

    if frac > threshold:
        hubs = pick_hubs(graph, k)
        is_hub = torch.zeros(graph.n, dtype=torch.bool, device=dev)
        is_hub[torch.from_numpy(hubs).to(dev).long()] = True
        hub_ids = torch.from_numpy(hubs).to(dev)
        dist, pre = _relabel_hubs(plan, is_hub, hub_ids, np.arange(k), chunk)
        return HubIndex(hub_ids=hub_ids, is_hub=is_hub, hub_dist=dist.to(dev),
                        core=core_of(dist, pre, is_hub)), dict(
            mode="rebuild", affected_hubs=k, **base)
    rows = affected_hubs(index, delta)
    if not len(rows):
        return index, dict(mode="incremental", affected_hubs=0, **base)
    dist_rows, pre_rows = _relabel_hubs(plan, index.is_hub, index.hub_ids, rows, chunk)
    r = torch.as_tensor(rows, device=dev).long()
    hub_dist = index.hub_dist.clone()
    core = index.core.clone()
    hub_dist[r] = dist_rows.to(dev)
    core[r] = core_of(dist_rows, pre_rows, index.is_hub)
    new_index = HubIndex(hub_ids=index.hub_ids, is_hub=index.is_hub,
                         hub_dist=hub_dist, core=core)
    return new_index, dict(mode="incremental", affected_hubs=int(len(rows)), **base)


def hub_index_updater(threshold: float = 0.01, capacity: int = 8,
                      backend: str = "coo", **kw):
    """Factory for ``QuegelEngine(index_fn=...)``: adapts
    :func:`maintain_hub_index` to the engine's maintainer protocol
    ``fn(new_graph, old_index, delta) -> (new_index, info)``.

    It keeps the propagation plan the re-labels run over and refreshes it
    with each delta (``PropagateBackend.refresh``: the ``cuda`` plan's
    tables spliced row by row) while the graphs it is given form a chain
    (``new_graph.parent_hash`` is its plan's content hash); otherwise it
    starts a new plan on ``new_graph``.  ``fn.state["plan"]`` is the plan
    of the last call."""
    state: dict = {}

    def fn(new_graph, old_index, delta):
        plan = state.get("plan")
        if plan is not None and plan.graph.content_hash() == new_graph.parent_hash:
            plan = plan.refresh(new_graph, delta)
        else:
            plan = ops.make_backend(backend, new_graph, block=kw.get("block", 128))
        state["plan"] = plan
        return maintain_hub_index(new_graph, old_index, delta, threshold=threshold,
                                  capacity=capacity, backend=backend, plan=plan, **kw)

    fn.state = state
    return fn


class Hub2PPSP(VertexProgram):
    """PPSP query using the Hub² index (paper's querying algorithm):
    BiBFS over the non-hub induced subgraph, upper-bounded by d_ub."""

    def init(self, graph: Graph, query, index: HubIndex = None):
        s, t = query[:, 0].long(), query[:, 1].long()
        lab_s = torch.where(index.core[:, s], index.hub_dist[:, s], INF).T  # (A, k)
        lab_t = torch.where(index.core[:, t], index.hub_dist[:, t], INF).T
        hh = index.hub_hub()  # (k, k)
        # d_ub = min_{hs,ht} d(s,hs) + d(hs,ht) + d(ht,t), summed in float32
        # exactly as the reference does (its sums stay exact below 2^24)
        tot = (
            torch.clamp(lab_s, max=INF)[:, :, None].to(torch.float32)
            + torch.clamp(hh, max=INF)[None].to(torch.float32)
            + torch.clamp(lab_t, max=INF)[:, None, :].to(torch.float32)
        )
        tmin = tot.amin((1, 2))
        d_ub = torch.where(tmin < INF, tmin, float(INF)).to(torch.int32)
        rows = torch.arange(s.shape[0], device=s.device)
        n = graph.n
        ds = torch.full((s.shape[0], n), INF, dtype=torch.int32, device=s.device)
        dt = ds.clone()
        ds[rows, s] = 0
        dt[rows, t] = 0
        ff = torch.zeros((s.shape[0], n), dtype=torch.bool, device=s.device)
        fb = ff.clone()
        ff[rows, s] = True
        fb[rows, t] = True
        bibest = torch.full_like(d_ub, INF)
        return dict(ds=ds, dt=dt, ff=ff, fb=fb, d_ub=d_ub, bibest=bibest)

    def superstep(self, state, ctx: StepCtx):
        is_hub = ctx.index.is_hub[None, :]
        ds, dt = state["ds"], state["dt"]
        got_f = ctx.propagate(MIN_RIGHT, ds, state["ff"])
        got_b = ctx.propagate(MIN_RIGHT, dt, state["fb"], which="rev")
        new_f = (got_f < INF) & (ds >= INF)
        new_b = (got_b < INF) & (dt >= INF)
        step = ctx.step[:, None]
        ds = torch.where(new_f, step, ds)
        dt = torch.where(new_b, step, dt)
        # hubs vote to halt immediately: BiBFS explores G[V - H]
        ff = new_f & ~is_hub
        fb = new_b & ~is_hub
        both = torch.where((ds < INF) & (dt < INF) & ~is_hub, ds + dt, INF)
        bibest = torch.minimum(state["bibest"], both.amin(-1))
        # early cutoff (paper): a non-hub vertex bi-reached at superstep
        # >= 1 + floor(d_ub/2) cannot beat d_ub
        cutoff = ctx.step >= 1 + state["d_ub"] // 2
        dead = ~ff.any(-1) | ~fb.any(-1)
        done = (bibest < INF) | cutoff | dead
        return dict(ds=ds, dt=dt, ff=ff, fb=fb, d_ub=state["d_ub"],
                    bibest=bibest), done

    def frontier_of(self, state):
        return dict(ff=state["ff"], fb=state["fb"])

    def extract(self, state, query):
        visited = ((state["ds"] < INF) | (state["dt"] < INF)).sum(-1, dtype=torch.int32)
        return dict(dist=torch.minimum(state["d_ub"], state["bibest"]),
                    visited=visited)


def make_hub2_engine(graph: Graph, index: HubIndex, capacity: int = 8, **kw):
    return QuegelEngine(
        graph, Hub2PPSP(), capacity, index=index,
        aux_graphs={"rev": graph.reverse()},
        example_query=np.zeros((2,), np.int32),
        **kw,
    )
