"""P2P reachability queries — paper §5.4.

Pipeline (the paper's cascade of pre-processing jobs):
  1. SCC condensation: min-label forward/backward coloring (the Pregel
     algorithm of [36]) — queries on G reduce to queries on the DAG G'.
  2. DFS spanning forest pre/post orders (host-side, as the paper computes
     them outside Pregel via [42]).
  3. Three cascaded label jobs on the DAG:
       level  l(v) = longest #hops from any root           (max-plus)
       yes(v) = [pre(v), max_{u in Out(v)} pre(u)]         (max-right, rev)
       no(v)  = [min_{u in Out(v)} post(u), post(v)]       (min-right, rev)
  4. Query program: BiBFS with label pruning —
       yes(t) ⊆ yes(v)  on the forward frontier  => reachable, terminate;
       l(v) >= l(t) or no(t) ⊄ no(v)             => v votes to halt;
       symmetric rules on the backward frontier.

The label jobs and the device SCC coloring are fixpoints of the functional
``ops.propagate`` on the COO plan, as in the reference.  Each iteration
checks convergence on the host (one sync); the label fixpoints take the
longest path plus one iteration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import INF, MAX_PLUS, MAX_RIGHT, MIN_RIGHT
from repro_torch.kernels import ops


def _condensed(comp: np.ndarray, c: int, src: np.ndarray, dst: np.ndarray,
               device) -> Graph:
    """The DAG over ``c`` components: one edge per distinct (comp, comp)
    pair of distinct components."""
    s2, d2 = comp[src], comp[dst]
    keep = s2 != d2
    s2, d2 = s2[keep], d2[keep]
    _, kidx = np.unique(s2.astype(np.int64) * c + d2, return_index=True)
    return Graph.from_edges(s2[kidx], d2[kidx], c, device=device)


# --------------------------------------------------------------------- SCC
def scc_condense(graph: Graph):
    """SCC condensation (host, iterative Kosaraju) -> (scc_of, dag Graph).

    The paper treats SCC as an independent pre-computed job ([36]); the
    device-side FW-BW coloring (:func:`scc_condense_device`) is the Pregel
    formulation but converges slowly on chain-like graphs, so the host
    algorithm is the default pre-processing path.  The DAG lives on the
    graph's device.
    """
    n = graph.n_real
    src, dst, _ = graph._edges_np()
    mask = (src < n) & (dst < n)
    src, dst = src[mask], dst[mask]

    def csr(s, d):
        o = np.argsort(s, kind="stable")
        return np.searchsorted(s[o], np.arange(n + 1)), d[o]

    fs, fd = csr(src, dst)
    bs, bd = csr(dst, src)
    # pass 1: iterative DFS finish order
    visited = np.zeros(n, bool)
    finish = []
    for root in range(n):
        if visited[root]:
            continue
        stack = [(root, 0)]
        visited[root] = True
        while stack:
            v, i = stack.pop()
            nbrs = fd[fs[v]: fs[v + 1]]
            while i < len(nbrs) and visited[nbrs[i]]:
                i += 1
            if i < len(nbrs):
                stack.append((v, i + 1))
                u = nbrs[i]
                visited[u] = True
                stack.append((int(u), 0))
            else:
                finish.append(v)
    # pass 2: reverse DFS in decreasing finish order
    comp = np.full(n, -1, np.int32)
    c = 0
    for v in reversed(finish):
        if comp[v] >= 0:
            continue
        stack = [v]
        comp[v] = c
        while stack:
            u = stack.pop()
            for w in bd[bs[u]: bs[u + 1]]:
                if comp[w] < 0:
                    comp[w] = c
                    stack.append(int(w))
        c += 1
    return comp, _condensed(comp, c, src, dst, graph.device)


def _min_label_fixpoint(graph: Graph, x: torch.Tensor, live: torch.Tensor):
    """Propagate the min label within the live subgraph to a fixpoint."""
    while True:
        got = ops.propagate(graph, MIN_RIGHT, torch.where(live, x, INF))
        nx = torch.where(live & (got < x), got, x)
        if torch.equal(nx, x):
            return x
        x = nx


def scc_condense_device(graph: Graph, max_outer: int = 64):
    """Min-label FW-BW coloring on the graph's device (the Pregel variant).

    Each outer round: within the unassigned subgraph, propagate the min
    vertex id forward and backward to a fixpoint; vertices where the two
    labels agree form SCCs keyed by that label.  Returns (scc_of, dag).
    """
    n, dev = graph.n, graph.device
    rev = graph.reverse()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    assigned = torch.zeros(n, dtype=torch.bool, device=dev)
    assigned[graph.n_real:] = True
    scc = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for _ in range(max_outer):
        live = ~assigned
        if not bool(live.any()):
            break
        init = torch.where(live, ids, INF)
        f = _min_label_fixpoint(graph, init, live)
        b = _min_label_fixpoint(rev, init, live)
        hit = live & (f == b)
        scc = torch.where(hit, f, scc)
        assigned = assigned | hit
    # condense to the DAG (host)
    scc_np = scc.cpu().numpy()[: graph.n_real]
    uniq, inv = np.unique(scc_np, return_inverse=True)
    src, dst, _ = graph._edges_np()
    inv = inv.reshape(-1).astype(np.int32)
    return inv, _condensed(inv, len(uniq), src, dst, dev)


# ------------------------------------------------------------- DFS orders
def dfs_orders(dag: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Iterative DFS forest pre/post orders (host; the paper cites [42])."""
    n = dag.n_real
    src, dst, _ = dag._edges_np()
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    starts = np.searchsorted(src_s, np.arange(n + 1))
    pre = np.full(n, -1, np.int32)
    post = np.full(n, -1, np.int32)
    cpre = cpost = 0
    for root in range(n):
        if pre[root] >= 0:
            continue
        stack = [(root, iter(dst_s[starts[root]: starts[root + 1]]))]
        pre[root] = cpre
        cpre += 1
        while stack:
            v, it = stack[-1]
            advanced = False
            for u in it:
                if pre[u] < 0:
                    pre[u] = cpre
                    cpre += 1
                    stack.append((int(u), iter(dst_s[starts[u]: starts[u + 1]])))
                    advanced = True
                    break
            if not advanced:
                post[v] = cpost
                cpost += 1
                stack.pop()
    return pre, post


# ------------------------------------------------------------ label jobs
def _fixpoint(graph: Graph, sr, x: torch.Tensor) -> torch.Tensor:
    """x <- add(x, propagate(x)) until nothing changes."""
    while True:
        nx = sr.add(x, ops.propagate(graph, sr, x))
        if torch.equal(nx, x):
            return x
        x = nx


@dataclasses.dataclass
class ReachIndex:
    level: torch.Tensor  # (V,) int32
    pre: torch.Tensor  # (V,) int32
    yes_hi: torch.Tensor  # (V,) int32, max pre over Out(v)
    post: torch.Tensor  # (V,) int32
    no_lo: torch.Tensor  # (V,) int32, min post over Out(v)

    def to(self, device) -> "ReachIndex":
        return ReachIndex(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def build_reach_index(dag: Graph) -> ReachIndex:
    """DFS orders on the host, then the three label fixpoints on the DAG's
    device."""
    n, dev = dag.n, dag.device
    pre_np, post_np = dfs_orders(dag)
    t = lambda a: torch.from_numpy(
        np.pad(a, (0, n - len(a)), constant_values=0)).to(dev)
    pre, post = t(pre_np), t(post_np)
    rev = dag.reverse()
    # level: longest hops from a root, a max-plus fixpoint over forward edges
    level = _fixpoint(dag, MAX_PLUS, torch.zeros(n, dtype=torch.int32, device=dev))
    # yes-label hi: max pre over the reachable set (max-right, reverse edges)
    yes_hi = _fixpoint(rev, MAX_RIGHT, pre)
    # no-label lo: min post over the reachable set
    no_lo = _fixpoint(rev, MIN_RIGHT, post)
    return ReachIndex(level=level, pre=pre, yes_hi=yes_hi, post=post, no_lo=no_lo)


# ---------------------------------------------------------------- queries
class ReachQuery(VertexProgram):
    """(s, t) on the DAG; result reach ∈ {0, 1}."""

    def init(self, graph: Graph, query, index: ReachIndex = None):
        s, t = query[:, 0].long(), query[:, 1].long()
        a, n, dev = s.shape[0], graph.n, s.device
        rows = torch.arange(a, device=dev)
        ds = torch.full((a, n), INF, dtype=torch.int32, device=dev)
        dt = ds.clone()
        ds[rows, s] = 0
        dt[rows, t] = 0
        ff = torch.zeros((a, n), dtype=torch.bool, device=dev)
        fb = ff.clone()
        ff[rows, s] = True
        fb[rows, t] = True
        # immediate hits from labels: yes(t) ⊆ yes(s) => s reaches t
        yes_sub = (index.pre[s] <= index.pre[t]) & (index.yes_hi[t] <= index.yes_hi[s])
        return dict(ds=ds, dt=dt, ff=ff, fb=fb, reach=(s == t) | yes_sub)

    def superstep(self, state, ctx: StepCtx):
        idx: ReachIndex = ctx.index
        s, t = ctx.query[:, 0].long(), ctx.query[:, 1].long()
        at = lambda a, v: a[v][:, None]  # a label of s or t per slot, (C, 1)
        ds, dt = state["ds"], state["dt"]
        got_f = ctx.propagate(MIN_RIGHT, ds, state["ff"])
        got_b = ctx.propagate(MIN_RIGHT, dt, state["fb"], which="rev")
        new_f = (got_f < INF) & (ds >= INF)
        new_b = (got_b < INF) & (dt >= INF)
        step = ctx.step[:, None]
        ds = torch.where(new_f, step, ds)
        dt = torch.where(new_b, step, dt)
        # yes-label shortcut: any forward-reached v with yes(t) ⊆ yes(v)
        yes_f = new_f & (idx.pre <= at(idx.pre, t)) & (idx.yes_hi >= at(idx.yes_hi, t))
        yes_b = new_b & (at(idx.pre, s) <= idx.pre) & (at(idx.yes_hi, s) >= idx.yes_hi)
        bi = ((ds < INF) & (dt < INF)).any(-1)
        reach = state["reach"] | yes_f.any(-1) | yes_b.any(-1) | bi
        # pruning (vote to halt): level + no-label containment
        keep_f = ((idx.level < at(idx.level, t)) & (idx.no_lo <= at(idx.no_lo, t))
                  & (idx.post >= at(idx.post, t)))
        keep_b = ((idx.level > at(idx.level, s)) & (at(idx.no_lo, s) <= idx.no_lo)
                  & (at(idx.post, s) >= idx.post))
        ff = new_f & keep_f
        fb = new_b & keep_b
        done = reach | (~ff.any(-1) & ~fb.any(-1))
        return dict(ds=ds, dt=dt, ff=ff, fb=fb, reach=reach), done

    def frontier_of(self, state):
        return dict(ff=state["ff"], fb=state["fb"])

    def extract(self, state, query):
        visited = ((state["ds"] < INF) | (state["dt"] < INF)).sum(-1, dtype=torch.int32)
        return dict(reach=state["reach"], visited=visited)


def make_reach_engine(dag: Graph, index: ReachIndex, capacity: int = 8, **kw):
    return QuegelEngine(
        dag, ReachQuery(), capacity, index=index,
        aux_graphs={"rev": dag.reverse()},
        example_query=np.zeros((2,), np.int32),
        **kw,
    )
