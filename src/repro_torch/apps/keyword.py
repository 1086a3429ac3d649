"""Graph (RDF) keyword search — paper §5.5.

Query Q = {k_1..k_m} over a vertex-labeled graph; answers are rooted trees
(r, {<v_i, hop(r, v_i)>}) where v_i is the closest vertex to r matching
k_i, with hop <= delta_max.

Per-keyword hop distances flow along *reverse* edges (v learns about
matches reachable through its out-edges).  To return the witness vertex
ids, not just hops, each lane carries the encoding ``hop * N + vid`` whose
min is (min hop, then min id) — int32 min-plus with edge weight N on the
reversed graph (the paper's message ``<v_i, hop+1>``).  Each slot holds
MAXK such lanes, so a propagate moves MAXK * C lanes.

RDF adaptation (paper Fig. 8): literals and predicates are modeled as
ordinary vertices carrying their text, so the four RDF message cases
collapse to the vertex-text case.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import INF, MIN_PLUS

MAXK = 4  # max keywords per query (paper evaluates 2 and 3)


def make_vertex_text(n: int, vocab: int, tokens_per_vertex: int, seed: int = 0,
                     zipf: float = 1.3) -> np.ndarray:
    """Synthetic vertex text: (V, T) int32 token ids, Zipf-distributed
    (frequent words exist, like the paper's K_30 selection)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks**-zipf
    p /= p.sum()
    return rng.choice(vocab, size=(n, tokens_per_vertex), p=p).astype(np.int32)


class InvertedIndex:
    """The paper's per-worker inverted index (load2Idx): token -> matching
    vertices.  On the device it keeps the raw token table and resolves
    matches with a vectorized compare."""

    def __init__(self, tokens):
        self.tokens = (tokens if isinstance(tokens, torch.Tensor)
                       else torch.from_numpy(np.asarray(tokens, np.int32)))  # (V, T)

    def to(self, device) -> "InvertedIndex":
        return InvertedIndex(self.tokens.to(device))

    def match(self, keywords: torch.Tensor) -> torch.Tensor:
        """keywords (...) -> (..., V) bool: init_activate's vertex set of
        each keyword."""
        return (self.tokens == keywords[..., None, None]).any(-1)


class GraphKeywordSearch(VertexProgram):
    """state: enc (C, MAXK, V) int32 = hop * N + witness_id (INF when
    unknown).  A lane of an unused keyword slot (query padded with -1)
    stays INF and is ignored by the root predicate."""

    def __init__(self, rev_graph_n: int, delta_max: int = 3):
        self.delta_max = delta_max
        self.n_enc = rev_graph_n

    def init(self, graph: Graph, query, index: InvertedIndex = None):
        vids = torch.arange(graph.n, dtype=torch.int32, device=query.device)
        m = index.match(query) & (query >= 0)[..., None]
        enc = torch.where(m, vids, INF)  # hop 0, witness = self
        return dict(enc=enc, frontier=enc < INF)

    def superstep(self, state, ctx: StepCtx):
        enc = state["enc"]
        # reverse-edge propagation with weight N: hop+1, witness preserved
        got = ctx.propagate(MIN_PLUS, enc, state["frontier"], which="rev")
        improved = got < enc
        enc = torch.where(improved, got, enc)
        done = (ctx.step >= self.delta_max) | ~improved.flatten(1).any(-1)
        return dict(enc=enc, frontier=improved), done

    def frontier_of(self, state):
        return state["frontier"]

    def extract(self, state, query):
        enc = state["enc"]  # (C, MAXK, V)
        used = (query >= 0)[:, :, None]
        known = (enc < INF) | ~used
        is_root = known.all(1) & (enc < INF).any(1)
        hops = torch.where(used, enc // self.n_enc, 0)
        total = torch.where(is_root, hops.sum(1, dtype=torch.int32), INF)
        # stable, as jnp.argsort is: ties (common here) keep the lower id
        order = torch.argsort(total, dim=-1, stable=True)[:, :16]
        return dict(
            num_roots=is_root.sum(-1, dtype=torch.int32),
            top_roots=order.to(torch.int32),
            top_scores=total.gather(1, order),
            touched=(enc < INF).any(1).sum(-1, dtype=torch.int32),
        )


def make_keyword_engine(graph: Graph, tokens, capacity: int = 8,
                        delta_max: int = 3, **kw):
    """The reverse view carries weight N so min-plus transports hop*N+vid;
    propagation only ever flows along it."""
    rev = graph.reverse()
    rev_w = Graph(n=rev.n, n_real=rev.n_real, src=rev.src, dst=rev.dst,
                  w=torch.full_like(rev.w, rev.n), in_deg=rev.in_deg,
                  out_deg=rev.out_deg)
    return QuegelEngine(
        graph, GraphKeywordSearch(rev.n, delta_max), capacity,
        index=InvertedIndex(tokens),
        aux_graphs={"rev": rev_w},
        example_query=np.full((MAXK,), -1, np.int32),
        **kw,
    )
