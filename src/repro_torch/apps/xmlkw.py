"""XML keyword search — paper §5.2: SLCA, ELCA and MaxMatch semantics.

The XML document is a rooted tree; bitmaps bm(v)[i] ("keyword k_i occurs
in subtree T_v") flow bottom-up along child->parent edges.  Bitmap lanes
are 0/1 int32 planes so bitwise-OR combining is the MAX_RIGHT semiring.

Programs (batched over the slot axis; per-slot scalars are (C,)):
  SLCANaive        — every vertex whose bitmap changed forwards it (the
                     paper's first algorithm; a vertex may send more than
                     once).  MAXK + 1 lanes per slot.
  SLCALevelAligned — the paper's improved variant: an aggregator tracks
                     l_max and only vertices at the current level send, so
                     each vertex sends exactly once.  Computes ELCA labels
                     in the same pass (bm*_OR of non-all-one child
                     bitmaps).  2 * MAXK + 1 lanes per slot.
  MaxMatch         — phase 1 = level-aligned SLCA while recording each
                     vertex's set of child bitmap values (MAXK + 1 + 2^MAXK
                     lanes per slot); phase 2 = top-down propagation from
                     SLCA roots pruning dominated siblings (K(u1) ⊂ K(u2)).

Index: the inverted index (tokens table) gives init_activate's matching
vertices; levels l(v) are pre-computed V-data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.keyword import MAXK
from repro_torch.core.engine import QuegelEngine, StepCtx, VertexProgram
from repro_torch.core.graph import Graph
from repro_torch.core.semiring import MAX_RIGHT

NVALS = 1 << MAXK  # distinct bitmap values


@dataclasses.dataclass
class XMLIndex:
    tokens: torch.Tensor  # (V, T) int32 vertex text
    level: torch.Tensor  # (V,) int32 depth (root = 0; padding -1)
    parent: torch.Tensor  # (V,) int32, -1 at the root

    def to(self, device) -> "XMLIndex":
        return XMLIndex(self.tokens.to(device), self.level.to(device),
                        self.parent.to(device))

    def match(self, keywords: torch.Tensor) -> torch.Tensor:
        """keywords (...) -> (..., V) bool."""
        return (self.tokens == keywords[..., None, None]).any(-1)


def build_xml_index(parent: np.ndarray, tokens: np.ndarray, n_pad: int,
                    device=None) -> XMLIndex:
    """Levels from the parent array (parents precede children), padded to
    ``n_pad`` vertices; on the host, then moved to ``device`` (``cuda``
    unless the caller passes another)."""
    n = len(parent)
    level = np.zeros(n, np.int32)
    for v in range(1, n):
        level[v] = level[parent[v]] + 1
    pad = n_pad - n
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return XMLIndex(
        tokens=t(np.pad(tokens, ((0, pad), (0, 0)), constant_values=-2).astype(np.int32)),
        level=t(np.pad(level, (0, pad), constant_values=-1)),
        parent=t(np.pad(np.asarray(parent, np.int32), (0, pad), constant_values=-1)),
    )


def _init_bm(query, index: XMLIndex):
    """(A, MAXK, V) 0/1 int32 match planes."""
    return (index.match(query) & (query >= 0)[..., None]).to(torch.int32)


def _used(query):
    """(C, MAXK, 1) int32: which keyword slots the query uses."""
    return (query >= 0).to(torch.int32)[:, :, None]


def _allone(bm, used):
    """(C, V): every used keyword's bit is set (and the query has one)."""
    return ((bm >= 1) | (used == 0)).all(1) & (used.sum((1, 2)) > 0)[:, None]


def _level_max(matching, index: XMLIndex):
    """The aggregator's l_max per slot: the deepest matching vertex."""
    return torch.where(matching, index.level, -1).amax(-1)


class SLCANaive(VertexProgram):
    def init(self, graph: Graph, query, index: XMLIndex = None):
        bm = _init_bm(query, index)
        return dict(bm=bm, changed=(bm > 0).any(1),
                    got_allone_child=torch.zeros_like(bm[:, 0], dtype=torch.bool))

    def superstep(self, state, ctx: StepCtx):
        bm = state["bm"]
        allone = _allone(bm, _used(ctx.query))
        lanes = torch.cat([bm, allone[:, None].to(torch.int32)], 1)
        got = ctx.propagate(MAX_RIGHT, lanes, state["changed"][:, None, :])
        got = torch.clamp(got, min=0)
        new_bm = torch.maximum(bm, got[:, :MAXK])
        got_allone = state["got_allone_child"] | (got[:, MAXK] > 0)
        changed = (new_bm != bm).any(1)
        done = ~changed.any(-1)
        return dict(bm=new_bm, changed=changed, got_allone_child=got_allone), done

    def extract(self, state, query):
        slca = _allone(state["bm"], _used(query)) & ~state["got_allone_child"]
        return dict(slca=slca, num=slca.sum(-1, dtype=torch.int32))


class SLCALevelAligned(VertexProgram):
    """One send per vertex; also labels ELCAs.  l_max comes from the
    aggregator (a max-reduction at init) and decrements per step."""

    def init(self, graph: Graph, query, index: XMLIndex = None):
        bm = _init_bm(query, index)
        return dict(
            bm=bm,
            own=bm,  # init (own-text) bits, frozen — needed for ELCA
            got_allone_child=torch.zeros_like(bm[:, 0], dtype=torch.bool),
            elca_extra=torch.zeros_like(bm),
            lmax=_level_max((bm > 0).any(1), index),
        )

    def superstep(self, state, ctx: StepCtx):
        idx: XMLIndex = ctx.index
        bm, cur = state["bm"], state["lmax"]
        allone = _allone(bm, _used(ctx.query))
        senders = (idx.level == cur[:, None]) & (bm > 0).any(1)
        # lanes: bm, allone flag, bm masked to non-all-one senders (for ELCA)
        nao = torch.where(allone[:, None], 0, bm)
        lanes = torch.cat([bm, allone[:, None].to(torch.int32), nao], 1)
        got = torch.clamp(ctx.propagate(MAX_RIGHT, lanes, senders[:, None, :]), min=0)
        new_bm = torch.maximum(bm, got[:, :MAXK])
        got_allone = state["got_allone_child"] | (got[:, MAXK] > 0)
        elca_extra = torch.maximum(state["elca_extra"], got[:, MAXK + 1:])
        done = cur <= 0
        return dict(bm=new_bm, own=state["own"], got_allone_child=got_allone,
                    elca_extra=elca_extra, lmax=cur - 1), done

    def extract(self, state, query):
        used = _used(query)
        slca = _allone(state["bm"], used) & ~state["got_allone_child"]
        # ELCA (paper): bm*_OR = own bits (bm before its single update) OR
        # the non-all-one child subtree bitmaps; all-one => ELCA.
        elca = _allone(torch.maximum(state["own"], state["elca_extra"]), used)
        return dict(slca=slca, num=slca.sum(-1, dtype=torch.int32),
                    elca=elca, num_elca=elca.sum(-1, dtype=torch.int32))


class MaxMatch(VertexProgram):
    """Phase 1: level-aligned SLCA recording child bitmap values;
    phase 2: top-down labeling from SLCAs, pruning dominated siblings.
    Every superstep runs both phases' propagates (a slot keeps one)."""

    def init(self, graph: Graph, query, index: XMLIndex = None):
        bm = _init_bm(query, index)
        a, n = bm.shape[0], graph.n
        zeros = lambda: torch.zeros(a, dtype=torch.int32, device=bm.device)
        return dict(
            bm=bm,
            got_allone_child=torch.zeros((a, n), dtype=torch.bool, device=bm.device),
            child_vals=torch.zeros((a, NVALS, n), dtype=torch.int32, device=bm.device),
            lmax=_level_max((bm > 0).any(1), index),
            phase=zeros() + 1,
            labeled=torch.zeros((a, n), dtype=torch.bool, device=bm.device),
            cur_down=zeros(),
        )

    @staticmethod
    def _bmval(bm):
        weights = (1 << torch.arange(MAXK, dtype=torch.int32, device=bm.device))[:, None]
        return (bm * weights).sum(1, dtype=torch.int32)  # (C, V)

    def superstep(self, state, ctx: StepCtx):
        idx: XMLIndex = ctx.index
        used = _used(ctx.query)
        vals = torch.arange(NVALS, dtype=torch.int32, device=used.device)[:, None]

        # ---------------- phase 1: upward, level-aligned
        bm, cur = state["bm"], state["lmax"]
        allone = _allone(bm, used)
        senders = (idx.level == cur[:, None]) & (bm > 0).any(1)
        bmval = self._bmval(bm)
        onehot = (bmval[:, None, :] == vals).to(torch.int32)
        lanes = torch.cat([bm, allone[:, None].to(torch.int32), onehot], 1)
        got = torch.clamp(ctx.propagate(MAX_RIGHT, lanes, senders[:, None, :]), min=0)
        bm1 = torch.maximum(bm, got[:, :MAXK])
        got_allone1 = state["got_allone_child"] | (got[:, MAXK] > 0)
        child_vals1 = torch.maximum(state["child_vals"], got[:, MAXK + 1:])
        phase1_done = cur <= 0

        # ---------------- phase 2: downward from SLCAs
        slca = allone & ~state["got_allone_child"]
        # dominated(v): some sibling value b strictly contains bmval(v)
        myval = bmval[:, None, :]
        pa = torch.clamp(idx.parent, min=0).long()
        sib_vals = state["child_vals"][:, :, pa]  # (C, NVALS, V) present among siblings
        strict_sup = ((myval & vals) == myval) & (vals != myval)
        dominated = ((sib_vals > 0) & strict_sup).any(1) & (idx.parent >= 0)
        cur_down = state["cur_down"][:, None]
        down_senders = state["labeled"] & (idx.level == cur_down - 1)
        got_lab = ctx.propagate(MAX_RIGHT, state["labeled"].to(torch.int32)[:, None, :],
                                down_senders[:, None, :], which="down")[:, 0]
        labeled2 = state["labeled"] | ((idx.level == cur_down)
                                       & (slca | ((got_lab > 0) & ~dominated)))
        phase2_done = state["cur_down"] > idx.level.max()

        in_p1 = state["phase"] == 1
        p1 = in_p1[:, None]
        new_state = dict(
            bm=torch.where(p1[:, :, None], bm1, bm),
            got_allone_child=torch.where(p1, got_allone1, state["got_allone_child"]),
            child_vals=torch.where(p1[:, :, None], child_vals1, state["child_vals"]),
            lmax=torch.where(in_p1, cur - 1, cur),
            phase=torch.where(in_p1 & phase1_done, 2, state["phase"]),
            labeled=torch.where(p1, state["labeled"], labeled2),
            cur_down=torch.where(in_p1, 0, state["cur_down"] + 1),
        )
        return new_state, ~in_p1 & phase2_done

    def extract(self, state, query):
        return dict(labeled=state["labeled"],
                    num=state["labeled"].sum(-1, dtype=torch.int32))


def make_xml_engine(program_cls, up_graph: Graph, index: XMLIndex,
                    capacity: int = 8, **kw):
    """Every XML program propagates bitmap lanes under MAX_RIGHT, on the
    upward default view and (MaxMatch) the top-down 'down' view."""
    return QuegelEngine(
        up_graph, program_cls(), capacity, index=index,
        aux_graphs={"down": up_graph.reverse()},
        example_query=np.full((MAXK,), -1, np.int32),
        **kw,
    )
