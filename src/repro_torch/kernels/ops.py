"""Propagation backends: the physical plans behind one logical superstep.

A backend (``PropagateBackend``) owns its prepared graph data and exposes
one operation:

    propagate(sr, x, frontier=None) -> combined incoming messages (shape of x)

The engine holds one backend per named view and never branches on how
messages move.  Plans in this port:

  * ``coo``        — ``scatter_reduce`` over the destination-sorted COO view,
  * ``blocks_ref`` — the plain tile loop over block-sparse dense tiles,
  * ``cuda``       — the hand-written Hopper kernel (``frontier.py``) over
                     the packed layout of the same tiles (only the entries
                     that differ from the add-identity); on CPU tensors it
                     runs its plain version.

Sparsity gating: on the tile plans the frontier is pushed into the block
path.  A per-(dst block, slot) activity bitmap — the frontier reduced over
every lane, looked up per source block — lets the kernel skip dead tiles,
and the per-lane mask is applied inside visited tiles only.  ``gate=False``
restores the dense pre-mask as the baseline.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.graph import BlockSparse, Graph, PackedBlocks, pack_blocks
from repro_torch.core.semiring import BY_NAME, Semiring
from repro_torch.kernels import frontier, ref


# Backends of the JAX package that later slices port, with the title of the
# ROADMAP.md §1 queue item that carries each.
_NOT_PORTED = {"coo_gated": "Gated COO", "sharded": "Mesh mode"}


def block_activity(bs: Union[BlockSparse, PackedBlocks],
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(nb, max_bpr) bool — which adjacency tiles can contribute.  Reads
    only the slots (``src_ids``, ``nslots``), so it takes either layout.

    A tile is dead when it is a padding slot (k >= nslots[i]) or when its
    source block holds no active vertex in ANY lane (``mask`` reduced over
    every leading axis).  ``mask=None`` still gates padding slots.
    """
    nb, b, m = bs.num_dst_blocks, bs.block, bs.max_bpr
    dev = bs.src_ids.device
    valid = (torch.arange(m, dtype=torch.int32, device=dev)[None, :]
             < bs.nslots[:, None])
    if mask is None:
        return valid
    f = mask.reshape(-1, mask.shape[-1]).any(0)
    live = torch.zeros(nb * b, dtype=torch.bool, device=dev)
    live[: f.shape[0]] = f
    return valid & live.reshape(nb, b).any(-1)[bs.src_ids.long()]


class PropagateBackend:
    """Protocol: one physical plan for one propagation view."""

    name = "?"

    def propagate(self, sr: Semiring, x: torch.Tensor, frontier=None) -> torch.Tensor:
        raise NotImplementedError

    def export_tables(self):
        """Prepared per-semiring tile tables (``{sr.name: table}``, in the
        plan's layout), else None."""
        return None

    def refresh(self, graph: Graph, delta=None):
        raise NotImplementedError(
            "graph mutation is not ported yet: ROADMAP.md §1, *Mutable graphs*")

    def as_args(self, graph_carrier=None, *, slot_cap=None):
        raise NotImplementedError(
            "argument-carried editions are not ported yet: ROADMAP.md §1, *Mutable graphs*")

    def from_args(self, args):
        raise NotImplementedError(
            "argument-carried editions are not ported yet: ROADMAP.md §1, *Mutable graphs*")


class CooBackend(PropagateBackend):
    """``scatter_reduce`` over the destination-sorted COO view; the int64
    edge indices ``scatter_reduce`` needs are prepared once."""

    name = "coo"

    def __init__(self, graph: Graph):
        self.graph = graph
        self._src = graph.src.long()
        self._dst = graph.dst.long()

    def propagate(self, sr, x, frontier=None):
        g = self.graph
        return ref._coo(sr, x, frontier, self._src, self._dst, g.w, g.n)


class _TileBackend(PropagateBackend):
    """Shared plumbing for the block-sparse plans.

    The backend owns its tile tables per semiring (a table encodes exactly
    one add-identity).  ``tables`` may be one table (used for every
    semiring), a ``{sr.name: table}`` dict, or None; a given table is
    taken into the plan's layout by ``_adopt``, and missing entries are
    built by ``_build`` on the graph's device once and cached, unless
    ``strict``.
    """

    def __init__(self, graph: Graph, *, tables=None, block: int = 128,
                 gate: bool = True, strict: bool = False):
        self.graph = graph
        self.block = int(block)
        self.gate = bool(gate)
        self.strict = bool(strict)
        self._shared = None
        self.tables: dict = {}
        if isinstance(tables, dict):
            self.tables = {name: self._adopt(t, BY_NAME[name])
                           for name, t in tables.items()}
        elif tables is not None:
            self._shared = tables

    def _adopt(self, table, sr: Semiring):
        raise NotImplementedError

    def _build(self, sr: Semiring):
        raise NotImplementedError

    def table_for(self, sr: Semiring):
        t = self.tables.get(sr.name)
        if t is None:
            if self._shared is not None:
                t = self._adopt(self._shared, sr)
            elif self.strict:
                raise ValueError(
                    f"no block-sparse table for semiring '{sr.name}': build one "
                    "per semiring with Graph.to_blocks(block, sr.add_id) (or "
                    "Graph.to_packed_blocks for 'cuda')"
                )
            else:
                t = self._build(sr)
            self.tables[sr.name] = t
        return t

    def export_tables(self):
        return dict(self.tables) or self._shared

    def propagate(self, sr, x, frontier=None):
        bs = self.table_for(sr)
        flat = x.reshape(-1, x.shape[-1])
        mflat = None
        if frontier is not None:
            mflat = torch.broadcast_to(frontier, x.shape).reshape(flat.shape)
        if not self.gate:
            # dense baseline: pre-mask x over the full (C, V) slab and
            # visit every tile
            if mflat is not None:
                flat = torch.where(mflat, flat, sr.identity(x.dtype))
                mflat = None
            active = None
        else:
            active = block_activity(bs, mflat)
        out = self._run(bs, sr, flat, mflat, active)
        return out.reshape(x.shape)

    def _run(self, bs, sr, flat, mflat, active):
        raise NotImplementedError


class BlocksRefBackend(_TileBackend):
    """The plain tile loop over dense tiles, mirroring the JAX plan."""

    name = "blocks_ref"

    def _adopt(self, table, sr):
        if not isinstance(table, BlockSparse):
            raise TypeError(f"backend 'blocks_ref' takes dense BlockSparse tables, "
                            f"got {type(table).__name__}")
        return table

    def _build(self, sr):
        return self.graph.to_blocks(self.block, sr.add_id)

    def _run(self, bs, sr, flat, mflat, active):
        return ref.propagate_blocks_ref(bs, sr, flat, mask=mflat, active=active)


class CudaBackend(_TileBackend):
    """The hand-written Hopper kernel; in place of the JAX ``pallas`` plan.
    Its tables are packed (``PackedBlocks``): built from the edge list,
    packed once from a dense table it is given, or taken as they are from
    a ``{sr.name: PackedBlocks}`` dict (what ``export_tables`` returns and
    the store keeps).  It never builds a dense table itself."""

    name = "cuda"

    def __init__(self, graph: Graph, *, tables=None, **kw):
        if isinstance(tables, PackedBlocks):
            # a packed table holds one add-identity's entries: only a
            # semiring-keyed dict says which
            raise TypeError("backend 'cuda' takes packed tables as a "
                            "{sr.name: PackedBlocks} dict, not one shared table")
        super().__init__(graph, tables=tables, **kw)

    def _adopt(self, table, sr):
        if isinstance(table, PackedBlocks):
            if sr.reads_weight and table.w is None:
                raise ValueError(f"the packed table for '{sr.name}' holds no weights")
            return table
        if not isinstance(table, BlockSparse):
            raise TypeError(f"backend 'cuda' takes BlockSparse or PackedBlocks "
                            f"tables, got {type(table).__name__}")
        return pack_blocks(table, sr)

    def _build(self, sr):
        return self.graph.to_packed_blocks(self.block, sr)

    def _run(self, bs, sr, flat, mflat, active):
        return frontier.propagate_blocks(bs, sr, flat, mask=mflat, active=active)


class CallableBackend(PropagateBackend):
    """Adapter for a user-supplied ``(sr, x, frontier) -> y`` callable."""

    name = "callable"

    def __init__(self, fn):
        self.fn = fn

    def propagate(self, sr, x, frontier=None):
        return self.fn(sr, x, frontier)


def make_backend(
    spec: Union[str, PropagateBackend],
    graph: Graph,
    *,
    blocks: Optional[Union[BlockSparse, dict]] = None,
    block: int = 128,
    gate: bool = True,
    strict_tables: bool = False,
) -> PropagateBackend:
    """Resolve a backend spec to a ``PropagateBackend`` owning ``graph``.

    ``strict_tables`` forbids the tile plans from building missing tables
    (the functional path's honesty rule).
    """
    if isinstance(spec, PropagateBackend):
        return spec
    if spec == "coo":
        return CooBackend(graph)
    if spec == "pallas":
        raise ValueError(
            "backend 'pallas' is the JAX package's TPU kernel; the port's "
            "kernel-backed tile plan is 'cuda'"
        )
    if spec in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {spec!r} is not ported yet: ROADMAP.md §1, *{_NOT_PORTED[spec]}*")
    if spec in ("blocks_ref", "cuda"):
        if blocks is None and strict_tables:
            raise ValueError(
                f"backend '{spec}' needs a block-sparse adjacency: build one "
                "with Graph.to_blocks(block, sr.add_id) (or Graph.to_packed_blocks "
                "for 'cuda') and pass blocks="
            )
        cls = CudaBackend if spec == "cuda" else BlocksRefBackend
        return cls(graph, tables=blocks, block=block, gate=gate,
                   strict=strict_tables)
    raise ValueError(f"unknown propagation backend {spec!r}")


def propagate(
    graph: Graph,
    sr: Semiring,
    x: torch.Tensor,
    frontier_mask: Optional[torch.Tensor] = None,
    *,
    blocks: Optional[Union[BlockSparse, dict]] = None,
    backend: Union[str, PropagateBackend] = "coo",
    gate: bool = True,
) -> torch.Tensor:
    """One superstep of combined message propagation. x: (..., V).

    Functional convenience over :func:`make_backend`; tile plans refuse
    rather than build a table the caller did not pass.
    """
    be = make_backend(backend, graph, blocks=blocks, gate=gate,
                      strict_tables=True)
    return be.propagate(sr, x, frontier_mask)
