"""Propagation backends: the physical plans behind one logical superstep.

A backend (``PropagateBackend``) owns its prepared graph data and exposes
one operation:

    propagate(sr, x, frontier=None) -> combined incoming messages (shape of x)

The engine holds one backend per named view and never branches on how
messages move.  Plans in this port:

  * ``coo``        — ``scatter_reduce`` over the destination-sorted COO view;
                     with ``gather_edges`` set it reduces over chunks of the
                     ACTIVE edge subset when a frontier is given,
  * ``coo_gated``  — the same with the active-edge gather always on,
  * ``blocks_ref`` — the plain tile loop over block-sparse dense tiles,
  * ``cuda``       — the hand-written Hopper kernel (``frontier.py``) over
                     the packed layout of the same tiles (only the entries
                     that differ from the add-identity); on CPU tensors it
                     runs its plain version,
  * ``sharded``    — edge partitions over a device mesh, one collective per
                     superstep (``core/distributed.py``; needs ``mesh=``).

Sparsity gating: on the tile plans the frontier is pushed into the block
path.  The frontier reduced over every lane and over each source block
says which tiles can contribute: ``blocks_ref`` gathers it into a
per-(dst block, slot) bitmap (``block_activity``, as the JAX plan does);
``cuda`` passes the (nb,) per-source-block table itself
(``frontier.block_live``, one launch) and the kernel looks it up per
entry.  The per-lane mask is applied inside visited tiles only.
``gate=False`` restores the dense pre-mask as the baseline.  A tile
plan's propagate spans the gate as ``quegel.gate`` and the plan's run
(for ``cuda``, the kernel's wrapper and launch) as ``quegel.kernel``
while a profiler records (``core/spans.py``).

Mutation: ``refresh(graph, delta)`` returns a new backend serving the
mutated graph (tile tables spliced row by row, the receiver untouched, so
older editions keep serving); ``as_args``/``from_args`` carry a plan's
arrays padded to fixed shapes; ``warm()`` does a plan's first-use work
(tables' device copies, the kernel's work items, int64 COO indices).
"""
from __future__ import annotations

import copy
import threading
from typing import Optional, Union

import torch

from repro_torch.core.graph import (BlockSparse, Graph, PackedBlocks, pack_blocks,
                                    pad_block_slots, pad_packed_slots)
from repro_torch.core.semiring import BY_NAME, Semiring
from repro_torch.core.spans import span
from repro_torch.kernels import frontier, ref


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

    def refresh(self, graph: Graph, delta=None) -> "PropagateBackend":
        """A new backend of the same plan serving ``graph``.

        ``delta`` is the ``EdgeDelta`` that produced ``graph`` from this
        backend's graph; plans with prepared tables splice them on the
        delta's touched rows rather than rebuild.  The receiver is left
        untouched: older editions keep serving in-flight slots."""
        raise NotImplementedError(f"backend '{self.name}' does not support graph mutation")

    def as_args(self, graph_carrier: Optional[Graph] = None, *,
                slot_cap: Optional[int] = None, entry_cap: Optional[int] = None):
        """This plan's prepared arrays padded to fixed shapes, for an
        argument-carried edition: ``graph_carrier`` is the engine's
        capacity-padded, lineage-stripped graph, ``slot_cap`` and
        ``entry_cap`` pad the tile tables' slot grid and packed entries.
        Plans whose arrays cannot be carried (user callables) refuse."""
        raise NotImplementedError(f"backend '{self.name}' cannot be argument-carried")

    def from_args(self, args) -> "PropagateBackend":
        """This plan rebound to the arrays of :meth:`as_args`; builds no
        table."""
        raise NotImplementedError(f"backend '{self.name}' cannot be argument-carried")

    def warm(self) -> None:
        """Do the plan's first-use work now (device copies, index arrays),
        so the first propagate after a mutation does none of it."""

    def arrays(self) -> list:
        """Every tensor the plan propagates over (its shapes say whether two
        editions are shape-identical)."""
        return []


class CooBackend(PropagateBackend):
    """``scatter_reduce`` over the destination-sorted COO view; the int64
    edge indices ``scatter_reduce`` needs are prepared once, at first use
    or by :meth:`warm`.

    With ``gather_edges`` set and a frontier given, reduces over chunks of
    that many ACTIVE edges through the graph's CSR view instead
    (``ref.propagate_coo_gated``: one extra device->host sync per call).
    """

    name = "coo"

    def __init__(self, graph: Graph, *, gather_edges: Optional[int] = None,
                 gate: bool = True):
        self.graph = graph
        self.gather_edges = gather_edges
        self.gate = bool(gate)
        self._idx = None

    def warm(self):
        if self._idx is None:
            self._idx = ref.coo_indices(self.graph)

    def propagate(self, sr, x, frontier=None):
        g = self.graph
        if self.gate and self.gather_edges and frontier is not None:
            return ref.propagate_coo_gated(g, sr, x, frontier, int(self.gather_edges))
        self.warm()
        return ref._coo(sr, x, frontier, *self._idx, g.n)

    def refresh(self, graph, delta=None):
        # no prepared state beyond the graph views, which Graph.apply_delta
        # already merged
        return CooBackend(graph, gather_edges=self.gather_edges, gate=self.gate)

    def as_args(self, graph_carrier=None, *, slot_cap=None, entry_cap=None):
        return {"graph": self.graph.carrier() if graph_carrier is None else graph_carrier}

    def from_args(self, args):
        return CooBackend(args["graph"], gather_edges=self.gather_edges, gate=self.gate)

    def arrays(self):
        g = self.graph
        return [g.src, g.dst, g.w] + (
            [g.csr_src, g.csr_dst, g.csr_w] if self.gather_edges else [])


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
        self._lock = threading.Lock()
        self.tables: dict = {}
        if isinstance(tables, dict):
            self.tables = {name: self._adopt(t, BY_NAME[name])
                           for name, t in tables.items()}
        elif tables is not None:
            self._shared = tables

    def _adopt(self, table, sr: Semiring):
        raise NotImplementedError

    def _build(self, sr: Semiring, graph: Graph):
        raise NotImplementedError

    def table_for(self, sr: Semiring):
        """The table for ``sr`` on the graph's device: built (unless
        ``strict``) or adopted at first use, and moved to the device at
        first use when a splice left it on the host.  Locked, so a
        background warm-up and a round never both do the work."""
        with self._lock:
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
                    t = self._build(sr, self.graph)
            t = t.to(self.graph.device)
            self.tables[sr.name] = t
            return t

    def export_tables(self):
        return dict(self.tables) or self._shared

    def _copy(self, graph: Graph, tables: dict, strict: bool) -> "_TileBackend":
        new = copy.copy(self)
        new.graph, new.tables, new.strict = graph, tables, strict
        new._shared, new._lock = None, threading.Lock()
        return new

    def _splice(self, graph: Graph, table, sr: Semiring, touched):
        raise NotImplementedError

    def refresh(self, graph, delta=None):
        """Carry every table to ``graph``: spliced on the delta's touched
        destination-block rows (``Graph.update_blocks`` /
        ``update_packed_blocks``), or rebuilt in full without a delta.  A
        one-table backend refuses: its add-identity is unknown."""
        if self._shared is not None:
            raise ValueError(
                "cannot refresh a shared single-table tile backend: the "
                "table's semiring (add_id) is unknown; construct with a "
                "{sr.name: table} dict instead")
        tables = {}
        for name, t in self.tables.items():
            sr = BY_NAME[name]
            tables[name] = (self._splice(graph, t, sr, delta.touched_dst_blocks(t.block))
                            if delta is not None else self._build(sr, graph))
        return self._copy(graph, tables, self.strict)

    def as_args(self, graph_carrier=None, *, slot_cap=None, entry_cap=None):
        if self._shared is not None:
            raise NotImplementedError(
                "cannot argument-carry a shared single-table tile backend: the "
                "table's semiring (add_id) is unknown, so the slot padding fill "
                "would be a guess")
        return {"tables": {name: self._pad(self.table_for(BY_NAME[name]),
                                           BY_NAME[name], slot_cap, entry_cap)
                           for name in list(self.tables)}}

    def _pad(self, table, sr, slot_cap, entry_cap):
        raise NotImplementedError

    def from_args(self, args):
        # a table missing from the carrier must fail loudly, never be built
        # from a graph this copy does not propagate over
        return self._copy(self.graph, dict(args["tables"]), True)

    def warm(self):
        for name in list(self.tables):
            self.table_for(BY_NAME[name])

    def arrays(self):
        return [a for t in self.tables.values() for a in _table_arrays(t)]

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
            gate = {}
        else:
            with span("quegel.gate"):
                gate = self._gate(bs, mflat)
        with span("quegel.kernel"):
            out = self._run(bs, sr, flat, mflat, **gate)
        return out.reshape(x.shape)

    def _gate(self, bs, mflat) -> dict:
        """The plan's gating operands for ``_run``, from the (Q, V) mask."""
        raise NotImplementedError

    def _run(self, bs, sr, flat, mflat, **gate):
        raise NotImplementedError


class BlocksRefBackend(_TileBackend):
    """The plain tile loop over dense tiles, mirroring the JAX plan."""

    name = "blocks_ref"

    def _adopt(self, table, sr):
        if not isinstance(table, BlockSparse):
            raise TypeError(f"backend 'blocks_ref' takes dense BlockSparse tables, "
                            f"got {type(table).__name__}")
        return table

    def _build(self, sr, graph):
        return graph.to_blocks(self.block, sr.add_id)

    def _splice(self, graph, table, sr, touched):
        return graph.update_blocks(table, sr.add_id, touched)

    def _pad(self, table, sr, slot_cap, entry_cap):
        return pad_block_slots(table, int(slot_cap), sr.add_id) if slot_cap else table

    def _gate(self, bs, mflat):
        return {"active": block_activity(bs, mflat)}

    def _run(self, bs, sr, flat, mflat, active=None):
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

    def _build(self, sr, graph):
        return graph.to_packed_blocks(self.block, sr)

    def _splice(self, graph, table, sr, touched):
        # on the host mirrors; the device copy is first-use work (warm)
        return graph.update_packed_blocks(table, sr, touched, device="cpu")

    def _pad(self, table, sr, slot_cap, entry_cap):
        if not (slot_cap or entry_cap):
            return table
        return pad_packed_slots(table, int(slot_cap or table.max_bpr),
                                int(entry_cap or table.entries.numel()))

    def warm(self):
        super().warm()
        if self.graph.device.type == "cuda":
            chunk = frontier.work_chunk()
            for t in list(self.tables.values()):
                t.work_items(chunk)

    def _gate(self, bs, mflat):
        # entries never name a padding slot, so without a mask there is
        # nothing to gate
        if mflat is None:
            return {}
        return {"live": frontier.block_live(mflat, bs.num_dst_blocks, bs.block)}

    def _run(self, bs, sr, flat, mflat, live=None):
        return frontier.propagate_blocks(bs, sr, flat, mask=mflat, live=live)


def _table_arrays(t) -> list:
    if isinstance(t, PackedBlocks):
        return [a for a in (t.src_ids, t.nslots, t.row_ptr, t.entries, t.w) if a is not None]
    return [t.src_ids, t.tiles, t.nslots]


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
    gather_edges: Optional[int] = None,
    strict_tables: bool = False,
    mesh=None,
    mesh_axis: Optional[str] = None,
    partition: str = "dst",
) -> PropagateBackend:
    """Resolve a backend spec to a ``PropagateBackend`` owning ``graph``.

    ``strict_tables`` forbids the tile plans from building missing tables
    (the functional path's honesty rule).  ``gather_edges`` is the gated
    COO chunk (``coo``; ``coo_gated`` defaults it to 512).  ``sharded``
    partitions the edges over ``mesh_axis`` of ``mesh`` (default: its last
    axis) by ``partition``.
    """
    if isinstance(spec, PropagateBackend):
        return spec
    if spec == "coo":
        return CooBackend(graph, gather_edges=gather_edges, gate=gate)
    if spec == "coo_gated":
        return CooBackend(graph, gather_edges=int(gather_edges or 512), gate=True)
    if spec == "pallas":
        raise ValueError(
            "backend 'pallas' is the JAX package's TPU kernel; the port's "
            "kernel-backed tile plan is 'cuda'"
        )
    if spec == "sharded":
        if mesh is None:
            raise ValueError(
                "backend 'sharded' needs mesh= (a DeviceMesh whose shard axis "
                "divides |V|; see Graph.padded)")
        from repro_torch.core.distributed import ShardedBackend, ShardedGraph, mesh_axis_info

        axis = mesh_axis or mesh.mesh_dim_names[-1]
        n_parts = mesh_axis_info(mesh, axis)[1]
        return ShardedBackend(ShardedGraph(graph, n_parts, partition=partition),
                              mesh, axis)
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
    gather_edges: Optional[int] = None,
) -> torch.Tensor:
    """One superstep of combined message propagation. x: (..., V).

    Functional convenience over :func:`make_backend`; tile plans refuse
    rather than build a table the caller did not pass.  ``gather_edges``
    (coo) reduces over chunks of the active-edge subset when a frontier
    is given.
    """
    be = make_backend(backend, graph, blocks=blocks, gate=gate,
                      gather_edges=gather_edges, strict_tables=True)
    return be.propagate(sr, x, frontier_mask)
