"""Distributed frontier propagation over ``torch.distributed``: Quegel's
worker partitioning mapped onto a ``DeviceMesh`` (the counterpart of the
JAX package's ``core/distributed.py``).

Quegel hash-partitions vertices across workers and routes point-to-point
messages.  On a mesh we partition *edges* and replace routing with one
collective per superstep:

  partition="dst" (default) — each rank owns a contiguous destination
      block; it combines messages for its block from the (replicated)
      frontier values, then the blocks are all-gathered.  Collective bytes
      per superstep: |V| * C * dtype (an all-gather of the result).
      Combining happens before any data crosses the interconnect.

  partition="src" — each rank owns a source block and produces a dense
      partial combine for *all* destinations; partials are reduced with a
      MIN/MAX/SUM all-reduce.  More collective bytes (~2x for a ring
      all-reduce) but immune to destination-degree skew (the paper's hub
      problem).

Both paths give the single-device reference's results (float ``sum_times``
to rounding: the partials are added in another order).

The JAX package runs one controller over a mesh of devices; here every
rank is a process of its own (``launch/mesh.py`` builds the mesh over an
initialised process group).  ``ShardedGraph`` holds the edge partitions
of every rank on the host, as numpy builds them; ``ShardedBackend`` keeps
only its own rank's row on the device, sliced to its valid prefix, and
``propagate`` takes the replicated (..., V) value and ends in the one
collective on the mesh axis's process group.  ``make_local`` is the same
closure over explicit partition arrays, which is what the engine's SPMD
round (``core/engine.py``) runs inside each superstep.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.graph import Graph
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.ops import PropagateBackend


def _pad_partition(src, dst, w, n_parts, key):
    """Split COO edges into n_parts buckets by the per-edge ``key`` array,
    padding every bucket to the max bucket size.

    Vectorized: one stable argsort groups edges by bucket (preserving the
    original within-bucket edge order, so segment reductions see the same
    operand order as the single-device reference) and one bincount sizes
    the padding — no Python loop over E.
    """
    key = np.asarray(key)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_parts)
    need = int(max(1, counts.max())) if counts.size else 1
    # ~25% headroom (at least 4 rows' worth): ShardedGraph.apply_delta
    # splices mutated rows IN PLACE as long as they fit Emax, so an
    # in-capacity mutation keeps every partition's shape
    emax = need + max(4, need // 4)
    rows = key[order]
    starts = np.concatenate(([0], np.cumsum(counts)))
    cols = np.arange(len(order)) - starts[rows]
    srcp = np.zeros((n_parts, emax), np.int32)
    dstp = np.zeros((n_parts, emax), np.int32)
    wp = np.zeros((n_parts, emax), w.dtype)
    valid = np.zeros((n_parts, emax), bool)
    srcp[rows, cols] = src[order]
    dstp[rows, cols] = dst[order]
    wp[rows, cols] = w[order]
    valid[rows, cols] = True
    return srcp, dstp, wp, valid


class ShardedGraph:
    """Edge partitions of a Graph for a mesh axis of size n_parts: the
    (n_parts, Emax) arrays ``srcp``, ``dstp``, ``wp`` and ``valid`` as CPU
    tensors over numpy's buffers (each row's valid entries are a prefix)."""

    def __init__(self, graph: Graph, n_parts: int, partition: str = "dst"):
        if graph.n % n_parts:
            raise ValueError("pad |V| to a multiple of the mesh axis (Graph.padded)")
        if partition not in ("dst", "src"):
            raise ValueError(f"partition must be 'dst' or 'src', got {partition!r}")
        src, dst, w = graph._edges_np()
        block = graph.n // n_parts
        key = (dst if partition == "dst" else src) // block
        self._set(graph, n_parts, partition,
                  *_pad_partition(src, dst, w, n_parts, key))

    def _set(self, graph, n_parts, partition, srcp, dstp, wp, valid):
        self.graph = graph
        self.n_parts = n_parts
        self.partition = partition
        self.block = graph.n // n_parts
        self.srcp, self.dstp, self.wp, self.valid = (
            torch.from_numpy(np.ascontiguousarray(a)) for a in (srcp, dstp, wp, valid))

    @classmethod
    def _from_parts(cls, graph, n_parts, partition, srcp, dstp, wp, valid):
        sg = cls.__new__(cls)
        sg._set(graph, n_parts, partition, srcp, dstp, wp, valid)
        return sg

    def apply_delta(self, new_graph: Graph, delta) -> "ShardedGraph":
        """Partitions of ``new_graph`` spliced from these, touching only the
        rows ``delta`` can change.

        Row ``r`` of a dst-partition holds exactly the COO edges with
        ``dst // block == r`` in COO (dst-sorted) order, so a touched row is
        rebuilt from two ``searchsorted`` slices of the new graph's COO view
        — what a full ``_pad_partition`` would put there (its stable
        argsort keeps within-bucket COO order).  src-partition rows hold
        ``src // block == r`` in the same COO order, rebuilt by one boolean
        pass.  Emax is kept, so an in-capacity mutation keeps every shape;
        a touched row outgrowing Emax falls back to a full re-partition.
        """
        assert new_graph.n == self.graph.n, "vertex repad requires a rebuild"
        parts = [t.numpy() for t in (self.srcp, self.dstp, self.wp, self.valid)]
        if delta is None or delta.is_empty:
            return ShardedGraph._from_parts(new_graph, self.n_parts, self.partition,
                                            *parts)
        d = delta if self.partition == "dst" else delta.reversed()
        touched = d.touched_dst_blocks(self.block)
        touched = touched[(touched >= 0) & (touched < self.n_parts)]
        emax = parts[0].shape[1]
        src, dst, w = new_graph._edges_np()
        srcp, dstp, wp, valid = (a.copy() for a in parts)
        for r in touched:
            r = int(r)
            if self.partition == "dst":
                lo = int(np.searchsorted(dst, r * self.block, side="left"))
                hi = int(np.searchsorted(dst, (r + 1) * self.block, side="left"))
                rs, rd, rw = src[lo:hi], dst[lo:hi], w[lo:hi]
            else:
                m = (src // self.block) == r
                rs, rd, rw = src[m], dst[m], w[m]
            k = len(rs)
            if k > emax:
                return ShardedGraph(new_graph, self.n_parts, partition=self.partition)
            srcp[r] = 0
            dstp[r] = 0
            wp[r] = 0
            valid[r] = False
            srcp[r, :k] = rs
            dstp[r, :k] = rd
            wp[r, :k] = rw
            valid[r, :k] = True
        return ShardedGraph._from_parts(new_graph, self.n_parts, self.partition,
                                        srcp, dstp, wp, valid)


def mesh_axis_info(mesh, axis: str) -> tuple:
    """(this rank's index on ``axis``, the axis size, its process group)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}: its axes are {names}")
    return (mesh.get_local_rank(axis), mesh.size(names.index(axis)),
            mesh.get_group(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_vertex(tensors: list, group, n_parts: int) -> list:
    """All-gather V-sharded tensors ``(..., block)`` into ``(..., n_parts *
    block)`` along their last (vertex) axis, in ONE collective over their
    bytes side by side.  ``all_gather_into_tensor`` stacks the ranks along
    a new leading axis, so each tensor's share comes back as
    ``(n_parts, M, block)`` and is moved to vertex order."""
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
    send = flat[0] if len(flat) == 1 else torch.cat(flat)
    recv = torch.empty(n_parts * send.numel(), dtype=torch.uint8, device=send.device)
    dist.all_gather_into_tensor(recv, send, group=group)
    recv = recv.view(n_parts, -1)
    out, off = [], 0
    for t, f in zip(tensors, flat):
        part = recv[:, off:off + f.numel()].contiguous().view(t.dtype)
        off += f.numel()
        blk = t.shape[-1]
        full = part.reshape(n_parts, -1, blk).permute(1, 0, 2)
        out.append(full.reshape(t.shape[:-1] + (n_parts * blk,)))
    return out


_REDUCE = {"amin": dist.ReduceOp.MIN, "amax": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}


class ShardedBackend(PropagateBackend):
    """PropagateBackend over a device mesh: edge partitions and one
    collective per superstep (module docstring).

    The rank, axis size and process group come from ``mesh`` and ``axis``
    (``mesh.get_local_rank(axis)``, ``mesh.get_group(axis)``); the device
    is the graph's."""

    name = "sharded"

    def __init__(self, sg: ShardedGraph, mesh, axis: str):
        self.sg = sg
        self.graph = sg.graph
        self.mesh = mesh
        self.axis = axis
        self.rank, n_parts, self.group = mesh_axis_info(mesh, axis)
        if n_parts != sg.n_parts:
            raise ValueError(f"mesh axis {axis!r} has {n_parts} ranks but the graph "
                             f"is cut into {sg.n_parts} partitions")
        self._local = None

    @property
    def parts(self):
        """The (n_parts, Emax) edge-partition arrays, every rank's."""
        return (self.sg.srcp, self.sg.dstp, self.sg.wp, self.sg.valid)

    def refresh(self, graph, delta=None):
        """A backend of the same plan serving the mutated ``graph``: with a
        ``delta``, only the partition rows it touches are re-spliced
        (``ShardedGraph.apply_delta``, Emax kept); without one the edges
        are fully re-partitioned."""
        if delta is not None:
            sg = self.sg.apply_delta(graph, delta)
        else:
            sg = ShardedGraph(graph, self.sg.n_parts, partition=self.sg.partition)
        return ShardedBackend(sg, self.mesh, self.axis)

    def as_args(self, graph_carrier=None, *, slot_cap=None, entry_cap=None):
        return {"parts": self.parts}

    def from_args(self, args):
        sg = copy.copy(self.sg)
        sg.srcp, sg.dstp, sg.wp, sg.valid = args["parts"]
        new = copy.copy(self)
        new.sg, new._local = sg, None
        return new

    def arrays(self):
        return list(self.parts)

    def local_parts(self) -> tuple:
        """This rank's row of :attr:`parts` (host tensors of shape (Emax,))."""
        return tuple(p[self.rank] for p in self.parts)

    def warm(self):
        if self._local is None:
            self._local = self.make_local(self.local_parts())

    def make_local(self, parts):
        """The per-rank propagate over this rank's partition row ``parts``
        = (srcp, dstp, wp, valid), each (Emax,) or (1, Emax).

        The row is sliced to its valid prefix and placed on the graph's
        device once, here: a padding entry's segment would fall outside
        ``[0, block)`` on every rank but 0, which ``scatter_reduce`` would
        refuse (JAX's segment ops drop it).  The returned ``prop(sr, x,
        frontier)`` takes the FULL (replicated) (..., V) value, combines
        over the local edges and performs the single collective: an
        all-gather of the owned destination block, or a MIN/MAX/SUM
        all-reduce of the dense partial.
        """
        srcp, dstp, wp, valid = (torch.as_tensor(p).reshape(-1) for p in parts)
        count = int(valid.sum())
        sg, dev, rank, group = self.sg, self.graph.device, self.rank, self.group
        blockn, n, part, n_parts = sg.block, sg.graph.n, sg.partition, sg.n_parts
        src = srcp[:count].to(dev, torch.long)
        seg = dstp[:count].to(torch.long)
        if part == "dst":
            seg = seg - rank * blockn
        seg = seg.to(dev)
        w = wp[:count].to(dev)

        def prop(sr: Semiring, x, frontier=None):
            if frontier is not None:
                x = torch.where(frontier, x, sr.identity(x.dtype))
            lead = x.shape[:-1]
            xf = x.reshape(-1, n)
            msgs = ref.apply_mul(sr, xf[:, src], w)
            if part == "dst":
                y = sr.segment_combine(msgs, seg, blockn)
                (y,) = all_gather_vertex([y], group, n_parts)
            else:
                y = sr.segment_combine(msgs, seg, n)
                dist.all_reduce(y, op=_REDUCE[sr.reduce], group=group)
            return y.reshape(lead + (n,))

        return prop

    def propagate(self, sr: Semiring, x, frontier=None):
        """x (and the result) replicated on every rank of the axis."""
        self.warm()
        return self._local(sr, x, frontier)


def make_propagate_sharded(sg: ShardedGraph, mesh, axis: str, sr: Semiring):
    """Returns a propagate(x, frontier) -> (..., V) replicated: the
    per-semiring functional wrapper over :class:`ShardedBackend`."""
    be = ShardedBackend(sg, mesh, axis)

    def propagate(x, frontier=None):
        return be.propagate(sr, x, frontier)

    return propagate
