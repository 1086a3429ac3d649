"""Graph containers and generators (the static half of ``repro.core.graph``).

Two adjacency views coexist, as in the JAX package:

* **COO sorted by destination** — drives ``scatter_reduce`` propagation.
* **Block-sparse tiles** — vertices padded to a multiple of ``block`` and
  the adjacency cut into ``(block, block)`` tiles per destination block.
  ``BlockSparse`` stores each tile dense (the plain tile loop of
  ``kernels/ref.py`` and the JAX package's layout); ``PackedBlocks`` keeps
  the same slots but stores only the entries of each tile that differ
  from the semiring's add-identity, the layout of the hand-written CUDA
  kernel (``kernels/frontier.py``).

Arrays are built in numpy exactly as the reference builds them (so both
packages hold byte-identical graphs) and moved to the device once; the
numpy arrays stay beside them as a host mirror, which the mutation path
(``Graph.apply_delta``, ``update_packed_blocks``) splices without a
device round trip.

Mutation: ``Graph.apply_delta`` returns a NEW graph (``version + 1``,
``parent_hash`` the parent's content hash); no array of an older graph
or table is ever written in place, so the memos (content hash, host
mirror, work items) stay valid and older editions keep serving.
``with_capacity`` pads the edge arrays to a fixed capacity with inert
rows, so an in-capacity delta changes values, not shapes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.semiring import Semiring


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BlockSparse:
    """Block-sparse adjacency for one propagation direction.

    ``src_ids[i, k]`` is the source vertex-block feeding destination block
    ``i`` in slot ``k``; ``tiles[i, k]`` is its dense ``(B, B)`` weight tile
    (absent edges hold the semiring's add-identity).  Slots ``k >=
    nslots[i]`` are padding: they point at block 0 with identity tiles.
    """

    src_ids: torch.Tensor  # (nb, max_bpr) int32
    tiles: torch.Tensor  # (nb, max_bpr, B, B) weight dtype
    block: int
    nslots: torch.Tensor  # (nb,) int32

    @property
    def num_dst_blocks(self) -> int:
        return self.src_ids.shape[0]

    @property
    def max_bpr(self) -> int:
        return self.src_ids.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.src_ids, self.tiles, self.nslots))

    def to(self, device) -> "BlockSparse":
        return BlockSparse(self.src_ids.to(device), self.tiles.to(device),
                           self.block, self.nslots.to(device))


@dataclasses.dataclass
class PackedBlocks:
    """The block-sparse adjacency with only the nonzeros of each tile.

    ``src_ids``, ``nslots`` and ``block`` are those of :class:`BlockSparse`.
    The entries of destination block ``i`` are ``entries[row_ptr[i]:
    row_ptr[i + 1]]``, in (slot, row, column) order; an entry packs its
    slot ``k``, its in-tile source row ``r`` and its column ``c`` into one
    int32 as ``k << 2s | r << s | c`` with ``s = shift``.  Only entries
    whose tile value differs from the add-identity are stored, so the
    entries are exactly the ones a dense tile would hold that can
    contribute.  ``w`` holds their values, or is None when the table was
    packed for a semiring that does not read weights (``*_right``);
    ``dtype`` is the weight dtype the entries were chosen in.
    """

    src_ids: torch.Tensor  # (nb, max_bpr) int32
    nslots: torch.Tensor  # (nb,) int32
    row_ptr: torch.Tensor  # (nb + 1,) int32
    entries: torch.Tensor  # (nnz,) int32
    w: Optional[torch.Tensor]  # (nnz,) weight dtype, or None
    block: int
    dtype: torch.dtype

    @property
    def num_dst_blocks(self) -> int:
        return self.src_ids.shape[0]

    @property
    def max_bpr(self) -> int:
        return self.src_ids.shape[1]

    @property
    def shift(self) -> int:
        return _shift(self.block)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.src_ids, self.nslots, self.row_ptr,
                             self.entries, self.w) if t is not None)

    def to(self, device) -> "PackedBlocks":
        if all(t is None or _on(t, device) for t in self._arrays()):
            return self
        move = lambda t: None if t is None else t.to(device)
        out = PackedBlocks(move(self.src_ids), move(self.nslots),
                           move(self.row_ptr), move(self.entries),
                           move(self.w), self.block, self.dtype)
        if "_host" in self.__dict__:
            out._host = self._host
        return out

    def _arrays(self):
        return (self.src_ids, self.nslots, self.row_ptr, self.entries, self.w)

    def host(self) -> dict:
        """The arrays as numpy (``w`` may be None), memoized: the arrays
        are never edited in place.  Tables built from numpy carry it from
        the start, so a splice reads no device memory."""
        if "_host" not in self.__dict__:
            self._host = {f: None if t is None else t.cpu().numpy()
                          for f, t in zip(_PACKED_FIELDS, self._arrays())}
        return self._host

    def decode(self, count: Optional[int] = None):
        """(k, r, c) of every entry (of the first ``count``), int64."""
        s, e = self.shift, self.entries[:count].long()
        lo = (1 << s) - 1
        return e >> (2 * s), (e >> s) & lo, e & lo

    def work_items(self, chunk: int) -> torch.Tensor:
        """(n_items, 3) int32 ``(row, first, end)``: every destination row's
        entries cut into runs of at most ``chunk``, the CUDA kernel's work
        list (an empty row has none).  Memoized per ``chunk``: the arrays
        are never edited in place."""
        memo = self.__dict__.setdefault("_items", {})
        if chunk not in memo:
            rp = self.row_ptr.long()
            counts = (rp.diff() + chunk - 1) // chunk
            dev = rp.device
            row = torch.repeat_interleave(
                torch.arange(self.num_dst_blocks, device=dev), counts)
            nth = torch.arange(row.numel(), device=dev) - (counts.cumsum(0) - counts)[row]
            first = rp[row] + nth * chunk
            end = torch.minimum(first + chunk, rp[row + 1])
            memo[chunk] = torch.stack([row, first, end], 1).to(torch.int32).contiguous()
        return memo[chunk]


def _on(t: torch.Tensor, device) -> bool:
    """Whether ``t`` already lies on ``device`` ('cuda' means any GPU)."""
    dev = torch.device(device)
    return t.device.type == dev.type and dev.index in (None, t.device.index)


_PACKED_FIELDS = ("src_ids", "nslots", "row_ptr", "entries", "w")


def _packed_from_np(arrays: dict, block: int, dtype: torch.dtype,
                    device) -> PackedBlocks:
    """A ``PackedBlocks`` on ``device`` from numpy arrays, which it keeps
    as its host mirror."""
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pb = PackedBlocks(*(t(arrays[f]) for f in _PACKED_FIELDS), block=block, dtype=dtype)
    pb._host = dict(arrays)
    return pb


def _shift(block: int) -> int:
    """Bits of an in-tile index in a packed entry (``block <= 1024``)."""
    if not 1 <= block <= 1024:
        raise ValueError(f"block {block} outside [1, 1024]")
    return (block - 1).bit_length()


def _check_packable(max_bpr: int, block: int) -> int:
    s = _shift(block)
    if max_bpr << (2 * s) > 2**31:
        raise ValueError(f"{max_bpr} slots of {block}x{block} tiles do not fit "
                         "a packed int32 entry")
    return s


def pack_blocks(bs: BlockSparse, sr: Semiring) -> PackedBlocks:
    """Pack a dense table for ``sr`` (built here or carried from elsewhere)
    on its own device: the entries of ``bs.tiles`` that differ from
    ``sr``'s add-identity, in (dst block, slot, row, column) order, with
    their values where ``sr`` reads weights."""
    s = _check_packable(bs.max_bpr, bs.block)
    i, k, r, c = (bs.tiles != sr.identity(bs.tiles.dtype)).nonzero(as_tuple=True)
    counts = torch.bincount(i, minlength=bs.num_dst_blocks)
    row_ptr = torch.zeros(bs.num_dst_blocks + 1, dtype=torch.int32,
                          device=bs.tiles.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return PackedBlocks(
        src_ids=bs.src_ids, nslots=bs.nslots, row_ptr=row_ptr,
        entries=((k << (2 * s)) | (r << s) | c).to(torch.int32),
        w=bs.tiles[i, k, r, c] if sr.reads_weight else None,
        block=bs.block, dtype=bs.tiles.dtype,
    )


def _combine_rule(dtype: np.dtype, add_id):
    """How multi-edges combine in a tile, as the reference combines them:
    OR for unsigned tiles, sum for ``add_id == 0``, min for a positive
    ``add_id`` and max for a negative one."""
    if np.issubdtype(dtype, np.unsignedinteger):
        return np.bitwise_or
    if add_id == 0:
        return np.add
    return np.minimum if add_id > 0 else np.maximum


def _slot_layout(src: np.ndarray, dst: np.ndarray, n: int, block: int):
    """Slots per destination block: ``src_ids`` (nb, max_bpr), ``nslots``
    (nb,), and each edge's destination block and slot.  Slots list each
    row's source blocks in ascending order, as ``np.unique`` gives them."""
    nb = _pad_to(n, block) // block
    uniq, rows, slot, counts, db, k = _row_slots(src, dst, nb, block)
    src_ids = np.zeros((nb, max(1, int(counts.max(initial=0)))), dtype=np.int32)
    src_ids[rows, slot] = (uniq % nb).astype(np.int32)
    return src_ids, counts.astype(np.int32), db, k


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A validated, batched edge mutation (host numpy).

    Deletions apply first, then insertions; an inserted ``(src, dst)``
    that already exists replaces its weight (upsert).  Built by
    :meth:`Graph.make_delta`, which validates endpoints against
    ``n_real`` and checks that every deletion names an existing edge.
    """

    add_src: np.ndarray  # (a,) int32
    add_dst: np.ndarray  # (a,) int32
    add_w: np.ndarray  # (a,) weight dtype
    del_src: np.ndarray  # (d,) int32
    del_dst: np.ndarray  # (d,) int32

    @property
    def size(self) -> int:
        return int(len(self.add_src) + len(self.del_src))

    @property
    def is_empty(self) -> bool:
        return self.size == 0

    def reversed(self) -> "EdgeDelta":
        """The same mutation on the edge-reversed graph (a 'rev' view)."""
        return EdgeDelta(self.add_dst, self.add_src, self.add_w,
                         self.del_dst, self.del_src)

    def touched_dst_blocks(self, block: int) -> np.ndarray:
        """Destination-block rows whose tiles can change under this delta."""
        if self.is_empty:
            return np.zeros(0, dtype=np.int64)
        d = np.concatenate([self.add_dst, self.del_dst])
        return np.unique(d.astype(np.int64) // block)


def _as_pairs(pairs, what: str):
    """Normalize (k, 2) array / (src, dst) tuple / None to two int32 arrays."""
    if pairs is None:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy()
    if isinstance(pairs, tuple) and len(pairs) == 2:
        s = np.atleast_1d(np.asarray(pairs[0], dtype=np.int32))
        d = np.atleast_1d(np.asarray(pairs[1], dtype=np.int32))
        if s.shape != d.shape:
            raise ValueError(f"{what}: src/dst length mismatch {s.shape} vs {d.shape}")
        return s, d
    a = np.asarray(pairs, dtype=np.int32)
    if a.ndim == 1 and a.shape[0] == 2:
        a = a[None, :]
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"{what}: expected (k, 2) pairs or (src, dst) arrays")
    return a[:, 0].copy(), a[:, 1].copy()


def _touched_rows(touched, nb: int) -> np.ndarray:
    if touched is None:
        return np.arange(nb, dtype=np.int64)
    t = np.unique(np.asarray(touched, dtype=np.int64))
    return t[(t >= 0) & (t < nb)]


def _row_edges(dst: np.ndarray, rows: np.ndarray, block: int) -> np.ndarray:
    """Indices (ascending) of the edges of a dst-sorted edge list whose
    destination lies in one of the destination-block ``rows``."""
    lo = np.searchsorted(dst, rows * block, side="left")
    hi = np.searchsorted(dst, (rows + 1) * block, side="left")
    cnt = hi - lo
    return np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(cnt.sum())


def _row_slots(es: np.ndarray, ed: np.ndarray, nb: int, block: int):
    """The slot layout of the rows these edges fall in, as
    ``_slot_layout`` lays it out: the (row, source block) pairs ``uniq``
    (sorted), their rows and slots, the slot count per row, and each
    edge's row and slot."""
    db = ed.astype(np.int64) // block
    pair = db * nb + es.astype(np.int64) // block
    uniq = np.unique(pair)
    rows = uniq // nb
    first = np.searchsorted(rows, rows, side="left")
    slot = np.arange(len(uniq), dtype=np.int64) - first
    counts = np.bincount(rows, minlength=nb)
    k = np.searchsorted(uniq, pair) - np.searchsorted(rows, db, side="left")
    return uniq, rows, slot, counts, db, k


_EDGE_FIELDS = ("src", "dst", "w", "csr_src", "csr_dst", "csr_w")
_GRAPH_ARRAYS = ("src", "dst", "w", "in_deg", "out_deg", "csr_row") + _EDGE_FIELDS[3:]


@dataclasses.dataclass
class Graph:
    """An immutable directed graph, padded to ``n`` vertices.

    Propagation flows src -> dst along the edges; use :meth:`reverse` for
    backward traversal.  Vertices in ``[n_real, n)`` are padding and never
    carry edges.  The CSR (sorted-by-source, then destination) view drives
    the gated COO gather (``kernels/ref.py::propagate_coo_gated``).

    ``version`` and ``parent_hash`` are the mutation lineage:
    :meth:`apply_delta` bumps the version and records the parent's content
    hash, the chain the journal replays against.  When ``nnz`` is set the
    edge arrays are padded to a fixed capacity with inert rows (``src =
    dst = n``, ``w = 0``) and ``nnz`` is the logical edge count.
    """

    n: int
    n_real: int
    src: torch.Tensor  # (E,) int32, sorted by dst
    dst: torch.Tensor  # (E,) int32, sorted
    w: torch.Tensor  # (E,) int32 or float32
    in_deg: torch.Tensor  # (n,) int32
    out_deg: torch.Tensor  # (n,) int32
    csr_row: Optional[torch.Tensor] = None  # (n+1,) int32
    csr_src: Optional[torch.Tensor] = None  # (E,) int32, sorted
    csr_dst: Optional[torch.Tensor] = None
    csr_w: Optional[torch.Tensor] = None
    version: int = 0
    parent_hash: Optional[str] = None
    nnz: Optional[int] = None  # logical edge count of a capacity-padded graph

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0]) if self.nnz is None else int(self.nnz)

    @property
    def edge_capacity(self) -> int:
        """Physical edge-array length (== num_edges unless capacity-padded)."""
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def _np(self, name: str) -> Optional[np.ndarray]:
        """Field ``name`` as numpy (its whole physical length), from the host
        mirror: read from the device once, never written."""
        memo = self.__dict__.setdefault("_host", {})
        if name not in memo:
            t = getattr(self, name)
            memo[name] = None if t is None else t.cpu().numpy()
        return memo[name]

    def _edges_np(self):
        """The logical COO edges as numpy (capacity padding trimmed off)."""
        ne = self.num_edges
        return self._np("src")[:ne], self._np("dst")[:ne], self._np("w")[:ne]

    def _keep_memos(self, other: "Graph", content: bool = True) -> "Graph":
        """Give ``other`` this graph's host mirror of the arrays it shares
        (and the content hash when the content is the same)."""
        host = self.__dict__.get("_host", {})
        mine = {k: v for k, v in host.items() if getattr(other, k) is getattr(self, k)}
        other.__dict__.setdefault("_host", {}).update(mine)
        if content and "_chash" in self.__dict__:
            other._chash = self._chash
        return other

    def _with(self, arrays: dict, **static) -> "Graph":
        """A new graph with the arrays of ``arrays`` (numpy) uploaded to this
        graph's device, the other arrays shared, and ``static`` fields
        replaced; the numpy arrays become its host mirror."""
        dev = self.device
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        kw.update(static)
        for name, a in arrays.items():
            kw[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out = self._keep_memos(Graph(**kw), content=False)
        out._host.update(arrays)
        return out

    def to(self, device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {
            f.name: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)
        }
        out = Graph(**moved)
        if "_host" in self.__dict__:
            out._host = dict(self._host)
        if "_chash" in self.__dict__:
            out._chash = self._chash
        return out

    def content_hash(self) -> str:
        """sha256 over sizes + the logical COO edges + weights (dtype strings
        and bytes), the same digest the JAX package computes for the same
        graph.  Capacity padding is not content.  Memoized: the arrays are
        never edited in place (mutation returns a new graph)."""
        memo = self.__dict__.get("_chash")
        if memo is not None:
            return memo
        h = hashlib.sha256(f"{self.n}/{self.n_real}".encode())
        for a in self._edges_np():
            h.update(str(a.dtype).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        self._chash = h.hexdigest()
        return self._chash

    # ----------------------------------------------------- capacity padding
    def with_capacity(self, max_e: Optional[int] = None, *,
                      max_v: Optional[int] = None) -> "Graph":
        """Pad the edge arrays to a fixed capacity (and optionally repad the
        vertex axis to ``max_v``), returning a shape-stable graph.

        COO padding holds ``src = dst = n, w = 0`` at the tail (the
        dst-sort holds; propagation drops destination ``n``), CSR padding
        the same (the (src, dst)-lex sort holds; the gated gather never
        admits source ``n``).  ``content_hash`` and lineage are unchanged.
        ``max_v`` rebuilds the graph with vertex padding (a different
        padded graph, like :meth:`padded`).
        """
        g = self
        if max_v is not None:
            if max_v < g.n_real:
                raise ValueError(f"max_v {max_v} < n_real {g.n_real}")
            if max_v > g.n:
                s, d, w = g._edges_np()
                g2 = Graph.from_edges(s, d, g.n_real, w=w, pad_to=max_v,
                                      weight_dtype=w.dtype, device=g.device)
                g2.version, g2.parent_hash = g.version, g.parent_hash
                g = g2
        ne = g.num_edges
        cap = max(int(max_e) if max_e is not None else 0, ne)
        if g.nnz is not None and g.edge_capacity == cap:
            return g
        base = g.trimmed()
        if base.csr_row is None:
            raise ValueError("with_capacity needs the CSR view; build via Graph.from_edges")
        arrays = _pad_edges({k: base._np(k) for k in _EDGE_FIELDS}, base.n, cap - ne)
        out = base._with(arrays, nnz=ne)
        if "_chash" in base.__dict__:
            out._chash = base._chash
        return out

    def trimmed(self) -> "Graph":
        """The exact (capacity-free) graph: the logical prefix of every edge
        array, as views.  Identity when not capacity-padded."""
        if self.nnz is None:
            return self
        ne = int(self.nnz)
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        kw.update({k: kw[k][:ne] for k in _EDGE_FIELDS if kw[k] is not None}, nnz=None)
        out = Graph(**kw)
        host = self.__dict__.get("_host", {})
        out._host = {k: (v[:ne] if k in _EDGE_FIELDS and v is not None else v)
                     for k, v in host.items()}
        if "_chash" in self.__dict__:
            out._chash = self._chash
        return out

    def carrier(self) -> "Graph":
        """A lineage-stripped copy (``version`` 0, no parent): what an
        argument-carried edition holds, so its arrays' shapes alone tell
        editions apart."""
        if self.version == 0 and self.parent_hash is None:
            return self
        return self._keep_memos(dataclasses.replace(self, version=0, parent_hash=None))

    # ---------------------------------------------------------------- build
    @staticmethod
    def from_edges(src, dst, n: int, w=None, pad_to: int = 1,
                   weight_dtype=np.int32, device=None) -> "Graph":
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        if w is None:
            w = np.ones_like(src, dtype=weight_dtype)
        else:
            w = np.asarray(w, dtype=weight_dtype)
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        n_pad = _pad_to(max(n, 1), pad_to)
        in_deg = np.bincount(dst, minlength=n_pad).astype(np.int32)
        out_deg = np.bincount(src, minlength=n_pad).astype(np.int32)
        csr = np.argsort(src, kind="stable")
        csr_src = src[csr]
        csr_row = np.searchsorted(csr_src, np.arange(n_pad + 1)).astype(np.int32)
        arrays = dict(src=src, dst=dst, w=w, in_deg=in_deg, out_deg=out_deg,
                      csr_row=csr_row, csr_src=csr_src, csr_dst=dst[csr], csr_w=w[csr])
        dev = resolve_device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        g = Graph(n=n_pad, n_real=n, **{k: t(a) for k, a in arrays.items()})
        g._host = arrays
        return g

    def _rebuild(self, src, dst, w, pad_to: int) -> "Graph":
        return Graph.from_edges(src, dst, self.n_real, w=w, pad_to=pad_to,
                                weight_dtype=w.dtype, device=self.device)

    def padded(self, multiple: int) -> "Graph":
        """Repad so ``n`` is a multiple of ``multiple``; self if aligned."""
        if self.n % multiple == 0:
            return self
        s, d, w = self._edges_np()
        return self._rebuild(s, d, w, _pad_to(self.n, multiple))

    def reverse(self) -> "Graph":
        s, d, w = self._edges_np()
        return self._rebuild(d, s, w, self.n)

    def undirected(self) -> "Graph":
        s, d, w = self._edges_np()
        return self._rebuild(
            np.concatenate([s, d]), np.concatenate([d, s]),
            np.concatenate([w, w]),
            self.n // max(self.n_real, 1) and self.n or 1,
        )

    # ------------------------------------------------------- block-sparse
    def to_blocks(self, block: int, add_id, dtype=None) -> BlockSparse:
        """Materialize the block-sparse dense-tile adjacency on the graph's
        device.

        ``add_id`` fills absent-edge entries.  Multi-edges combine as in the
        reference (``_combine_rule``), applied in edge order (``ufunc.at``
        is unbuffered and ordered, so float sums are bit-identical).
        """
        src, dst, w = self._edges_np()
        dtype = np.dtype(dtype or w.dtype)
        src_ids, nslots, db, k = _slot_layout(src, dst, self.n, block)
        nb, max_bpr = src_ids.shape
        tiles = np.full((nb, max_bpr, block, block), add_id, dtype=dtype)
        flat = ((db * max_bpr + k) * block + src % block) * block + dst % block
        _combine_rule(dtype, add_id).at(tiles.reshape(-1), flat, w.astype(dtype))
        dev = self.device
        return BlockSparse(
            src_ids=torch.from_numpy(src_ids).to(dev),
            tiles=torch.from_numpy(tiles).to(dev),
            block=block,
            nslots=torch.from_numpy(nslots).to(dev),
        )

    def to_packed_blocks(self, block: int, sr: Semiring, dtype=None) -> PackedBlocks:
        """The entries of ``to_blocks(block, sr.add_id)`` that differ from
        the add-identity, built from the edge list in O(E log E) without
        the dense table.

        Multi-edges combine into a compact array with the same rule and in
        the same edge order as :meth:`to_blocks` (starting from
        ``add_id``), so each value is bit-identical to the dense tile's; a
        combined value equal to ``add_id`` is dropped.  Values are kept
        only where ``sr`` reads weights (not for the ``*_right`` semirings).
        """
        src, dst, w = self._edges_np()
        dtype = np.dtype(dtype or w.dtype)
        src_ids, nslots, db, k = _slot_layout(src, dst, self.n, block)
        nb, max_bpr = src_ids.shape
        s = _check_packable(max_bpr, block)
        key, vals = _pack_row_entries(src, dst, w, db, k, s, block, sr, dtype)
        row_ptr = np.zeros(nb + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(np.bincount(key >> 31, minlength=nb))
        return _packed_from_np(
            dict(src_ids=src_ids, nslots=nslots, row_ptr=row_ptr,
                 entries=(key & (2**31 - 1)).astype(np.int32),
                 w=vals if sr.reads_weight else None),
            block, torch.from_numpy(vals[:0]).dtype, self.device)

    # ---------------------------------------------------------- mutation
    def make_delta(self, adds=None, dels=None, *, w=None) -> EdgeDelta:
        """Validate and normalize a batched edge mutation against this graph.

        ``adds``/``dels`` are ``(k, 2)`` ``(src, dst)`` pair arrays (or
        ``(src_array, dst_array)`` tuples); ``w`` gives per-added-edge
        weights (default 1, cast to the graph's weight dtype).  Raises
        ``ValueError`` — leaving the graph untouched — when an endpoint
        falls outside the real vertex range ``[0, n_real)`` or a deletion
        names an absent edge.  Within one batch the last add of a pair
        wins; a pair both deleted and added nets out to the add (upsert).
        """
        a_s, a_d = _as_pairs(adds, "adds")
        d_s, d_d = _as_pairs(dels, "dels")
        wdtype = self._np("w").dtype
        if w is None:
            a_w = np.ones(len(a_s), dtype=wdtype)
        else:
            a_w = np.broadcast_to(np.asarray(w, dtype=wdtype), (len(a_s),)).copy()
        for name, arr in (("adds", a_s), ("adds", a_d), ("dels", d_s), ("dels", d_d)):
            if len(arr) and (int(arr.min()) < 0 or int(arr.max()) >= self.n_real):
                raise ValueError(
                    f"{name}: endpoint outside the real vertex range "
                    f"[0, {self.n_real}) — padded vertices [{self.n_real}, "
                    f"{self.n}) must stay edge-free")
        n = np.int64(self.n)
        if len(a_s):
            key = a_d.astype(np.int64) * n + a_s
            # keep the LAST occurrence of each added pair
            _, ridx = np.unique(key[::-1], return_index=True)
            idx = np.sort(len(key) - 1 - ridx)
            a_s, a_d, a_w = a_s[idx], a_d[idx], a_w[idx]
        if len(d_s):
            key = d_d.astype(np.int64) * n + d_s
            _, idx = np.unique(key, return_index=True)
            idx = np.sort(idx)
            d_s, d_d = d_s[idx], d_d[idx]
            g_s, g_d, _ = self._edges_np()
            base = g_d.astype(np.int64) * n + g_s
            missing = ~np.isin(d_d.astype(np.int64) * n + d_s, base)
            if missing.any():
                bad = [(int(s), int(d)) for s, d in
                       zip(d_s[missing][:5], d_d[missing][:5])]
                raise ValueError(f"dels: edges not present in graph: {bad}")
        return EdgeDelta(a_s, a_d, a_w, d_s, d_d)

    def apply_delta(self, adds=None, dels=None, *, w=None,
                    timings: Optional[dict] = None) -> "Graph":
        """Return a new graph with the delta applied and ``version`` bumped.

        Both adjacency views are merged incrementally on the host mirror, as
        the JAX package merges them: matching rows masked out and new rows
        spliced into the dst-sorted COO and the (src, dst)-lex CSR
        (``np.isin`` + ``searchsorted`` + ``insert``), degrees patched by
        ``bincount``, ``csr_row`` recomputed by binary search.  The
        changed arrays are uploaded once to the graph's device; nothing of
        ``self`` is written.  A capacity-padded graph keeps its capacity
        while the result fits and grows it (``grow_capacity``) when not.
        An empty delta is a version-bumping no-op sharing every array.
        ``timings``, when given, receives ``splice_s`` (host) and
        ``upload_s``.
        """
        delta = adds if isinstance(adds, EdgeDelta) else self.make_delta(adds, dels, w=w)
        parent = self.content_hash()
        if delta.is_empty:
            return self._keep_memos(dataclasses.replace(
                self, version=self.version + 1, parent_hash=parent))
        base = self.trimmed()
        if base.csr_row is None:
            raise ValueError("apply_delta needs the CSR view; build the graph "
                             "via Graph.from_edges")
        t0 = time.perf_counter()
        arrays = base._splice_np(delta)
        nnz = None
        if self.nnz is not None:
            ne, cap = len(arrays["src"]), self.edge_capacity
            if ne > cap:
                cap = grow_capacity(ne)
            arrays.update(_pad_edges({k: arrays[k] for k in _EDGE_FIELDS}, self.n, cap - ne))
            nnz = ne
        t1 = time.perf_counter()
        out = base._with(arrays, version=self.version + 1, parent_hash=parent, nnz=nnz)
        if timings is not None:
            if out.device.type == "cuda":
                torch.cuda.synchronize(out.device)
            timings["splice_s"] = timings.get("splice_s", 0.0) + t1 - t0
            timings["upload_s"] = timings.get("upload_s", 0.0) + time.perf_counter() - t1
        return out

    def _splice_np(self, delta: EdgeDelta) -> dict:
        """The spliced arrays of an exact graph, as numpy (see
        :meth:`apply_delta`)."""
        n = np.int64(self.n)
        src, dst, w_ = self._np("src"), self._np("dst"), self._np("w")
        a_s, a_d, a_w = delta.add_src, delta.add_dst, delta.add_w
        # rows to drop: explicit deletions plus upserted (re-added) pairs
        rm_s = np.concatenate([delta.del_src, a_s])
        rm_d = np.concatenate([delta.del_dst, a_d])
        keep = ~np.isin(dst.astype(np.int64) * n + src, rm_d.astype(np.int64) * n + rm_s)
        rsrc, rdst = src[~keep], dst[~keep]  # removed rows -> degree patch
        ksrc, kdst, kw = src[keep], dst[keep], w_[keep]
        order = np.argsort(a_d, kind="stable")
        i_s, i_d, i_w = a_s[order], a_d[order], a_w[order]
        pos = np.searchsorted(kdst, i_d, side="right")
        out = dict(src=np.insert(ksrc, pos, i_s), dst=np.insert(kdst, pos, i_d),
                   w=np.insert(kw, pos, i_w))
        out["in_deg"] = (self._np("in_deg") - np.bincount(rdst, minlength=self.n)
                         + np.bincount(a_d, minlength=self.n)).astype(np.int32)
        out["out_deg"] = (self._np("out_deg") - np.bincount(rsrc, minlength=self.n)
                          + np.bincount(a_s, minlength=self.n)).astype(np.int32)
        csrc, cdst, cw = self._np("csr_src"), self._np("csr_dst"), self._np("csr_w")
        ckeep = ~np.isin(csrc.astype(np.int64) * n + cdst, rm_s.astype(np.int64) * n + rm_d)
        kcsrc, kcdst, kcw = csrc[ckeep], cdst[ckeep], cw[ckeep]
        # the CSR view is (src, dst)-lex sorted: splice by the composite key
        akey = a_s.astype(np.int64) * n + a_d
        corder = np.argsort(akey, kind="stable")
        cpos = np.searchsorted(kcsrc.astype(np.int64) * n + kcdst, akey[corder],
                               side="right")
        out["csr_src"] = np.insert(kcsrc, cpos, a_s[corder])
        out["csr_dst"] = np.insert(kcdst, cpos, a_d[corder])
        out["csr_w"] = np.insert(kcw, cpos, a_w[corder])
        out["csr_row"] = np.searchsorted(out["csr_src"],
                                         np.arange(self.n + 1)).astype(np.int32)
        return out

    def update_blocks(self, bs: BlockSparse, add_id, touched=None,
                      dtype=None) -> BlockSparse:
        """Refresh a dense table after :meth:`apply_delta`: only the
        destination-block rows in ``touched`` (``EdgeDelta.
        touched_dst_blocks``; None: every row) are rebuilt from this
        graph's dst-sorted COO, all at once.  The slot axis grows (never
        shrinks) when a touched row gains source blocks; untouched rows are
        byte-preserved.  ``bs`` must come from an ancestor of this graph
        whose edges differ only inside ``touched`` rows.  Byte-identical
        to the JAX package's per-edge loop."""
        block = bs.block
        nb = _pad_to(self.n, block) // block
        if nb != bs.num_dst_blocks:
            raise ValueError("update_blocks: vertex count changed; use to_blocks")
        touched = _touched_rows(touched, nb)
        if len(touched) == 0:
            return bs
        src, dst, w = self._edges_np()
        e = _row_edges(dst, touched, block)
        es, ed = src[e], dst[e]
        uniq, rows, slot, counts, db, k = _row_slots(es, ed, nb, block)
        src_ids = bs.src_ids.cpu().numpy().copy()
        tiles = bs.tiles.cpu().numpy().copy()
        nslots = bs.nslots.cpu().numpy().copy()
        need = int(counts[touched].max())
        if need > bs.max_bpr:
            pad = need - bs.max_bpr
            src_ids = np.pad(src_ids, ((0, 0), (0, pad)))
            tiles = np.pad(tiles, ((0, 0), (0, pad), (0, 0), (0, 0)),
                           constant_values=add_id)
        src_ids[touched] = 0
        tiles[touched] = add_id
        nslots[touched] = counts[touched]
        src_ids[rows, slot] = (uniq % nb).astype(np.int32)
        m = tiles.shape[1]
        flat = ((db * m + k) * block + es % block) * block + ed % block
        _combine_rule(tiles.dtype, add_id).at(tiles.reshape(-1), flat,
                                              w[e].astype(tiles.dtype))
        if dtype is not None and tiles.dtype != dtype:
            tiles = tiles.astype(dtype)
        dev = bs.src_ids.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return BlockSparse(src_ids=t(src_ids), tiles=t(tiles), block=block,
                           nslots=t(nslots))

    def update_packed_blocks(self, pb: PackedBlocks, sr: Semiring, touched=None,
                             *, device=None) -> PackedBlocks:
        """Re-pack only the destination-block rows in ``touched`` of a packed
        table after :meth:`apply_delta`; the result equals
        ``to_packed_blocks(pb.block, sr)`` of this graph, array for array.

        The touched rows' slots, entries (with their slot numbers in
        ``k << 2s``) and values are rebuilt from this graph's dst-sorted
        COO as ``to_packed_blocks`` builds them; the other rows' entries
        are copied; ``row_ptr`` is recounted and the slot grid resized to
        the new widest row.  Runs on the host mirrors and returns a new
        table on ``device`` (default: the graph's), never writing ``pb``
        (which comes back as it is when no row is touched).  ``pb`` must
        come from an ancestor whose edges differ only inside ``touched``
        rows (None: every row).
        """
        block = pb.block
        nb = _pad_to(self.n, block) // block
        if nb != pb.num_dst_blocks:
            raise ValueError("update_packed_blocks: vertex count changed; "
                             "use to_packed_blocks")
        if sr.reads_weight and pb.w is None:
            raise ValueError(f"the packed table for '{sr.name}' holds no weights")
        dev = self.device if device is None else torch.device(device)
        touched = _touched_rows(touched, nb)
        if len(touched) == 0:
            return pb
        h = pb.host()
        src, dst, w = self._edges_np()
        e = _row_edges(dst, touched, block)
        es, ed = src[e], dst[e]
        uniq, rows, slot, counts, db, k = _row_slots(es, ed, nb, block)
        nslots = h["nslots"].copy()
        nslots[touched] = counts[touched]
        max_bpr = max(1, int(nslots.max(initial=0)))
        s = _check_packable(max_bpr, block)
        src_ids = np.zeros((nb, max_bpr), dtype=np.int32)
        width = min(max_bpr, h["src_ids"].shape[1])
        src_ids[:, :width] = h["src_ids"][:, :width]
        src_ids[touched] = 0
        src_ids[rows, slot] = (uniq % nb).astype(np.int32)
        dtype = torch.empty(0, dtype=pb.dtype).numpy().dtype
        key, vals = _pack_row_entries(es, ed, w[e], db, k, s, block, sr, dtype)
        new_counts = np.bincount(key >> 31, minlength=nb)
        old_rp = h["row_ptr"].astype(np.int64)
        counts_all = np.diff(old_rp)
        counts_all[touched] = new_counts[touched]
        row_ptr = np.zeros(nb + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(counts_all)
        new_entries = (key & (2**31 - 1)).astype(np.int32)
        # untouched runs of rows are copied, touched rows come from the splice
        cut = np.concatenate([[0], np.cumsum(new_counts[touched])])
        ents, ws, prev = [], [], 0
        for j, t in enumerate(touched):
            ents += [h["entries"][old_rp[prev]:old_rp[t]], new_entries[cut[j]:cut[j + 1]]]
            if sr.reads_weight:
                ws += [h["w"][old_rp[prev]:old_rp[t]], vals[cut[j]:cut[j + 1]]]
            prev = t + 1
        ents.append(h["entries"][old_rp[prev]:])
        if sr.reads_weight:
            ws.append(h["w"][old_rp[prev]:])
        return _packed_from_np(
            dict(src_ids=src_ids, nslots=nslots, row_ptr=row_ptr,
                 entries=np.concatenate(ents),
                 w=np.concatenate(ws) if sr.reads_weight else None),
            block, pb.dtype, dev)


def _pack_row_entries(src, dst, w, db, k, s: int, block: int, sr: Semiring, dtype):
    """Packed keys ``db << 31 | k << 2s | r << s | c`` (sorted, one per
    distinct tile position) and their combined values, the entries whose
    value differs from ``sr.add_id``: ``to_packed_blocks``'s combine."""
    code = (k << (2 * s)) | ((src % block).astype(np.int64) << s) | (dst % block)
    key, inv = np.unique((db << 31) | code, return_inverse=True)
    vals = np.full(len(key), sr.add_id, dtype=dtype)
    _combine_rule(dtype, sr.add_id).at(vals, inv.reshape(-1), w.astype(dtype))
    keep = vals != sr.add_id
    return key[keep], vals[keep]


def _pad_edges(arrays: dict, n: int, pad: int) -> dict:
    """Edge arrays padded with ``pad`` inert rows: endpoints ``n``, weight 0."""
    fill = lambda k: 0 if k.endswith("w") else n
    return {k: np.concatenate([a, np.full(pad, fill(k), dtype=a.dtype)])
            for k, a in arrays.items()}


def grow_capacity(ne: int) -> int:
    """Default edge-capacity headroom: ~25% + slack, rounded to 64."""
    return _pad_to(int(ne * 1.25) + 32, 64)


def pad_block_slots(bs: BlockSparse, slot_cap: int, add_id) -> BlockSparse:
    """Pad a dense table's slot axis to ``slot_cap`` slots per destination
    row, keeping its shapes stable across mutations.  Padding slots point
    at source block 0 with add-identity tiles and ``nslots`` is unchanged,
    so gating skips them and the tile math treats them as no-ops."""
    if bs.max_bpr > slot_cap:
        raise ValueError(f"slot_cap {slot_cap} < table max_bpr {bs.max_bpr}")
    if bs.max_bpr == slot_cap:
        return bs
    pad = slot_cap - bs.max_bpr
    return BlockSparse(
        src_ids=torch.nn.functional.pad(bs.src_ids, (0, pad)),
        tiles=torch.nn.functional.pad(bs.tiles, (0, 0, 0, 0, 0, pad), value=add_id),
        block=bs.block, nslots=bs.nslots)


def pad_packed_slots(pb: PackedBlocks, slot_cap: int, entry_cap: int) -> PackedBlocks:
    """A packed table with its slot grid padded to ``slot_cap`` slots and
    its entries (and values) to ``entry_cap``, keeping its shapes stable
    across mutations.  Padding slots are past ``nslots``; padding entries
    lie past ``row_ptr[-1]`` and no work item reads them."""
    if pb.max_bpr > slot_cap or pb.entries.numel() > entry_cap:
        raise ValueError(f"caps ({slot_cap}, {entry_cap}) below the table's "
                         f"({pb.max_bpr}, {pb.entries.numel()})")
    pad = entry_cap - pb.entries.numel()
    grow = lambda t: None if t is None else torch.nn.functional.pad(t, (0, pad))
    return PackedBlocks(
        src_ids=torch.nn.functional.pad(pb.src_ids, (0, slot_cap - pb.max_bpr)),
        nslots=pb.nslots, row_ptr=pb.row_ptr, entries=grow(pb.entries), w=grow(pb.w),
        block=pb.block, dtype=pb.dtype)


# ------------------------------------------------------------- generators
def barabasi_albert(n: int, m: int, seed: int = 0, directed: bool = False,
                    device=None) -> Graph:
    """Preferential-attachment graph: the skewed-degree ('hub') setting the
    paper's Hub^2 index targets.

    Makes the reference's draws in O(n·m): the reference grows a Python
    list and ``rng.choice`` copies it on every call (O(n²)); here the
    list is a preallocated buffer and ``rng.choice`` samples its prefix,
    which consumes the generator identically.
    """
    rng = np.random.default_rng(seed)
    repeated = np.empty(m + 2 * m * max(n - m, 0), dtype=np.int64)
    repeated[:m] = np.arange(m)
    size = m
    src_l, dst_l = [], []
    for v in range(m, n):
        picks = (rng.choice(repeated[:size], size=m, replace=True) if size
                 else rng.integers(0, v, m))
        picks = np.unique(picks)
        src_l.append(np.full(len(picks), v, dtype=np.int64))
        dst_l.append(picks)
        repeated[size:size + 2 * len(picks):2] = v
        repeated[size + 1:size + 2 * len(picks):2] = picks
        size += 2 * len(picks)
    src = np.concatenate(src_l or [np.zeros(0, np.int64)]).astype(np.int32)
    dst = np.concatenate(dst_l or [np.zeros(0, np.int64)]).astype(np.int32)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph.from_edges(src[idx], dst[idx], n, device=device)


def random_graph(n: int, avg_deg: float, seed: int = 0, directed: bool = True,
                 device=None) -> Graph:
    rng = np.random.default_rng(seed)
    e = int(n * avg_deg)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph.from_edges(src[idx], dst[idx], n, device=device)


def multi_component_graph(n_components: int, comp_size: int, avg_deg: float,
                          seed: int = 0, device=None) -> Graph:
    """Many small CCs — the BTC-like regime where most (s,t) are unreachable."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    for c in range(n_components):
        base = c * comp_size
        e = int(comp_size * avg_deg)
        s = rng.integers(0, comp_size, e) + base
        d = rng.integers(0, comp_size, e) + base
        keep = s != d
        src_l.append(s[keep])
        dst_l.append(d[keep])
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    n = n_components * comp_size
    src2, dst2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = src2.astype(np.int64) * n + dst2
    _, idx = np.unique(key, return_index=True)
    return Graph.from_edges(src2[idx], dst2[idx], n, device=device)


def random_dag(n: int, avg_deg: float, seed: int = 0, device=None) -> Graph:
    """DAG via random topological order — the reachability-query substrate."""
    rng = np.random.default_rng(seed)
    e = int(n * avg_deg)
    a = rng.integers(0, n, e).astype(np.int32)
    b = rng.integers(0, n, e).astype(np.int32)
    src, dst = np.minimum(a, b), np.maximum(a, b)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph.from_edges(src[idx], dst[idx], n, device=device)


def random_tree(n: int, max_fanout: int = 8, seed: int = 0, deep: bool = False,
                device=None) -> tuple[Graph, np.ndarray]:
    """Rooted tree (child->parent edges) modeling an XML document.

    Default is shallow (parent drawn uniformly from earlier vertices →
    O(log n) depth, like real XML); ``deep=True`` uses a locality window
    giving O(n) depth.  Returns the graph with edges child->parent (the
    direction SLCA/ELCA bitmaps flow) and the parent array (parent[0] =
    -1).  One ``rng.integers`` draw per vertex, as the reference draws:
    a vectorized draw would give another tree.
    """
    rng = np.random.default_rng(seed)
    parent = np.full(n, -1, dtype=np.int32)
    for v in range(1, n):
        lo = max(0, v - max_fanout * 4) if deep else 0
        parent[v] = rng.integers(lo, v)
    src = np.arange(1, n, dtype=np.int32)
    g = Graph.from_edges(src, parent[1:], n, device=device)
    return g, parent


def grid_terrain(rows: int, cols: int, eps_subdiv: int = 1, seed: int = 0,
                 device=None) -> tuple[Graph, np.ndarray]:
    """The paper's §5.3 terrain network: an elevation mesh with per-cell
    shortcut edges (diagonals) and 3D-Euclidean float32 edge weights.

    Returns (graph, coords), coords (n, 3) float32 numpy positions.
    ``eps_subdiv`` > 1 splits each cell edge, adding the shortcut vertices
    of the paper's Fig. 4(b).
    """
    rng = np.random.default_rng(seed)
    r = rows * eps_subdiv - (eps_subdiv - 1)
    c = cols * eps_subdiv - (eps_subdiv - 1)
    # smooth hills plus mild noise, bilinearly interpolated at the
    # subdivided resolution
    yy0, xx0 = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    elev = (
        12.0 * np.sin(yy0 / 6.0) * np.cos(xx0 / 7.0)
        + 6.0 * np.sin((yy0 + xx0) / 11.0)
        + rng.random((rows, cols)) * 1.5
    ).astype(np.float32)
    yi = np.linspace(0, rows - 1, r)
    xi = np.linspace(0, cols - 1, c)
    y0 = np.clip(yi.astype(int), 0, rows - 2)
    x0 = np.clip(xi.astype(int), 0, cols - 2)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    z = (
        elev[y0][:, x0] * (1 - fy) * (1 - fx)
        + elev[y0 + 1][:, x0] * fy * (1 - fx)
        + elev[y0][:, x0 + 1] * (1 - fy) * fx
        + elev[y0 + 1][:, x0 + 1] * fy * fx
    ).astype(np.float32)
    spacing = 10.0 / eps_subdiv  # 10 m sampling interval, subdivided
    ys, xs = np.meshgrid(np.arange(r), np.arange(c), indexing="ij")
    coords = np.stack(
        [xs.ravel() * spacing, ys.ravel() * spacing, z.ravel()], axis=1
    ).astype(np.float32)
    n = r * c
    src_l, dst_l = [], []
    # 8-connected: horizontal, vertical, both diagonals (cell shortcuts)
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        y = np.arange(max(0, -dy), r - max(0, dy))
        x = np.arange(max(0, -dx), c - max(0, dx))
        yy, xx = np.meshgrid(y, x, indexing="ij")
        a = (yy * c + xx).ravel()
        b = ((yy + dy) * c + xx + dx).ravel()
        src_l += [a, b]
        dst_l += [b, a]
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    w = np.linalg.norm(coords[src] - coords[dst], axis=1).astype(np.float32)
    g = Graph.from_edges(src, dst, n, w=w, weight_dtype=np.float32, device=device)
    return g, coords
