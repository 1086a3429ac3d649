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
packages hold byte-identical graphs) and moved to the device once.
"""
from __future__ import annotations

import dataclasses
import hashlib
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
        move = lambda t: None if t is None else t.to(device)
        return PackedBlocks(move(self.src_ids), move(self.nslots),
                            move(self.row_ptr), move(self.entries),
                            move(self.w), self.block, self.dtype)

    def decode(self):
        """(k, r, c) of every entry, int64."""
        s, e = self.shift, self.entries.long()
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
    sb = (src // block).astype(np.int64)
    db = (dst // block).astype(np.int64)
    pair = db * nb + sb
    uniq = np.unique(pair)
    rows = uniq // nb
    nslots = np.bincount(rows, minlength=nb).astype(np.int32)
    max_bpr = max(1, int(nslots.max(initial=0)))
    start = np.concatenate([[0], np.cumsum(nslots)[:-1]]).astype(np.int64)
    slot = np.arange(len(uniq), dtype=np.int64) - start[rows]
    src_ids = np.zeros((nb, max_bpr), dtype=np.int32)
    src_ids[rows, slot] = (uniq % nb).astype(np.int32)
    k = np.searchsorted(uniq, pair) - start[db]
    return src_ids, nslots, db, k


@dataclasses.dataclass
class Graph:
    """An immutable directed graph, padded to ``n`` vertices.

    Propagation flows src -> dst along the edges; use :meth:`reverse` for
    backward traversal.  Vertices in ``[n_real, n)`` are padding and never
    carry edges.  The CSR (sorted-by-source) view is kept for the gated COO
    path of a later slice.
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

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def _edges_np(self):
        return (self.src.cpu().numpy(), self.dst.cpu().numpy(),
                self.w.cpu().numpy())

    def to(self, device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {
            f.name: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)
        }
        return Graph(**moved)

    def content_hash(self) -> str:
        """sha256 over sizes + COO edges + weights (dtype strings and bytes),
        the same digest the JAX package computes for the same graph.
        Memoized: the arrays are never edited in place."""
        memo = getattr(self, "_chash", None)
        if memo is not None:
            return memo
        h = hashlib.sha256(f"{self.n}/{self.n_real}".encode())
        for a in self._edges_np():
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        self._chash = h.hexdigest()
        return self._chash

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
        dev = resolve_device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return Graph(
            n=n_pad, n_real=n, src=t(src), dst=t(dst), w=t(w),
            in_deg=t(in_deg), out_deg=t(out_deg), csr_row=t(csr_row),
            csr_src=t(csr_src), csr_dst=t(dst[csr]), csr_w=t(w[csr]),
        )

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
        add_id = sr.add_id
        src, dst, w = self._edges_np()
        dtype = np.dtype(dtype or w.dtype)
        src_ids, nslots, db, k = _slot_layout(src, dst, self.n, block)
        nb, max_bpr = src_ids.shape
        s = _check_packable(max_bpr, block)
        code = (k << (2 * s)) | ((src % block).astype(np.int64) << s) | (dst % block)
        key, inv = np.unique((db << 31) | code, return_inverse=True)
        vals = np.full(len(key), add_id, dtype=dtype)
        _combine_rule(dtype, add_id).at(vals, inv.reshape(-1), w.astype(dtype))
        keep = vals != add_id
        key = key[keep]
        row_ptr = np.zeros(nb + 1, dtype=np.int32)
        row_ptr[1:] = np.cumsum(np.bincount(key >> 31, minlength=nb))
        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return PackedBlocks(
            src_ids=t(src_ids), nslots=t(nslots), row_ptr=t(row_ptr),
            entries=t((key & (2**31 - 1)).astype(np.int32)),
            w=t(vals[keep]) if sr.reads_weight else None,
            block=block, dtype=torch.from_numpy(vals[:0]).dtype,
        )


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
