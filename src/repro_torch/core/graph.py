"""Graph containers and generators (the static half of ``repro.core.graph``).

Two adjacency views coexist, as in the JAX package:

* **COO sorted by destination** — drives ``scatter_reduce`` propagation.
* **Block-sparse dense tiles** — vertices padded to a multiple of ``block``
  and the adjacency stored as dense ``(block, block)`` weight tiles per
  destination block, consumed by the hand-written CUDA kernel
  (``kernels/frontier.py``).

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
        reference: OR for unsigned tiles, sum for ``add_id == 0``, min for
        a positive ``add_id`` and max for a negative one, applied in edge
        order (``ufunc.at`` is unbuffered and ordered, so float sums are
        bit-identical).  Slots list each row's source blocks in ascending
        order, as ``np.unique`` gives them.
        """
        src, dst, w = self._edges_np()
        dtype = np.dtype(dtype or w.dtype)
        nb = _pad_to(self.n, block) // block
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
        tiles = np.full((nb, max_bpr, block, block), add_id, dtype=dtype)
        k = np.searchsorted(uniq, pair) - start[db]
        flat = ((db * max_bpr + k) * block + src % block) * block + dst % block
        wv = w.astype(dtype)
        if np.issubdtype(dtype, np.unsignedinteger):
            combine = np.bitwise_or
        elif add_id == 0:
            combine = np.add
        elif add_id > 0:
            combine = np.minimum
        else:
            combine = np.maximum
        combine.at(tiles.reshape(-1), flat, wv)
        dev = self.device
        return BlockSparse(
            src_ids=torch.from_numpy(src_ids).to(dev),
            tiles=torch.from_numpy(tiles).to(dev),
            block=block,
            nslots=torch.from_numpy(nslots).to(dev),
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
