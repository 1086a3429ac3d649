"""Carry state built elsewhere into the port.

Each function takes a dict of numpy arrays (and ints) keyed by the JAX
package's dataclass field names — ``Graph`` (with its mutation lineage
and capacity padding), ``EdgeDelta``, ``BlockSparse``, ``HubIndex``,
``ReachIndex``, ``XMLIndex`` — or the arrays themselves (an
``InvertedIndex``'s tokens, terrain coords), and returns the port's
object on ``device``.  With this a graph, delta, table or index one
package built can be used by the other, so query parity is testable apart
from build parity.  An LM's parameters and decode cache come over the
same way, as the nested dicts and lists of numpy arrays of the JAX
pytree (``jax.random`` keys cannot be replayed in torch).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.hub2 import HubIndex
from repro_torch.apps.keyword import InvertedIndex
from repro_torch.apps.reach import ReachIndex
from repro_torch.apps.xmlkw import XMLIndex
from repro_torch.core.graph import BlockSparse, EdgeDelta, Graph
from repro_torch.core.runtime import tree_map


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)  # a writable host copy


def graph_from_numpy(d: dict, device=None) -> Graph:
    """A graph with its lineage (``version``, ``parent_hash``) and, for a
    capacity-padded graph, its padding and logical edge count ``nnz``."""
    dev = resolve_device(device)
    opt = lambda k: None if d.get(k) is None else _t(d[k], dev)
    return Graph(
        n=int(d["n"]), n_real=int(d["n_real"]),
        src=_t(d["src"], dev), dst=_t(d["dst"], dev), w=_t(d["w"], dev),
        in_deg=_t(d["in_deg"], dev), out_deg=_t(d["out_deg"], dev),
        csr_row=opt("csr_row"), csr_src=opt("csr_src"),
        csr_dst=opt("csr_dst"), csr_w=opt("csr_w"),
        version=int(d.get("version") or 0), parent_hash=d.get("parent_hash"),
        nnz=None if d.get("nnz") is None else int(d["nnz"]),
    )


def edge_delta_from_numpy(d: dict) -> EdgeDelta:
    """An ``EdgeDelta`` (host numpy in both packages)."""
    return EdgeDelta(*(np.array(d[k]) for k in
                       ("add_src", "add_dst", "add_w", "del_src", "del_dst")))


def blocks_from_numpy(d: dict, device=None) -> BlockSparse:
    """The dense tile table; the ``cuda`` plan packs it once with
    ``core.graph.pack_blocks`` (or packs it itself when passed as
    ``blocks=``)."""
    dev = resolve_device(device)
    return BlockSparse(src_ids=_t(d["src_ids"], dev), tiles=_t(d["tiles"], dev),
                       block=int(d["block"]), nslots=_t(d["nslots"], dev))


def hub_index_from_numpy(d: dict, device=None) -> HubIndex:
    dev = resolve_device(device)
    return HubIndex(hub_ids=_t(d["hub_ids"], dev), is_hub=_t(d["is_hub"], dev),
                    hub_dist=_t(d["hub_dist"], dev), core=_t(d["core"], dev))


def reach_index_from_numpy(d: dict, device=None) -> ReachIndex:
    dev = resolve_device(device)
    return ReachIndex(**{k: _t(d[k], dev)
                         for k in ("level", "pre", "yes_hi", "post", "no_lo")})


def xml_index_from_numpy(d: dict, device=None) -> XMLIndex:
    dev = resolve_device(device)
    return XMLIndex(tokens=_t(d["tokens"], dev), level=_t(d["level"], dev),
                    parent=_t(d["parent"], dev))


def inverted_index_from_numpy(tokens, device=None) -> InvertedIndex:
    """The token table (V, T) int32 of the JAX ``InvertedIndex.tokens``."""
    return InvertedIndex(_t(tokens, resolve_device(device)))


def coords_from_numpy(coords, device=None) -> torch.Tensor:
    """Terrain vertex positions (V, 3) float32, the terrain engine's index."""
    return _t(np.asarray(coords, np.float32), resolve_device(device))


def _leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return _t(a, dev)


def params_from_numpy(tree, device=None):
    """An LM parameter pytree (``models/transformer.py``'s keys: nested
    dicts and lists of numpy arrays) as tensors, dtypes unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


def cache_from_numpy(tree, device=None):
    """A decode cache pytree (``init_cache``'s keys) as tensors, dtypes
    unchanged."""
    return params_from_numpy(tree, device)


def opt_state_from_numpy(tree, device=None):
    """An optimizer state (``train/optimizer.py::adamw_init``'s keys: the
    0-d int32 ``step``, the moments ``mu`` and ``nu``, and with compression
    the float32 residual ``err``) as tensors, dtypes unchanged: bf16
    moments arrive as ml_dtypes arrays and are viewed as uint16."""
    return params_from_numpy(tree, device)
