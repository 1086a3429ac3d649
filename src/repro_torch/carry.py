"""Carry state built elsewhere into the port.

Each function takes a dict of numpy arrays (and ints) keyed by the JAX
package's dataclass field names — ``Graph``, ``BlockSparse``, ``HubIndex``
— and returns the port's object on ``device``.  Fields the port does not
hold yet (mutation lineage, capacity padding) are ignored.  With this a
table or index one package built can be queried by the other, so query
parity is testable apart from build parity.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.hub2 import HubIndex
from repro_torch.core.graph import BlockSparse, Graph


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)  # a writable host copy


def graph_from_numpy(d: dict, device=None) -> Graph:
    if d.get("nnz") is not None:
        raise ValueError("capacity-padded graphs are not ported yet: pass graph.trimmed()")
    dev = resolve_device(device)
    opt = lambda k: None if d.get(k) is None else _t(d[k], dev)
    return Graph(
        n=int(d["n"]), n_real=int(d["n_real"]),
        src=_t(d["src"], dev), dst=_t(d["dst"], dev), w=_t(d["w"], dev),
        in_deg=_t(d["in_deg"], dev), out_deg=_t(d["out_deg"], dev),
        csr_row=opt("csr_row"), csr_src=opt("csr_src"),
        csr_dst=opt("csr_dst"), csr_w=opt("csr_w"),
    )


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
