"""Semirings: Pregel message combining as a generalized SpMV.

One superstep of a Pregel program with a combiner is

    y[v] = add_{u in N_in(v), u active} mul(x[u], w(u, v))

where ``add`` is the combiner and ``mul`` injects the edge.  Every lane,
index and table stays int32 (or float32): torch defaults to int64, which
would break parity with the JAX package and ``Graph.content_hash``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Sentinel "infinity" for int32 distance lanes: large but finite, so that
# ``x + 1`` never wraps around.  A Python int keeps int32 tensors int32.
INF = 2**30


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A combiner ``add`` with its identity; ``mul`` (how a message is made
    from a source value and an edge weight) lives in ``kernels/ref.py::
    apply_mul`` and in the CUDA kernel, keyed by ``name``.

    reduce : the ``scatter_reduce`` name of ``add`` ('amin'/'amax'/'sum').
    """

    name: str
    add: Callable
    add_id: object
    reduce: str

    def identity(self, dtype: torch.dtype):
        """``add_id`` as a Python scalar of ``dtype``'s kind, so that
        ``torch.where``/``full`` never promote an int32 lane to float."""
        return float(self.add_id) if dtype.is_floating_point else int(self.add_id)

    @property
    def reads_weight(self) -> bool:
        """Whether ``mul`` reads the edge weight (the ``*_right`` label
        copies only test that an edge is there)."""
        return not self.name.endswith("_right")

    def segment_combine(self, msgs: torch.Tensor, dst: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
        """Reduce ``msgs`` (L, E) by destination ``dst`` (E,) int64 into
        (L, num_segments).  The output starts at ``add_id`` and the reduce
        includes it, so empty segments read the identity directly."""
        out = torch.full((msgs.shape[0], num_segments), self.identity(msgs.dtype),
                         dtype=msgs.dtype, device=msgs.device)
        return out.scatter_reduce_(1, dst.expand(msgs.shape), msgs,
                                   reduce=self.reduce, include_self=True)


MIN_PLUS = Semiring("min_plus", torch.minimum, INF, "amin")         # + w
MIN_RIGHT = Semiring("min_right", torch.minimum, INF, "amin")       # label copy
MAX_RIGHT = Semiring("max_right", torch.maximum, -(2**30), "amax")  # label copy
MAX_PLUS = Semiring("max_plus", torch.maximum, -(2**30), "amax")    # + w
SUM_TIMES = Semiring("sum_times", torch.add, 0.0, "sum")            # * w

BY_NAME = {s.name: s for s in (MIN_PLUS, MIN_RIGHT, MAX_RIGHT, MAX_PLUS, SUM_TIMES)}
