"""Roofline accounting (``repro.launch.roofline``) at NVIDIA H100 constants.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / 989.4e12         (bf16 dense peak, H100 SXM)
  memory     = bytes_per_device / 3.35e12          (HBM3)
  collective = sum over mesh dims of that dim's collective bytes / its link

The H100 fabric has two tiers, so each collective is charged at the
bandwidth of the mesh dim it runs over: 'model' stays inside one HGX
node's NVLink 4 domain (450e9 B/s per direction per GPU), 'data' and
'pod' cross nodes (50e9 B/s: one 400 Gb/s NDR NIC per GPU).  Bytes not
attributed to a dim (the HLO parser's) are charged at the slower tier.
The JAX package charges every collective at one ICI rate.

Where the counts come from (``launch/dryrun.py``): ``CostMode`` watches a
step traced on DTensors and counts the aten ops that run on the *local
shards*, i.e. per device:

* ``local_flops``: matmul FLOPs by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode`` itself counts a DTensor op at its global size);
* ``local_bytes``: each op's input and output bytes, views excluded.  This is
  an unfused count, one read and one write per op; XLA's "bytes
  accessed", which the JAX package reads, is taken after fusion, so the
  port's memory term is larger for the same program;
* collectives (``dtensor_collective_bytes``): the *result* bytes of each
  ``_c10d_functional`` collective, per kind and per mesh dim, the same
  convention as ``collective_bytes``' parse of partitioned HLO text.
  On a CPU-typed mesh DTensor moves Shard to Shard as an all-gather plus
  a chunk (gloo has no all-to-all); ``CostMode`` counts that as the
  all-to-all a CUDA mesh issues (its result is the size of its input)
  and leaves the chunk's copy out, so a trace on either mesh type gives
  the same counts.
"""
from __future__ import annotations

import dataclasses
import re
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989.4e12  # bf16 dense FLOP/s per H100 SXM
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction per GPU, inside one node
NET_BW = 50e9  # bytes/s per GPU across nodes (400 Gb/s NDR)
LINK_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[-a-z]*\(",
)
_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _empty_coll() -> dict:
    return {**{k: 0 for k in KINDS}, "count": 0}


def collective_bytes(hlo_text: str) -> dict:
    """Per collective kind: summed result bytes in partitioned HLO text."""
    out = _empty_coll()
    for m in _COLL_RE.finditer(hlo_text):
        shape_str = m.group(1) or m.group(2)
        kind = m.group(3)
        out[kind] += _shape_bytes(shape_str)
        out["count"] += 1
    out["total"] = sum(out[k] for k in KINDS)
    return out


# _c10d_functional op -> the HLO kind it lowers to
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "shard_dim_alltoall": "all-to-all",  # _dtensor's, on a CUDA mesh
}


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor) and x.device.type != "meta")


class CostMode(TorchDispatchMode):
    """Per-device counts of what a step runs (module docstring): enter it
    around the step; it sees the local ops that DTensor dispatches (a
    DTensor op itself is passed on, as ``CommDebugMode`` does) and plain
    tensors' ops.  ``mesh`` names the collectives' mesh dims."""

    def __init__(self, mesh=None):
        super().__init__()
        self.local_flops = 0
        self.local_bytes = 0
        self.coll = _empty_coll()
        self.by_dim: dict[str, int] = {}
        self._alltoall = False  # inside a CPU mesh's all-gather + chunk
        self._dims = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._dims[mesh.get_group(i).group_name] = name

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the *global* shape to learn the output's shape: that
        # is not work (or memory) of a device, and whether it runs depends
        # on DTensor's cache, so it runs with every mode off (this one and
        # a ``MemTracker``'s; it brings its own fake mode)
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import _disable_current_modes

        prop = DTensor._op_dispatcher.sharding_propagator
        meta = prop._propagate_tensor_meta_non_cached

        def unwatched(op_schema):
            with _disable_current_modes():
                return meta(op_schema)

        prop._propagate_tensor_meta_non_cached = unwatched
        self._prop = prop
        # a CPU mesh's Shard-to-Shard move (module docstring)
        import torch.distributed.tensor.placement_types as PT

        move = PT.shard_dim_alltoall

        def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
            if mesh.device_type != "cpu":
                return move(x, gather_dim, shard_dim, mesh, mesh_dim)
            self._alltoall = True
            try:
                return move(x, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._alltoall = False

        PT.shard_dim_alltoall = alltoall
        self._move = (PT, move)
        return super().__enter__()

    def __exit__(self, *exc):
        del self._prop._propagate_tensor_meta_non_cached
        PT, move = self._move
        PT.shard_dim_alltoall = move
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = tree_flatten((args, kwargs))[0]
        if any(isinstance(x, torch.Tensor) and x.device.type == "meta" for x in ins):
            return out  # shape propagation, not work
        ns = func.namespace
        name = func._overloadpacket.__name__
        if self._alltoall and ns != "_c10d_functional":
            return out  # the chunk and its copy: part of the all-to-all
        if ns in ("_c10d_functional", "_dtensor"):
            kind = _FUNCOL_KIND.get(name)
            if self._alltoall and kind == "all-gather":
                kind, b = "all-to-all", _nbytes(args[:1])
            elif kind is not None:
                b = _nbytes(tree_flatten(out)[0])
            if kind is not None:
                self.coll[kind] += b
                self.coll["count"] += 1
                dim = self._dims.get(args[-1] if isinstance(args[-1], str) else None, "?")
                self.by_dim[dim] = self.by_dim.get(dim, 0) + b
            return out
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not outs:
            return out  # a metadata query (size, device, ...)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.local_flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view:
            self.local_bytes += _nbytes(ins) + _nbytes(outs)
        return out

    def collectives(self) -> dict:
        """``collective_bytes``' dict, with ``by_dim``: bytes per mesh dim."""
        return {**self.coll, "total": sum(self.coll[k] for k in KINDS),
                "by_dim": dict(self.by_dim)}


def dtensor_collective_bytes(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count the result bytes of every
    ``_c10d_functional`` collective it issues, per kind and per mesh dim
    (``CostMode.collectives``).  Returns (fn's result, that dict)."""
    with CostMode(mesh) as m:
        out = fn(*args, **kwargs)
    return out, m.collectives()


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float  # per device
    bytes_accessed: float  # per device
    coll_bytes: float  # per device
    coll_detail: dict  # per kind; "by_dim": per mesh dim
    model_flops: float  # useful flops per device (6ND / 2ND)
    peak_mem_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        by_dim = (self.coll_detail or {}).get("by_dim") or {}
        t = sum(b / LINK_BW.get(d, NET_BW) for d, b in by_dim.items())
        return t + max(self.coll_bytes - sum(by_dim.values()), 0) / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the *useful* model flops achieve at the bound."""
        if self.bound_time == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_time

    def to_dict(self) -> dict:
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            flops=self.flops, bytes_accessed=self.bytes_accessed,
            coll_bytes=self.coll_bytes, coll_detail=self.coll_detail,
            model_flops=self.model_flops, peak_mem_bytes=self.peak_mem_bytes,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
        )


def model_flops_per_device(cfg, shape_cfg, n_devices: int) -> float:
    """6·N_active·tokens for training, 2·N_active·tokens for decode."""
    n_active = cfg.active_param_count()
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        mult = 6.0
    elif shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape_cfg.global_batch
        mult = 2.0
    return mult * n_active * tokens / n_devices
