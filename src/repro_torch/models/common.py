"""Shared model components (``repro.models.common``): the logical-axis
sharding layer, norms, RoPE, init.

The sharding layer is the JAX module's over torch's ``DeviceMesh`` and
DTensor placements.  Model code names each dim of a tensor with a logical
axis ("batch", "heads", ...); ``_RULES`` binds the names to mesh dims;
``shard`` moves a DTensor to the placements that follow; ``param_spec``
picks a parameter's placement by its naming convention.  With no mesh
registered (``set_mesh``), or on a plain tensor, every function is a
no-op, as in JAX, so the single-device numbers are the same.

A spec (``Spec``) is a tuple with one entry per tensor dim: ``None``, a
mesh dim's name, or a tuple of names; as a tuple it equals the JAX
package's ``PartitionSpec``.  ``placements`` turns it into one DTensor
``Shard``/``Replicate`` per mesh dim.

The layers are plain functions on tensors, computed in the JAX package's
dtypes: norms and rotary angles in float32, results cast back to the
input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

# ------------------------------------------------------------- sharding
# Logical-axis rules (MaxText-style).  Model code annotates tensors with
# logical names; the launcher binds them to mesh dims.  With no mesh
# registered (unit tests, one device) the constraints are no-ops.
_MESH = None
_RULES = {
    "batch": ("pod", "data"),
    "seq": None,  # full activations keep seq replicated
    "seq_shard": "model",  # sequence-parallel residual boundaries
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "fsdp": "data",  # parameter second-axis sharding (ZeRO-ish)
    "none": None,
}


class Spec(tuple):
    """One entry per tensor dim: None, a mesh dim's name or a tuple of
    names (the JAX package's ``PartitionSpec``, as a tuple: a one-name
    tuple is that name)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


_TP_ENABLED = True


def set_mesh(mesh, rules: Optional[dict] = None):
    """Register ``mesh`` (a ``DeviceMesh`` with named dims, or None) for
    every function of this layer."""
    global _MESH, _RULES
    _MESH = mesh
    if rules:
        _RULES = {**_RULES, **rules}


_FSDP_PARAMS = True


def set_fsdp(enabled: bool):
    """Parameter-FSDP switch (ZeRO-3 vs ZeRO-1).  Disabled: parameters are
    TP-only, while optimizer moments stay data-sharded
    (``param_spec(force_fsdp=True)``): ZeRO-1."""
    global _FSDP_PARAMS
    _FSDP_PARAMS = enabled


def set_tp(enabled: bool):
    """Tensor-parallelism switch.  Small models (< ~1.5B params) replicate
    their weights and run pure DP: the whole mesh is one data axis.  The
    launcher picks this per architecture (``launch/dryrun.py::lower_cell``)."""
    global _TP_ENABLED
    _TP_ENABLED = enabled


def get_mesh():
    return _MESH


def _axis_names() -> tuple:
    return tuple(_MESH.mesh_dim_names) if _MESH is not None else ()


def _axis_size(name: str) -> int:
    if _MESH is None or name not in _axis_names():
        return 1
    return int(_MESH.shape[_axis_names().index(name)])


def logical_spec(*names: Optional[str]) -> Spec:
    axes = []
    for nm in names:
        if nm is None:
            axes.append(None)
            continue
        ax = _RULES.get(nm, None)
        if not _TP_ENABLED:
            if nm == "batch":
                # pure DP: the whole mesh is one data axis
                ax = ("pod", "data", "model")
            elif ax == "model" or (isinstance(ax, tuple) and "model" in ax):
                ax = None
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a in _axis_names())
            ax = ax if ax else None
        elif ax is not None and ax not in _axis_names():
            ax = None
        axes.append(ax)
    return Spec(*axes)


def placements(mesh, spec: Sequence) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim d
    names that mesh dim in ``spec``, else ``Replicate()``.  A tensor dim
    over several mesh dims is split in mesh-dim order, as JAX splits it
    in the tuple's (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the sharding layer acts only on those)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _fit(spec: Sequence, shape: Sequence[int]) -> Spec:
    """``spec`` cut to ``shape``: axes whose mesh extent does not divide
    their tensor dim are dropped, and a tuple axis degrades to its longest
    divisible prefix (a B=32 batch on a ('data','model')=256 product still
    shards 16-way over 'data'), as in JAX, where constraining e.g. 8 heads
    onto a 16-way axis makes the partitioner split neighbouring dims."""
    fixed = []
    for dim, ax in enumerate(spec):
        if dim >= len(shape):
            break  # surplus names (e.g. a 2-D call site of a 3-D helper)
        if ax is None:
            fixed.append(None)
            continue
        axes = list((ax,) if isinstance(ax, str) else ax)
        while axes:
            n = 1
            for a in axes:
                n *= _axis_size(a)
            if n and shape[dim] % n == 0:
                break
            axes.pop()
        fixed.append(tuple(axes) if axes else None)
    return Spec(*fixed)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``pl``, and the gradient to ``pl`` too: JAX's sharding
    constraint transposes to the same constraint on the cotangent, where
    DTensor's ``redistribute`` alone leaves the gradient's placement to
    the ops that produce it."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(_MESH, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(_MESH, ctx.pl), None


def shard(x, *names: Optional[str]):
    """Redistribute a DTensor, and its gradient, to the placements its
    logical names give (the JAX package's ``with_sharding_constraint``,
    cut by ``_fit``); a no-op without a mesh or on a plain tensor."""
    if _MESH is None or not is_dtensor(x):
        return x
    return _Constrain.apply(x, placements(_MESH, _fit(logical_spec(*names), x.shape)))


def local_map_batch(fn, batched: Sequence, rest: Sequence = (), n_out: int = 1):
    """``fn(*batched, *rest)`` on each rank's local shards: every tensor of
    ``batched`` split on dim 0 over the logical 'batch' axes (cut by
    ``_fit``), every DTensor of ``rest`` replicated, and the ``n_out``
    results split on dim 0 as the first input is.  For the ops DTensor
    has no sharding rule for (sorts, scatters, index writes, sequential
    scans), or whose rule materialises a global-size tensor, which are
    local to a batch row: the redistribution of the inputs is this call's
    only collective.  A gradient of a ``rest`` input is a partial sum
    over the batch's mesh dims (each rank saw its own rows).  Plain
    tensors, or no mesh: ``fn`` itself."""
    if _MESH is None or not any(is_dtensor(t) for t in (*batched, *rest)):
        return fn(*batched, *rest)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    bp = placements(_MESH, _fit(logical_spec("batch"), batched[0].shape[:1]))
    rep = (Replicate(),) * len(bp)
    part = tuple(Partial() if p == Shard(0) else Replicate() for p in bp)
    ins = [bp] * len(batched) + [rep if is_dtensor(t) else None for t in rest]
    grads = [bp] * len(batched) + [part if is_dtensor(t) else None for t in rest]
    return local_map(fn, out_placements=(bp,) * n_out, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), redistribute_inputs=True,
                     device_mesh=_MESH)(*batched, *rest)


def divides_model(n: int) -> bool:
    """True when ``n`` splits evenly over the TP axis (or there is none)."""
    if _MESH is None or not _TP_ENABLED or "model" not in _axis_names():
        return True
    return n % _axis_size("model") == 0


def batch_shards() -> int:
    """Number of shards of the logical 'batch' axis on the current mesh —
    the block count for shard-local MoE dispatch (mlp.moe)."""
    if _MESH is None:
        return 1
    spec = logical_spec("batch")
    ax = spec[0] if spec else None
    if ax is None:
        return 1
    n = 1
    for a in (ax,) if isinstance(ax, str) else ax:
        n *= _axis_size(a)
    return n


def param_sharding(path: str, shape: Sequence[int]):
    """A parameter's DTensor placements by naming convention (``param_spec``);
    None without a mesh."""
    if _MESH is None:
        return None
    return placements(_MESH, param_spec(path, shape))


def param_spec(path: str, shape: Sequence[int], *, force_fsdp: bool = False) -> Spec:
    """TP ('model') on the parallel dim + FSDP ('data') on another dim.

    Naming convention in param paths:
      *_colp : column-parallel (last dim sharded over model)  e.g. wq, w_up
      *_rowp : row-parallel (first matmul dim sharded)        e.g. wo, w_down
      *_embed: vocab dim sharded over model
      *_exp  : experts dim sharded over model (EP)
      *_rep  : replicated

    Dims that don't divide the mesh axis fall back to the next candidate
    dim or stay replicated.
    """
    nd = len(shape)
    if not _TP_ENABLED:
        if force_fsdp:  # ZeRO-1 moments of a pure-DP model
            dsz = _axis_size("data")
            if dsz > 1 and nd:
                s, i = max((s, i) for i, s in enumerate(shape))
                if s % dsz == 0 and s >= 1024:
                    axes = [None] * nd
                    axes[i] = "data"
                    return Spec(*axes)
        return Spec(*([None] * nd))  # pure DP: replicate weights
    msz = _axis_size("model")
    candidates: list[int] = []
    if path.endswith("_colp"):
        candidates = [nd - 1, max(nd - 2, 0)]
    elif path.endswith("_rowp"):
        candidates = [max(nd - 2, 0), nd - 1]
    elif path.endswith("_embed"):
        # vocab dim only (the JAX package's rule: its partitioner mis-lowers
        # a d_model-sharded token gather); odd vocab sizes replicate
        candidates = [0] if nd == 2 else []
    elif path.endswith("_exp"):
        candidates = ([1, nd - 1] if nd >= 4 else [0, nd - 1]) if nd >= 3 else []
    model_dim = None
    for c in candidates:
        if shape[c] % msz == 0 and shape[c] >= msz:
            model_dim = c
            break
    axes: list = [None] * nd
    if model_dim is not None:
        axes[model_dim] = "model"
        # FSDP over 'data' on the largest remaining dim if divisible
        # (always applied to optimizer moments via force_fsdp = ZeRO-1)
        if force_fsdp or _FSDP_PARAMS:
            dsz = _axis_size("data")
            rest = [(s, i) for i, s in enumerate(shape) if i != model_dim]
            if rest:
                s, i = max(rest)
                if dsz > 1 and s % dsz == 0 and s >= 1024:
                    axes[i] = "data"
    return Spec(*axes)


# ----------------------------------------------------------------- layers
def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion: a bfloat16 x float32 product
    is computed and returned in float32 (torch's ``matmul`` wants one
    dtype, so the narrower operand is cast up)."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in the promoted dtype of both operands, as
    JAX's ``einsum`` takes mixed dtypes (torch's wants one)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope_angles(positions, dh: int, theta: float = 10000.0):
    """The (cos, sin) of RoPE's angles, (B|1, S, 1, Dh/2) float32, for
    positions (S,) or (B, S) int32: computed once, they serve every layer
    and both q and k."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None]  # (1, S)
    f = pos[:, :, None] * inv[None, None, :]  # (B|1, S, Dh/2)
    return torch.cos(f)[:, :, None, :], torch.sin(f)[:, :, None, :]


def rotate(x, angles):
    """RoPE with precomputed ``rope_angles``. x: (B, S, H, Dh)."""
    c, s = angles
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """RoPE computed on the fly (no table).

    x: (B, S, H, Dh); positions: (S,) or (B, S) int32."""
    return rotate(x, rope_angles(positions, x.shape[-1], theta))


def sinusoidal_embed(positions, d_model: int):
    """Whisper-style sinusoidal position embeddings. positions: (S,) or (B,S)."""
    half = d_model // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16):
    """Normal x 1/sqrt(fan_in), drawn in float32 from ``generator`` on its
    device, then cast to ``dtype``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(std).to(dtype)  # in place: no second float32 copy
