"""Production-mesh dry run (``repro.launch.dryrun``): trace every (arch x
shape x mesh) cell's step on DTensors over a fake process group.

The JAX package lowers and compiles each cell for 512 placeholder devices.
Here the step runs once on a ``torch.distributed`` "fake" group of 256
(the (32, 8) ``("data", "model")`` mesh) or 512 ranks (the (2, 32, 8)
``("pod", "data", "model")`` mesh, ``launch/mesh.py``) under
``FakeTensorMode``: parameters, optimizer state, cache and batch are fake
DTensors placed by ``param_spec`` and the specs below, no device memory
is allocated, and every collective is a no-op that is still counted.
Rank 0's view is every rank's: each one holds shards of the same shapes.

What the trace gives (``launch/roofline.py``): per-device matmul FLOPs,
unfused op bytes and collective result bytes from ``CostMode`` over the
local ops, and the per-device peak from ``MemTracker``, which tracks the
local shards' storages under fake mode: ``arg_bytes`` are the inputs'
local shards, ``temp_bytes`` the tracked peak less them.  The roofline's
costs come from ``extrapolated_cost`` (two unrolled traces of one and two
super-blocks), as in JAX, where XLA counts a scan body once; an eager
trace counts every layer, so here it equals the full trace's count, which
the result also holds (``full_count``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out runs/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cell_is_supported, get_arch, input_specs, list_archs
from repro_torch.core.runtime import tree_leaves, tree_map
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MESH_NAMES, make_production_mesh
from repro_torch.models import common as MC
from repro_torch.models import transformer as T
from repro_torch.models.common import Spec, param_spec, set_mesh
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _name(path) -> str:
    """The leaf's key: the last dict key on its path."""
    return next(str(p) for p in reversed(path) if isinstance(p, str))


def _size(mesh, name: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(name)])


def params_shardings(mesh, tree, force_fsdp: bool = False):
    """Every parameter's ``Spec`` by its name (``param_spec``)."""
    return _map_with_path(
        lambda path, leaf: param_spec(_name(path), tuple(leaf.shape), force_fsdp=force_fsdp),
        tree)


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return False
    axes = (axes,) if isinstance(axes, str) else axes
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return dim % n == 0


def cache_shardings(mesh, tree, batch_axes):
    """Decode-cache ``Spec``s: batch over the data axes; the sequence (KV
    caches) or state heads over 'model'.  Stacked cache leaves (under
    "blocks") carry a leading super-block dim that stays unsharded."""

    def one(path, leaf):
        name = _name(path)
        off = 1 if path[0] == "blocks" else 0  # layer-stack dim of stacked blocks
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd > off:
            spec[off] = batch_axes if _fits(shape[off], mesh, batch_axes) else None
        msz = _size(mesh, "model")
        if name in ("k", "v", "ckv", "krope") and nd >= off + 2 and shape[off + 1] % msz == 0:
            spec[off + 1] = "model"  # sequence-sharded KV cache (flash-decode)
        elif name == "state" and nd >= off + 2 and shape[off + 1] % msz == 0:
            spec[off + 1] = "model"  # SSM state heads
        elif name in ("h",) and shape[-1] % msz == 0:
            spec[-1] = "model"
        elif name == "conv" and shape[-1] % msz == 0:
            spec[-1] = "model"
        return Spec(*spec)

    return _map_with_path(one, tree)


def batch_shardings(mesh, specs, batch_axes):
    out = {}
    for k, v in specs.items():
        spec = [None] * len(v.shape)
        spec[0] = batch_axes if _fits(v.shape[0], mesh, batch_axes) else None
        if spec[0] is None and len(v.shape) >= 2 and _fits(v.shape[1], mesh, ("model",)):
            spec[1] = "model"  # long-context single-seq: shard sequence
        out[k] = Spec(*spec)
    return out


def pick_n_micro(cfg, shape_cfg, n_data: int) -> int:
    if shape_cfg.kind != "train":
        return 1
    per_dev = shape_cfg.global_batch // n_data
    # keep per-microbatch device tokens bounded for activation headroom;
    # cross-attention multiplies every token's activations by encoder_seq,
    # so enc-dec models microbatch much harder.
    budget = 4096 if cfg.cross_attention else 16384
    tokens = per_dev * shape_cfg.seq_len
    n_micro = 1
    while tokens // n_micro > budget and n_micro < per_dev:
        n_micro *= 2
    return n_micro


def _distribute(mesh, tree, specs):
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, s: distribute_tensor(t, mesh, MC.placements(mesh, s),
                                                   src_data_rank=None), tree, specs)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum((x.to_local() if isinstance(x, DTensor) else x).nbytes
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def place_step_inputs(cfg, sc, mesh, batch_axes, n_micro: int = 1, params=None, batch=None):
    """(step, args): the cell's step function and its DTensor arguments on
    the mesh's device type.  ``params`` and ``batch`` default to tensors
    drawn here (under fake mode they are fake); the moments are
    data-sharded (ZeRO-1) even when the parameters are TP-only."""
    device = mesh.device_type
    if params is None:
        params = T.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    p = _distribute(mesh, params, params_shardings(mesh, params))
    if batch is None:
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in input_specs(cfg, sc).items()}
    b = _distribute(mesh, batch, batch_shardings(mesh, batch, batch_axes))
    if sc.kind == "train":
        opt = adamw_init(params, OptConfig())
        o = dict(step=_distribute(mesh, opt["step"], Spec()),
                 mu=_distribute(mesh, opt["mu"], params_shardings(mesh, params, True)),
                 nu=_distribute(mesh, opt["nu"], params_shardings(mesh, params, True)))
        return make_train_step(cfg, OptConfig(), n_micro=n_micro), (p, o, b)
    if sc.kind == "prefill":
        return (lambda p_, b_: T.prefill(p_, cfg, b_)), (p, b)
    cache = T.init_cache(cfg, sc.global_batch, sc.seq_len, device=device)
    c = _distribute(mesh, cache, cache_shardings(mesh, cache, batch_axes))
    return ((lambda p_, c_, t_, pos_: T.serve_step(p_, cfg, c_, t_, pos_)),
            (p, c, b["tokens"], b["pos"]))


def run_counted(step, args, mesh):
    """Run ``step(*args)`` with every plain tensor taken as replicated,
    under ``CostMode`` and ``MemTracker``.  Returns (result, counts)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    arg_bytes = _local_bytes(args)
    mt = MemTracker()
    mt.track_external(*[x.to_local() if hasattr(x, "to_local") else x
                        for x in tree_leaves(args) if isinstance(x, torch.Tensor)])
    with implicit_replication(), RL.CostMode(mesh) as cm, mt:
        out = step(*args)
    peak = max((d.get("Total", 0) for d in mt.get_tracker_snapshot("peak").values()),
               default=0)
    coll = cm.collectives()
    return out, dict(flops=float(cm.local_flops), bytes=float(cm.local_bytes),
                     coll=float(coll["total"]), coll_detail=coll,
                     peak_bytes=float(peak), arg_bytes=float(arg_bytes),
                     out_bytes=float(_local_bytes(out)))


def _lower_one(cfg, sc, mesh, batch_axes, n_micro):
    """Trace the step of one config variant under fake tensors, on the
    mesh's device type (``CostMode`` counts a CPU mesh's Shard-to-Shard
    all-gather as the all-to-all a CUDA mesh issues); its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        step, args = place_step_inputs(cfg, sc, mesh, batch_axes, n_micro)
        _, counts = run_counted(step, args, mesh)
    return counts


def extrapolated_cost(cfg, sc, mesh, batch_axes):
    """Totals from two small *unrolled* traces: cost(L=2*plen) - cost(L=plen)
    is one super-block; total = cost(plen) + delta * (n_layers/plen - 1).
    FLOPs of microbatch accumulation do not depend on n_micro (same total
    tokens), so the small traces use n_micro=1.  (XLA counts a scan body
    once, which is why the JAX package needs this; an eager trace counts
    every layer, so here it equals the full count.)"""
    plen = T._plen(cfg)
    c1 = dc.replace(cfg, n_layers=plen, scan_layers=False)
    c2 = dc.replace(cfg, n_layers=2 * plen, scan_layers=False)
    costs = [_lower_one(c, sc, mesh, batch_axes, n_micro=1) for c in (c1, c2)]
    n_blocks = cfg.n_layers / plen
    out = {}
    for k in ("flops", "bytes", "coll"):
        delta = costs[1][k] - costs[0][k]
        out[k] = costs[0][k] + delta * (n_blocks - 1)
    out["per_block"] = {k: costs[1][k] - costs[0][k] for k in ("flops", "bytes", "coll")}
    out["coll_detail"] = costs[1]["coll_detail"]
    return out


def parallelism(cfg, sc, mesh, multi_pod: bool):
    """The size-aware policy (JAX's): pure DP under 1.5e9 parameters
    (``set_tp``), FSDP parameters above 6e9 bytes per TP shard (else
    ZeRO-1: TP-only parameters, data-sharded moments), and the first
    batch-axis candidate that divides the global batch.  Sets the policy
    and returns (batch_axes, n_micro)."""
    use_tp = cfg.param_count() >= 1.5e9
    MC.set_tp(use_tp)
    tp_deg = _size(mesh, "model") if use_tp else 1
    MC.set_fsdp(cfg.param_count() * 2 / tp_deg > 6e9)
    if use_tp:
        cand = [("pod", "data"), ("data",)] if multi_pod else [("data",)]
    else:
        cand = ([("pod", "data", "model"), ("data", "model"), ("pod", "data"), ("data",)]
                if multi_pod else [("data", "model"), ("data",)])
    batch_axes = cand[-1]
    for c in cand:
        if _fits(sc.global_batch, mesh, c):
            batch_axes = c
            break
    n_data = 1
    for a in batch_axes:
        n_data *= _size(mesh, a)
    return batch_axes, pick_n_micro(cfg, sc, n_data)


def lower_cell(arch: str, shape: str, multi_pod: bool = False, compile_: bool = True,
               verbose: bool = True, cfg_override=None):
    """One cell on the production mesh (the fake group must be up,
    ``fake_group``)."""
    cfg = cfg_override or get_arch(arch)
    sc = SHAPES[shape]
    ok, reason = cell_is_supported(cfg, sc)
    mesh_name = MESH_NAMES[multi_pod]
    if not ok:
        return dict(arch=arch, shape=shape, mesh=mesh_name, status="skipped", reason=reason)
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    set_mesh(mesh)
    batch_axes, n_micro = parallelism(cfg, sc, mesh, multi_pod)
    result = dict(arch=arch, shape=shape, mesh=mesh_name, status="lowered",
                  n_micro=n_micro, batch_axes=list(batch_axes),
                  lower_s=round(time.time() - t0, 1), traced_on=traced_on(mesh))
    if not compile_:
        return result
    full = _lower_one(cfg, sc, mesh, batch_axes, n_micro)
    memory = dict(temp_bytes=max(full["peak_bytes"] - full["arg_bytes"], 0.0),
                  arg_bytes=full["arg_bytes"], out_bytes=full["out_bytes"],
                  peak_bytes=full["peak_bytes"])
    result.update(status="compiled", compile_s=round(time.time() - t0, 1), memory=memory,
                  full_count={k: full[k] for k in ("flops", "bytes", "coll")})
    if verbose:
        print(f"  memory (fake-traced, per device): {memory}")
    if multi_pod:
        # the multi-pod pass proves the 'pod' axis shards; the roofline
        # table is single-pod only, as in JAX
        return result
    cost = extrapolated_cost(cfg, sc, mesh, batch_axes)
    rl = RL.Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops=cost["flops"], bytes_accessed=cost["bytes"],
        coll_bytes=cost["coll"], coll_detail=cost["coll_detail"],
        model_flops=RL.model_flops_per_device(cfg, sc, mesh.size()),
        peak_mem_bytes=memory["temp_bytes"],
    )
    result["roofline"] = rl.to_dict()
    if verbose:
        print(f"  cost (fake-traced): flops/dev={rl.flops:.3e} bytes/dev={rl.bytes_accessed:.3e} "
              f"coll/dev={rl.coll_bytes:.3e}")
        print(f"  roofline: compute={rl.t_compute*1e3:.2f}ms memory={rl.t_memory*1e3:.2f}ms "
              f"collective={rl.t_collective*1e3:.2f}ms -> {rl.bottleneck}"
              f" (useful={rl.useful_ratio:.2f}, frac={rl.roofline_fraction:.2f})")
    return result


def traced_on(mesh, lm: bool = True) -> dict:
    """What a result's counts were traced on, for its JSON: the fake
    group's mesh type, how its Shard-to-Shard moves are counted
    (``CostMode``), and, for an LM step, where the port's collectives
    exceed GSPMD's."""
    out = dict(mesh_device_type=mesh.device_type, world=mesh.size(),
               counts="fake-traced, not measured",
               shard_to_shard="all-gather + chunk on a cpu mesh, counted as the "
                              "all-to-all a cuda mesh issues")
    if lm:
        out["open"] = ("a sharded embedding table is gathered whole for the lookup, and "
                       "vocab-sharded (B, S, V) logits are gathered over 'model' for the "
                       "loss, where GSPMD does a masked lookup and a sharded log-softmax")
    return out


def fake_group(world: int) -> None:
    """Start a ``world``-rank fake process group (this process is rank 0);
    its collectives do nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    cells = []
    for mp in meshes:
        import torch.distributed as dist

        fake_group(512 if mp else 256)
        try:
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}_{shape}_{'mp' if mp else 'sp'}"
                    print(f"[dryrun] {tag}", flush=True)
                    try:
                        res = lower_cell(arch, shape, multi_pod=mp,
                                         compile_=not args.no_compile)
                    except Exception as e:  # one cell's failure is reported, the sweep goes on
                        traceback.print_exc()
                        res = dict(arch=arch, shape=shape, mesh=MESH_NAMES[mp],
                                   status="FAILED", error=f"{type(e).__name__}: {e}")
                        failures += 1
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(res, f, indent=2, default=str)
                    print(f"  -> {res['status']}", flush=True)
                    cells.append(res)
        finally:
            set_mesh(None)
            dist.destroy_process_group()
    print(f"[dryrun] {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
