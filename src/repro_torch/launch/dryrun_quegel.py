"""Pod-scale dry run of the Quegel engine itself (``repro.launch.dryrun_quegel``).

One BiBFS super-round (C concurrent queries, both propagation directions,
distance update, frontier mask, per-slot done flags) with the edges
partitioned by destination block over 'model' and the query slots over
'pod' x 'data', traced under fake tensors on the production mesh
(``launch/mesh.py``) at a Twitter-scale graph, |V| = 2^26 and |E| = 2^31
(the paper's Twitter has 1.96B edges), never allocated.  It reports the
per-device memory and collective bytes, as ``launch/dryrun.py`` does for
the LM cells.  ``super_round`` also runs for real: on a mesh of any size,
or on plain tensors (one partition).

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_quegel [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch.core.semiring import INF
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MESH_NAMES, make_production_mesh


def _combine(x, srcp, dstp, valid, block: int, part: int):
    """One edge partition's combine: each slot's frontier values gathered
    at the edges' sources, min-reduced into the partition's destination
    block (C, block).  Invalid (padding) edges carry INF."""
    msgs = torch.where(valid[0][None], x[:, srcp[0].long()], INF)
    seg = torch.where(valid[0], dstp[0] - part * block, 0).long()
    y = torch.full((x.shape[0], block), INF, dtype=x.dtype, device=x.device)
    return y.scatter_reduce_(1, seg[None].expand_as(msgs), msgs, "amin")


def super_round(srcp, dstp, wp, valid, dist_s, dist_t, ff, fb, live, mesh=None,
                axis: str = "model"):
    """One BiBFS super-round over C slots (JAX's).  On ``mesh`` the inputs
    are DTensors: the (n_parts, Emax) edge arrays sharded over ``axis``,
    the (C, V) states and (C,) ``live`` over the slot axes.  Each rank
    combines its edge partition locally (``scatter_reduce`` amin), and the
    destination blocks are all-gathered over ``axis``.  Without a mesh
    the edge arrays hold one partition.  ``wp`` is carried as in JAX."""
    V = dist_s.shape[1]

    def propagate(x, frontier):
        x = torch.where(frontier, x, INF)
        if mesh is None:
            return _combine(x, srcp, dstp, valid, V, 0)
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        names = list(mesh.mesh_dim_names)
        block = V // mesh.shape[names.index(axis)]
        part = mesh.get_local_rank(axis)
        edge = tuple(Shard(0) if n == axis else Replicate() for n in names)
        out = tuple(Shard(1) if n == axis else p for n, p in zip(names, x.placements))
        y = local_map(lambda x_, s_, d_, v_: _combine(x_, s_, d_, v_, block, part),
                      out_placements=(out,), in_placements=(x.placements, edge, edge, edge),
                      device_mesh=mesh)(x, srcp, dstp, valid)
        return y.redistribute(mesh, x.placements)  # all-gather over ``axis``

    got_f = propagate(dist_s, ff)
    got_b = propagate(dist_t, fb)
    new_f = (got_f < INF) & (dist_s >= INF)
    new_b = (got_b < INF) & (dist_t >= INF)
    dist_s = torch.where(new_f & live[:, None], got_f, dist_s)
    dist_t = torch.where(new_b & live[:, None], got_b, dist_t)
    both = torch.where((dist_s < INF) & (dist_t < INF), dist_s + dist_t, INF)
    best = both.amin(dim=1)
    done = (best < INF) | (~new_f.any(dim=1)) | (~new_b.any(dim=1))
    return dist_s, dist_t, new_f, new_b, done & live


def partition_edges(src: np.ndarray, dst: np.ndarray, n_vertices: int, n_parts: int,
                    emax: int = 0):
    """Edges bucketed by destination block: (srcp, dstp, wp, valid), each
    (n_parts, Emax) (int32; bool), padded with invalid edges; ``emax``
    defaults to the largest bucket."""
    block = n_vertices // n_parts
    part = dst // block
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=n_parts)
    emax = max(emax, int(counts.max(initial=0)))
    srcp = np.zeros((n_parts, emax), np.int32)
    dstp = np.zeros((n_parts, emax), np.int32)
    valid = np.zeros((n_parts, emax), bool)
    start = 0
    for r, c in enumerate(counts):
        idx = order[start:start + c]
        srcp[r, :c], dstp[r, :c], valid[r, :c] = src[idx], dst[idx], True
        start += c
    return srcp, dstp, np.ones_like(srcp), valid


def round_inputs(log_v: int, log_e: int, capacity: int, n_parts: int, seed: int = 0,
                 emax: int = 0):
    """A random graph's partitioned edges and C seeded BiBFS states, as
    numpy arrays in ``super_round``'s order: each slot's source and target
    at distance 0, frontiers on them, every slot live."""
    rng = np.random.default_rng(seed)
    V, E, C = 2 ** log_v, 2 ** log_e, capacity
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    srcp, dstp, wp, valid = partition_edges(src, dst, V, n_parts, emax)
    st = rng.integers(0, V, (C, 2))
    rows = np.arange(C)
    dist_s = np.full((C, V), INF, np.int32)
    dist_t = np.full((C, V), INF, np.int32)
    dist_s[rows, st[:, 0]] = 0
    dist_t[rows, st[:, 1]] = 0
    return (srcp, dstp, wp, valid, dist_s, dist_t, dist_s < INF, dist_t < INF,
            np.ones((C,), bool))


def distribute_inputs(arrays, mesh, axis: str = "model"):
    """``round_inputs``' arrays as DTensors on ``mesh``'s device type (every
    rank passes the same full arrays and keeps its shards)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    names = list(mesh.mesh_dim_names)
    slot_axes = [n for n in ("pod", "data") if n in names]
    edge = [Shard(0) if n == axis else Replicate() for n in names]
    slot = [Shard(0) if n in slot_axes else Replicate() for n in names]
    return [distribute_tensor(torch.as_tensor(a, device=mesh.device_type), mesh,
                              edge if i < 4 else slot, src_data_rank=None)
            for i, a in enumerate(arrays)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--log-v", type=int, default=26)
    ap.add_argument("--log-e", type=int, default=31)
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import fake_group, run_counted, traced_on

    fake_group(512 if args.multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
        axis = "model"
        n_parts = mesh.shape[list(mesh.mesh_dim_names).index(axis)]
        C, V, E = args.capacity, 2 ** args.log_v, 2 ** args.log_e
        emax = E // n_parts
        i32, b8 = torch.int32, torch.bool
        with FakeTensorMode():
            shapes = [((n_parts, emax), i32)] * 3 + [((n_parts, emax), b8)] \
                + [((C, V), i32)] * 2 + [((C, V), b8)] * 2 + [((C,), b8)]
            ins = distribute_inputs([torch.empty(s, dtype=d) for s, d in shapes], mesh, axis)
            _, c = run_counted(lambda *a: super_round(*a, mesh=mesh, axis=axis), ins, mesh)
        trace = traced_on(mesh, lm=False)
    finally:
        dist.destroy_process_group()
    res = dict(
        arch="quegel-bibfs", shape=f"C{C}_V{V}_E{E}",
        mesh=MESH_NAMES[args.multi_pod], status="compiled",
        flops=c["flops"], bytes=c["bytes"], coll_bytes=c["coll"], coll_detail=c["coll_detail"],
        memory=dict(temp_bytes=max(c["peak_bytes"] - c["arg_bytes"], 0.0),
                    arg_bytes=c["arg_bytes"]),
        traced_on=trace,
    )
    rl = RL.Roofline(arch=res["arch"], shape=res["shape"], mesh=res["mesh"], flops=0.0,
                     bytes_accessed=c["bytes"], coll_bytes=c["coll"],
                     coll_detail=c["coll_detail"], model_flops=0.0, peak_mem_bytes=0.0)
    print(f"memory (fake-traced, per device): {res['memory']}")
    print(f"cost (fake-traced): bytes/dev={res['bytes']:.3e} coll/dev={res['coll_bytes']:.3e} "
          f"{c['coll_detail']['by_dim']}")
    print(f"roofline: memory={rl.t_memory*1e3:.1f}ms collective={rl.t_collective*1e3:.1f}ms "
          f"per super-round (C={C} queries share ONE barrier)")
    os.makedirs(args.out, exist_ok=True)
    tag = "mp" if args.multi_pod else "sp"
    with open(os.path.join(args.out, f"quegel-bibfs_{tag}.json"), "w") as f:
        json.dump(res, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
