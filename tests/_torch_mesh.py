"""Spawned gloo rank groups for the port's mesh tests, and the work each
rank does.

``run_ranks`` starts ``world`` Python processes, one per rank, with a
``file://`` rendezvous under the test's temp dir (fixed TCP ports would
collide across pytest-xdist workers), runs one function of this module on
every rank inside an initialised gloo group, and returns each rank's
return value.  The ranks import torch, numpy and the port only: the
tests compute the JAX package's answers in their own process and compare.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.core.engine import VertexProgram

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def start_ranks(world: int, func: str, tmp_path, **kwargs):
    """Start ``func(**kwargs)`` of this module on ``world`` gloo ranks; the
    returned handle is read by :func:`wait_ranks`."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                 if p]),
        WORLD_SIZE=str(world), MESH_TEST_DIR=str(tmp), MESH_TEST_FUNC=func,
        OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import _torch_mesh; _torch_mesh._rank_main()"],
                env=dict(env, RANK=str(r)), stdout=log, stderr=subprocess.STDOUT))
    return tmp, procs


def wait_ranks(handle, timeout: float) -> list:
    """Every rank's return value, in rank order; kills the group and raises
    with the logs' tails if a rank fails or the group outlives ``timeout``."""
    tmp, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- rank {r} rc={procs[r].returncode}\n"
                          + (tmp / f"rank{r}.log").read_text()[-3000:] for r in bad)
        raise AssertionError(f"ranks {bad} failed or timed out\n{tails}")
    out = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(world: int, func: str, tmp_path, timeout: float = 240, **kwargs) -> list:
    return wait_ranks(start_ranks(world, func, tmp_path, **kwargs), timeout)


def _rank_main() -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmp = Path(os.environ["MESH_TEST_DIR"])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    with open(tmp / "args.pkl", "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}",
                            world_size=world, rank=rank)
    try:
        out = globals()[os.environ["MESH_TEST_FUNC"]](**kwargs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------ rank work
def _graph(fields):
    from repro_torch import carry

    return carry.graph_from_numpy(fields, device="cpu")


def result_map(res: dict) -> dict:
    return {q: {k: np.asarray(v) for k, v in r.items()} for q, r in res.items()}


def stats_of(eng) -> tuple:
    s = eng.stats
    return (s.super_rounds, s.barriers, s.queries_done, s.supersteps_total)


class Probe(VertexProgram):
    """``steps`` supersteps of one semiring's propagation from a
    query-seeded state (the JAX mesh tests' probe, batched over slots)."""

    def __init__(self, sr, steps=3):
        self.sr = sr
        self.steps = steps

    def init(self, graph, query, index=None):
        import torch

        dt = torch.float32 if self.sr.name == "sum_times" else torch.int32
        x = torch.full((query.shape[0], graph.n), self.sr.identity(dt), dtype=dt,
                       device=query.device)
        x[torch.arange(query.shape[0]), query[:, 0].long() % graph.n] = (
            1.0 if dt == torch.float32 else 0)
        return dict(x=x)

    def superstep(self, state, ctx):
        y = ctx.propagate(self.sr, state["x"])
        return dict(x=self.sr.add(state["x"], y)), ctx.step >= self.steps

    def extract(self, state, query):
        return dict(x=state["x"])


def run_staged(eng) -> tuple:
    """3 queries with mid-stream admission under capacity 2."""
    for s in (3, 17):
        eng.submit(np.asarray([s], np.int32))
    eng.run_round()
    eng.submit(np.asarray([41], np.int32))
    return result_map(eng.run_until_drained()), stats_of(eng)


def drain_staged(eng, pairs) -> tuple:
    """Four pairs, one round, the rest mid-stream, drained."""
    for p in pairs[:4]:
        eng.submit(np.asarray(p, np.int32))
    eng.run_round()
    for p in pairs[4:]:
        eng.submit(np.asarray(p, np.int32))
    return result_map(eng.run_until_drained()), stats_of(eng)


def propagate_work(g, xs, g3, pairs) -> dict:
    """make_propagate_sharded on a (2, 4) mesh sharding "model", every
    (semiring, partition) of ``xs``; then BFS through propagate_override
    over the sharded MIN_RIGHT propagate of ``g3``."""
    from repro_torch.apps.ppsp import BFSProgram
    from repro_torch.core.distributed import ShardedGraph, make_propagate_sharded
    from repro_torch.core.engine import QuegelEngine
    from repro_torch.core.semiring import BY_NAME, MIN_RIGHT
    from repro_torch.launch.mesh import make_mesh
    import torch

    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {}
    for (name, part), (gkey, x) in xs.items():
        sg = ShardedGraph(_graph(g[gkey]), 4, partition=part)
        prop = make_propagate_sharded(sg, mesh, "model", BY_NAME[name])
        out[name, part] = prop(torch.as_tensor(x)).numpy()
    sg3 = ShardedGraph(_graph(g3), 4, partition="dst")
    prop = make_propagate_sharded(sg3, mesh, "model", MIN_RIGHT)
    eng = QuegelEngine(_graph(g3), BFSProgram(), capacity=4,
                       example_query=np.zeros((2,), np.int32), device="cpu",
                       propagate_override={"default": lambda sr, x, f: prop(x, f)})
    out["bfs"] = [int(eng.query(np.asarray(p, np.int32))["dist"]) for p in pairs]
    return out


def engine_work(g, gf, pairs, g60) -> dict:
    """The mesh engine's parity matrix at w = 8 and the real programs
    (tests/test_sharded_engine.py's subprocess, in the port)."""
    from repro_torch.apps.ppsp import make_bfs_engine, make_bibfs_engine
    from repro_torch.core.engine import QuegelEngine
    from repro_torch.core.semiring import BY_NAME
    from repro_torch.launch.mesh import elastic_mesh, host_device_mesh, make_mesh

    mesh8 = make_mesh((8,), ("w",), device_type="cpu")
    g, gf, g60 = _graph(g), _graph(gf), _graph(g60)
    out = {"meshes": [(tuple(m.shape), tuple(m.mesh_dim_names)) for m in (
        host_device_mesh(device_type="cpu"), elastic_mesh(device_type="cpu"),
        elastic_mesh(min_model=3, device_type="cpu"))]}
    for name in ("min_plus", "min_right", "max_plus", "max_right", "sum_times"):
        gg = gf if name == "sum_times" else g
        for k in (1, 4):
            for part in ("dst", "src"):
                eng = QuegelEngine(gg, Probe(BY_NAME[name]), 2,
                                   example_query=np.zeros((1,), np.int32),
                                   steps_per_round=k, mesh=mesh8, partition=part)
                out["probe", name, part, k] = run_staged(eng) + (
                    eng.collective_bytes_per_round(),)
    mesh24 = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out["bfs24"] = drain_staged(make_bfs_engine(g, capacity=3, mesh=mesh24), pairs)
    for k in (1, 4):
        for part in ("dst", "src"):
            eng = make_bibfs_engine(g, capacity=3, steps_per_round=k, mesh=mesh8,
                                    partition=part)
            out["bibfs", part, k] = drain_staged(eng, pairs) + (
                eng.collective_bytes_per_round(),)
    try:
        make_bfs_engine(g60, capacity=2, mesh=mesh8)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    out["padded"] = drain_staged(make_bfs_engine(g60.padded(8), capacity=3, mesh=mesh8),
                                 pairs)
    return out


def mutation_work(g0) -> dict:
    """tests/test_mutation.py's two SPMD scripts in the port: queries in
    flight across two deltas, with constant editions and with
    arg_carried=True (its spliced partitions and shape accounting)."""
    import torch

    from repro_torch.apps.ppsp import make_bfs_engine
    from repro_torch.core.distributed import ShardedGraph
    from repro_torch.launch.mesh import make_mesh

    mesh8 = make_mesh((8,), ("w",), device_type="cpu")
    g0 = _graph(g0)
    q = lambda s, t: np.asarray([s, t], np.int32)
    out = {}

    eng = make_bfs_engine(g0, capacity=3, mesh=mesh8)
    ids = [eng.submit(q(48, 59)), eng.submit(q(48, 57))]
    eng.run_round()
    out["pin_live"] = int(np.asarray(eng.runtime.live).sum())
    eng.apply_delta(adds=[(48, 58)])
    ids.append(eng.submit(q(48, 59)))
    eng.run_round()
    eng.apply_delta(adds=[(0, 59)], dels=[(48, 58)])
    ids.append(eng.submit(q(48, 59)))
    res = result_map(eng.run_until_drained())
    out["pin"] = [res[i] for i in ids]

    eng = make_bfs_engine(g0, capacity=3, mesh=mesh8, arg_carried=True)
    ids = [eng.submit(q(48, 59))]
    eng.run_round()
    out["ac_live"] = int(np.asarray(eng.runtime.live).sum())
    eng.apply_delta(adds=[(48, 58)])
    ids.append(eng.submit(q(48, 59)))
    eng.run_round()
    eng.apply_delta(adds=[(0, 59)], dels=[(48, 58)])
    ids.append(eng.submit(q(48, 59)))
    res = result_map(eng.run_until_drained())
    out["ac"] = [res[i] for i in ids]
    out["ac_shape_changes"] = eng.stats.shape_changes
    be = eng._editions[eng._current_version].backends["default"]
    full = ShardedGraph(eng.graph, 8, partition=be.sg.partition)
    out["ac_emax"] = (int(be.sg.srcp.shape[1]), int(
        ShardedGraph(g0, 8).srcp.shape[1]))
    out["ac_rows_equal"] = all(
        torch.equal(a[r][be.sg.valid[r]], b[r][full.valid[r]])
        for r in range(8)
        for a, b in ((be.sg.srcp, full.srcp), (be.sg.dstp, full.dstp), (be.sg.wp, full.wp)))
    return out


def sharding_work(batch, quegel) -> dict:
    """The sharding layer on a (2, 2) ("data", "model") mesh: the
    placements ``shard`` gives a DTensor; one train step of reduced
    tinyllama on DTensors placed by ``param_spec`` (its loss, gradient
    norm, new state as full tensors, and the collectives it issued);
    and the Quegel super-round on a (1, 4) mesh."""
    import dataclasses

    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import SHAPES, get_arch, reduced
    from repro_torch.core.runtime import tree_map
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import dryrun_quegel as DQ
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as MC
    from repro_torch.models import transformer as T

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    MC.set_mesh(mesh)
    out = {"shard": []}
    for shape, names, tp in SHARD_CASES:
        MC.set_tp(tp)
        x = distribute_tensor(torch.arange(float(np.prod(shape))).reshape(shape), mesh,
                              MC.placements(mesh, MC.Spec(*[None] * len(shape))))
        y = MC.shard(x, *names)
        out["shard"].append(([repr(p) for p in y.placements],
                             bool(torch.equal(y.full_tensor(), x.full_tensor()))))
    MC.set_tp(True)

    cfg = dataclasses.replace(reduced(get_arch("tinyllama-1.1b")), vocab=512)
    sc = dataclasses.replace(SHAPES["train_4k"], seq_len=batch["tokens"].shape[1],
                             global_batch=batch["tokens"].shape[0])
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step, args = DR.place_step_inputs(
        cfg, sc, mesh, ("data",), n_micro=2, params=params,
        batch={k: torch.as_tensor(v) for k, v in batch.items()})
    (p, o, m), counts = DR.run_counted(step, args, mesh)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    out["step"] = (tree_map(full, p), tree_map(full, o), tree_map(full, m))
    out["coll"] = counts["coll_detail"]

    qmesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    ins = DQ.distribute_inputs(quegel, qmesh)
    res = DQ.super_round(*ins, mesh=qmesh)
    out["quegel"] = [full(t).numpy() for t in res]
    MC.set_mesh(None)
    return out


# (global shape, logical names, TP on) for ``shard`` on the (2, 2)
# ("data", "model") mesh: even and indivisible dims, surplus names, and
# pure DP's batch over the whole mesh degrading to its divisible prefix.
# The placements they must give come from JAX's ``shard`` on the same mesh.
SHARD_CASES = [
    ((4, 6, 8), ("batch", "seq", "heads"), True),
    ((4, 6, 8), ("batch", None, "vocab"), True),
    ((3, 6, 8), ("batch", None, "ffn"), True),
    ((4, 6, 5), ("batch", None, "heads"), True),
    ((4, 8), ("batch", "seq_shard"), True),
    ((2, 8), ("batch", "heads", "ffn"), True),
    ((6,), ("experts",), True),
    ((4, 6), ("batch", None), False),
    ((2, 6), ("batch", None), False),
    ((4, 8), (None, "heads"), False),
]
