"""The port's roofline accounting and dry runs against the JAX package's.

Twins of ``tests/test_roofline.py``: the HLO collective parse on the same
text, the roofline terms at the port's H100 constants, and the model
FLOPs.  Then what only the port has: ``CostMode``'s local counts of a
sharded matmul under fake tensors (the DTensor op's global FLOPs divided
by the shards, and the all-gather's result bytes), the dry-run machinery
on an 8-rank fake group with a (2, 4) mesh (reduced tinyllama, arctic and
mamba2 at train shape: nonzero FLOPs and collectives, as JAX's twin
asserts after compiling), ``extrapolated_cost`` against the full count,
and ``compare.py`` / ``rerun_opt.py`` against JAX's on the same JSON."""
import contextlib
import dataclasses as dc
import importlib
import io
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_arch
from repro.launch import roofline as JRL

from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.launch import compare as TCMP
from repro_torch.launch import dryrun as DR
from repro_torch.launch import rerun_opt as TRO
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common as TC

HLO = """
  %ag = f32[8,128]{1,0} all-gather(f32[8,8]{1,0} %x), replica_groups={}
  %ar = bf16[64]{0} all-reduce(bf16[64]{0} %y), to_apply=%add
  %rs = f32[4,4]{1,0} reduce-scatter(f32[4,64]{1,0} %z), dimensions={1}
  %aa = (s32[16]{0}, s32[16]{0}) all-to-all(s32[16]{0} %a, s32[16]{0} %b)
  %cp = u8[100]{0} collective-permute(u8[100]{0} %c)
  %dot = f32[8,8]{1,0} dot(f32[8,8] %p, f32[8,8] %q)
"""


def _jax_launch(name: str):
    """A JAX ``launch`` module that sets XLA_FLAGS when imported, imported
    after this process's backend is up and with the environment restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


# ------------------------------------------------------------- roofline
def test_collective_bytes_parse():
    out = RL.collective_bytes(HLO)
    assert out == JRL.collective_bytes(HLO)
    assert out["all-gather"] == 8 * 128 * 4
    assert out["all-reduce"] == 64 * 2
    assert out["reduce-scatter"] == 4 * 4 * 4
    assert out["all-to-all"] == 16 * 4 * 2
    assert out["collective-permute"] == 100
    assert out["count"] == 5
    assert out["total"] == sum(
        out[k] for k in ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"))


def test_roofline_terms():
    """At the H100 constants each term is 1 s; a collective is charged at
    its mesh dim's link (NVLink for 'model', the network for 'data' and
    for bytes no dim claims)."""
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW, RL.NET_BW) == (989.4e12, 3.35e12,
                                                                  450e9, 50e9)
    r = RL.Roofline(
        arch="a", shape="s", mesh="m",
        flops=989.4e12, bytes_accessed=3.35e12, coll_bytes=50e9,
        coll_detail={}, model_flops=494.7e12, peak_mem_bytes=0,
    )
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.useful_ratio == 0.5
    assert abs(r.roofline_fraction - 0.5) < 1e-9
    for by_dim in ({"model": 450e9}, {"data": 50e9}, {"pod": 50e9},
                   {"model": 225e9, "data": 25e9}):
        r = dc.replace(r, coll_bytes=sum(by_dim.values()), coll_detail={"by_dim": by_dim})
        assert abs(r.t_collective - 1.0) < 1e-9, by_dim


def test_model_flops_train_vs_decode():
    cfg, jcfg = get_arch("tinyllama-1.1b"), j_arch("tinyllama-1.1b")
    for shape in ("train_4k", "decode_32k", "prefill_32k"):
        got = RL.model_flops_per_device(cfg, SHAPES[shape], 256)
        assert got == JRL.model_flops_per_device(jcfg, J_SHAPES[shape], 256)
    tr = RL.model_flops_per_device(cfg, SHAPES["train_4k"], 256)
    de = RL.model_flops_per_device(cfg, SHAPES["decode_32k"], 256)
    n = cfg.active_param_count()
    assert abs(tr - 6 * n * 4096 * 256 / 256) / tr < 1e-6
    assert abs(de - 2 * n * 128 / 256) / de < 1e-6


# ----------------------------------------------------------- fake group
@pytest.fixture
def fake_group():
    import torch.distributed as dist

    yield DR.fake_group
    TC.set_mesh(None)
    TC.set_tp(True)
    TC.set_fsdp(True)
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_matmul_counts_local_flops_and_gather_bytes(fake_group):
    """4096x2048 by 2048x5632, column-sharded over model = 4: the DTensor
    op is 94.49 GFLOP, each device runs a quarter; gathering the result
    is one all-gather of its full size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    fake_group(4)
    mesh = make_mesh((4,), ("model",), device_type="cpu")
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(4096, 2048), mesh, [Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(2048, 5632), mesh, [Shard(1)], src_data_rank=None)
        with RL.CostMode(mesh) as m:
            c = a @ b
        assert m.local_flops == 2 * 4096 * 2048 * 5632 // 4 == int(94.489280512e9 / 4)
        assert m.collectives()["count"] == 0
        assert m.local_bytes == (4096 * 2048 + 2048 * 1408 + 4096 * 1408) * 4
        _, coll = RL.dtensor_collective_bytes(c.redistribute, mesh, [Replicate()], mesh=mesh)
    assert coll["count"] == 1
    assert coll["all-gather"] == coll["total"] == 4096 * 5632 * 4
    assert coll["by_dim"] == {"model": 4096 * 5632 * 4}


def test_cpu_mesh_shard_move_counts_as_the_all_to_all(fake_group):
    """A Shard-to-Shard move on a CPU-typed mesh runs as an all-gather plus
    a chunk (gloo has no all-to-all); it is counted as the one all-to-all
    that a CUDA mesh issues: its result is the size of the local shard,
    and the chunk's copy is no op bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor

    fake_group(4)
    mesh = make_mesh((4,), ("model",), device_type="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 5632), mesh, [Shard(1)], src_data_rank=None)
        with RL.CostMode(mesh) as m:
            y = x.redistribute(mesh, [Shard(0)])
    assert y.placements == (Shard(0),) and y.to_local().shape == (1024, 5632)
    coll = m.collectives()
    assert coll["count"] == 1
    assert coll["all-to-all"] == coll["total"] == 4096 * 1408 * 4
    assert coll["by_dim"] == {"model": 4096 * 1408 * 4}
    assert m.local_bytes == 0 and m.local_flops == 0
    # and the stand-in is gone once the mode exits
    import torch.distributed.tensor.placement_types as PT
    from torch.distributed.tensor._collective_utils import shard_dim_alltoall

    assert PT.shard_dim_alltoall is shard_dim_alltoall


REDUCED_SHAPE = dc.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)


def _reduced(arch, **over):
    return dc.replace(reduced(get_arch(arch)), vocab=512, **over)


def _mesh24(fake_group):
    fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    TC.set_mesh(mesh)
    TC.set_tp(True)
    return mesh


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b", "mamba2-780m"])
def test_dryrun_machinery_reduced_mesh(arch, fake_group):
    """Twin of JAX's test: the step traced on the (2, 4) mesh (n_micro = 2)
    has FLOPs and collectives, and its peak holds its arguments."""
    mesh = _mesh24(fake_group)
    c = DR._lower_one(_reduced(arch), REDUCED_SHAPE, mesh, ("data",), n_micro=2)
    assert c["flops"] > 0 and c["bytes"] > 0, arch
    assert c["coll_detail"]["count"] > 0 and c["coll"] > 0, arch
    assert set(c["coll_detail"]["by_dim"]) <= {"data", "model"}
    assert c["peak_bytes"] >= c["arg_bytes"] > 0


@pytest.mark.parametrize("arch,shape", [("deepseek-v2-236b", "decode_32k"),
                                        ("whisper-base", "train_4k"),
                                        ("recurrentgemma-2b", "train_4k"),
                                        ("llava-next-34b", "decode_32k")])
def test_dryrun_other_families_reduced_mesh(arch, shape, fake_group):
    """MLA decode, the encoder's and cross attention, the RG-LRU scan and a
    sequence-sharded decode cache trace on the (2, 4) mesh with TP."""
    mesh = _mesh24(fake_group)
    sc = dc.replace(SHAPES[shape], seq_len=64, global_batch=4)
    c = DR._lower_one(_reduced(arch), sc, mesh, ("data",), n_micro=1)
    assert c["flops"] > 0 and c["coll_detail"]["count"] > 0, arch


@pytest.mark.parametrize("arch,shape,batch,over", [
    ("deepseek-v2-236b", "prefill_32k", 2, {}),
    ("recurrentgemma-2b", "train_4k", 4, dict(n_heads=3, n_kv_heads=1))])
def test_dryrun_pod_mesh_with_indivisible_batch_and_heads(arch, shape, batch, over,
                                                          fake_group):
    """A (2, 2, 2) ("pod", "data", "model") mesh: a batch of 2 shards only
    over 'pod' (the MoE's rows must come back to that layout before they
    unflatten), and 3 heads do not split over 'model' (nor their
    gradient)."""
    fake_group(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    TC.set_mesh(mesh)
    sc = dc.replace(SHAPES[shape], seq_len=64, global_batch=batch)
    c = DR._lower_one(_reduced(arch, **over), sc, mesh, ("data",), n_micro=1)
    assert c["flops"] > 0 and c["coll_detail"]["count"] > 0, arch


def test_extrapolated_cost_equals_the_full_count(fake_group):
    """Four unrolled layers: the two small traces' extrapolation equals the
    full trace's FLOPs, bytes and collective bytes (an eager trace counts
    every layer); the stacked layout runs the same FLOPs."""
    mesh = _mesh24(fake_group)
    cfg = _reduced("tinyllama-1.1b", n_layers=4, scan_layers=False)
    ext = DR.extrapolated_cost(cfg, REDUCED_SHAPE, mesh, ("data",))
    full = DR._lower_one(cfg, REDUCED_SHAPE, mesh, ("data",), n_micro=1)
    for k in ("flops", "bytes", "coll"):
        assert ext[k] == full[k], k
    stacked = DR._lower_one(dc.replace(cfg, scan_layers=True), REDUCED_SHAPE, mesh,
                            ("data",), n_micro=1)
    assert stacked["flops"] == full["flops"]


# ------------------------------------------------- compare and rerun_opt
def _cell(arch, shape, mesh, counts, scale):
    rl = RL.Roofline(arch=arch, shape=shape, mesh=mesh, flops=counts["flops"] * scale,
                     bytes_accessed=counts["bytes"], coll_bytes=counts["coll"] * scale,
                     coll_detail={}, model_flops=counts["flops"] / 3,
                     peak_mem_bytes=counts["peak_bytes"])
    return dict(arch=arch, shape=shape, mesh=mesh, status="compiled", roofline=rl.to_dict(),
                memory=dict(temp_bytes=counts["peak_bytes"] * scale * 2 ** 20,
                            arg_bytes=counts["arg_bytes"]))


def _write(root, mesh_sp, mesh_mp, counts):
    for d, scale in (("dryrun", 3.0), ("dryrun_opt", 1.0)):
        os.makedirs(root / "runs" / d, exist_ok=True)
        cells = [_cell("tinyllama-1.1b", s, mesh_sp, counts, scale * i)
                 for i, s in enumerate(("train_4k", "decode_32k"), 1)]
        cells.append(_cell("tinyllama-1.1b", "train_4k", mesh_mp, counts, scale))
        cells.append(dict(arch="x", shape="y", mesh=mesh_sp, status="FAILED"))
        for i, c in enumerate(cells):
            with open(root / "runs" / d / f"c{i}.json", "w") as f:
                json.dump(c, f)


def test_compare_prints_what_jax_prints(tmp_path, fake_group, monkeypatch):
    """The same dry-run numbers under each package's mesh names: the
    tables, the geometric mean and the multi-pod line are the same text."""
    jcmp = importlib.import_module("repro.launch.compare")
    mesh = _mesh24(fake_group)
    counts = DR._lower_one(_reduced("tinyllama-1.1b"), REDUCED_SHAPE, mesh, ("data",), 2)
    printed = []
    for pkg, names in ((TCMP, ("gpu32x8", "gpu2x32x8")), (jcmp, ("pod16x16", "pod2x16x16"))):
        root = tmp_path / pkg.__name__
        _write(root, *names, counts)
        monkeypatch.chdir(root)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pkg.main()
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    assert "Geometric-mean bound-time speedup over 2 re-run cells" in printed[0]
    assert "Multi-pod optimized cells compiled: 1" in printed[0]


def test_rerun_opt_cells_equal_jax():
    jro = _jax_launch("repro.launch.rerun_opt")
    assert TRO.cells() == jro.cells()
    assert (TRO.MOE, TRO.ALL, TRO.SUBQ, TRO.DENSE_BIG) == (jro.MOE, jro.ALL, jro.SUBQ,
                                                          jro.DENSE_BIG)
