"""The port's logical-axis sharding layer against the JAX package's.

In-process, with no process group: ``param_spec`` and ``logical_spec``
equal JAX's ``PartitionSpec`` (as tuples) for every parameter leaf of
the ten archs at full size (shapes only), on stub meshes of the four
production shapes (JAX's two TPU pods and the port's two H100 meshes),
with TP, FSDP and ``force_fsdp`` each on and off; the dry run's helpers
(``divides_model``, ``batch_shards``, ``cache_shardings``,
``batch_shardings``, ``pick_n_micro``) equal JAX's for every arch x shape
x mesh.  JAX's functions read only the mesh's axis sizes and names, so
its meshes are ``AbstractMesh``es.  ``kv_shard=True`` attention equals
JAX's without a mesh.

Across ranks: one spawned 4-rank gloo group on a (2, 2) mesh checks the
placements ``shard`` gives DTensors against the specs JAX's ``shard``
gives on a (2, 2) mesh of 4 host devices, runs one train step of reduced
tinyllama on DTensors (equal to the unsharded step within 1e-5 under
``tests/_torch_train.py``'s rule, its collective bytes equal to the same
step's count traced under fake tensors) and the Quegel super-round on a
(1, 4) mesh (bit-equal to JAX's on a 4-device CPU mesh).  JAX's side
runs in one subprocess."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_arch
from repro.configs import input_specs as j_specs
from repro.configs import list_archs
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import transformer as JT

from repro_torch.configs import SHAPES, get_arch, input_specs
from repro_torch.core.runtime import tree_leaves, tree_map
from repro_torch.launch import dryrun as DR
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT

import _torch_mesh
from _torch_train import assert_step_matches

ARCHS = list_archs()
MESHES = {  # name -> (shape, axes)
    "pod16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "gpu32x8": ((32, 8), ("data", "model")),
    "gpu2x32x8": ((2, 32, 8), ("pod", "data", "model")),
}


def _jax_launch(name: str):
    """A JAX ``launch`` module that sets XLA_FLAGS when imported: this
    process's backend is up first, and the environment is restored, so
    neither it nor later subprocesses see 512 host devices."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


JDR = _jax_launch("repro.launch.dryrun")


def _stub(shape, axes):
    """A ``DeviceMesh`` stand-in: the port reads only dim names and sizes."""
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


@pytest.fixture
def policy():
    """Set both packages' mesh and switches; restore them after."""
    def set_(mesh_name, tp=True, fsdp=True):
        shape, axes = MESHES[mesh_name]
        JC.set_mesh(AbstractMesh(shape, axes))
        TC.set_mesh(_stub(shape, axes))
        for mod in (JC, TC):
            mod.set_tp(tp)
            mod.set_fsdp(fsdp)
        return _stub(shape, axes), AbstractMesh(shape, axes)

    yield set_
    for mod in (JC, TC):
        mod.set_mesh(None)
        mod.set_tp(True)
        mod.set_fsdp(True)


def _path_name(path) -> str:
    last = path[-1]
    return str(getattr(last, "key", getattr(last, "idx", last)))


def _jax_leaves(tree):
    return [(_path_name(p), tuple(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree, key=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _port_leaves(v, k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v, key)]
    return [(key, tuple(tree.shape))]


def _spec_leaves(tree):
    """A tree's ``Spec`` leaves in ``tree_leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _port_params(cfg):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _port_cache(cfg, sc):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return TT.init_cache(cfg, sc.global_batch, sc.seq_len, device="cpu")


# ----------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_for_every_leaf(arch, policy):
    jcfg, cfg = j_arch(arch), get_arch(arch)
    want = _jax_leaves(jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _port_leaves(_port_params(cfg))
    assert sorted(got) == sorted(want)
    n = 0
    for mesh in MESHES:
        for tp in (True, False):
            for fsdp in (True, False):
                policy(mesh, tp, fsdp)
                for name, shape in want:
                    for force in (False, True):
                        j = tuple(JC.param_spec(name, shape, force_fsdp=force))
                        t = TC.param_spec(name, shape, force_fsdp=force)
                        assert t == j, (mesh, tp, fsdp, force, name, shape, t, j)
                        n += 1
    assert n == len(want) * 4 * 2 * 2 * 2


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_spec_matches_jax(mesh, policy):
    names = [None] + sorted(TC._RULES) + ["unknown"]
    for tp in (True, False):
        policy(mesh, tp)
        for a in names:
            for b in names:
                assert TC.logical_spec(a, b) == tuple(JC.logical_spec(a, b)), (tp, a, b)
        assert TC.divides_model(56) == JC.divides_model(56)
        assert TC.divides_model(64) == JC.divides_model(64)
        assert TC.batch_shards() == JC.batch_shards()


def test_off_a_mesh_every_function_is_a_no_op():
    x = torch.arange(12.0).reshape(3, 4)
    assert TC.get_mesh() is None
    assert TC.shard(x, "batch", "heads") is x
    assert TC.param_sharding("wq_colp", (4, 4)) is None
    assert TC.param_spec("wq_colp", (4, 4)) == tuple(JC.param_spec("wq_colp", (4, 4)))
    assert TC.divides_model(7) and TC.batch_shards() == 1
    assert torch.equal(TC.local_map_batch(lambda a, b: a + b, [x], [x]), x + x)


# --------------------------------------------------------------- helpers
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_helpers_match_jax(arch, policy):
    """For every shape and mesh, under the cell's own policy (pure DP below
    1.5e9 parameters): the batch axes' specs, the decode cache's specs,
    the microbatch count and the MoE block count."""
    jcfg, cfg = j_arch(arch), get_arch(arch)
    for mesh_name in MESHES:
        stub, amesh = policy(mesh_name)
        for shape in SHAPES:
            sc, jsc = SHAPES[shape], J_SHAPES[shape]
            batch_axes, n_micro = DR.parallelism(cfg, sc, stub, len(stub.shape) == 3)
            JC.set_tp(TC._TP_ENABLED)
            JC.set_fsdp(TC._FSDP_PARAMS)
            n_data = int(np.prod([DR._size(stub, a) for a in batch_axes]))
            assert n_micro == JDR.pick_n_micro(jcfg, jsc, n_data)
            assert TC.batch_shards() == JC.batch_shards()
            assert TC.divides_model(cfg.n_heads) == JC.divides_model(jcfg.n_heads)
            got = DR.batch_shardings(stub, input_specs(cfg, sc), batch_axes)
            want = JDR.batch_shardings(amesh, j_specs(jcfg, jsc), batch_axes)
            assert got == {k: tuple(v.spec) for k, v in want.items()}, (mesh_name, shape)
            if sc.kind != "decode":
                continue
            jc = jax.eval_shape(lambda: JT.init_cache(jcfg, jsc.global_batch, jsc.seq_len))
            want = [tuple(s.spec) for s in jax.tree.leaves(
                JDR.cache_shardings(amesh, jc, batch_axes),
                is_leaf=lambda s: hasattr(s, "spec"))]
            got = _spec_leaves(DR.cache_shardings(stub, _port_cache(cfg, sc), batch_axes))
            assert got == want, (mesh_name, shape)


# ------------------------------------------------------- kv_shard attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 20])
def test_kv_shard_attention_matches_jax(dtype, window):
    """S = 72 > q_chunk = 16 (a ragged last chunk), GQA 4 over 2 heads:
    float32 within the attention parity tests' 1e-4, bfloat16 within two
    of its ulps at the output's scale."""
    rng = np.random.default_rng(11 + window)
    q, k, v = (rng.standard_normal((2, 72, h, 16)).astype(np.float32) for h in (4, 2, 2))
    kw = dict(q_chunk=16, kv_chunk=16, local_window=window, kv_shard=True)
    jd = getattr(jnp, dtype)
    want = np.asarray(JA.causal_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), **kw)
                      .astype(jnp.float32))
    got = TA.causal_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    tol = 1e-4 if dtype == "float32" else 2 * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # and the key-sharded loop equals the chunked online softmax
    plain = TA.causal_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                  for a in (q, k, v)), **{**kw, "kv_shard": False})
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=tol, atol=tol)


# ----------------------------------------------------------- across ranks
def _batch():
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, 512, (4, 32)).astype(np.int32) for k in ("tokens", "targets")}


def _quegel():
    from repro_torch.launch.dryrun_quegel import round_inputs

    return round_inputs(12, 14, 8, 4, seed=5)


_JAX_ROUND = """
import json, os, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.dryrun_quegel import super_round
from repro.launch.mesh import make_mesh
from repro.models import common as MC
arrays = list(np.load(sys.argv[1]).values())
mesh = jax.make_mesh((1, 4), ("data", "model"))
e_sh = NamedSharding(mesh, P("model", None))
v_sh = NamedSharding(mesh, P(("data",), None))
l_sh = NamedSharding(mesh, P(("data",)))
fn = jax.jit(lambda *a: super_round(*a, mesh=mesh, axis="model"),
             in_shardings=(e_sh,) * 4 + (v_sh,) * 4 + (l_sh,))
with mesh:
    out = fn(*arrays)
np.savez(sys.argv[2], *[np.asarray(o) for o in out])
# shard() on the (2, 2) mesh: the spec of each constrained output
mesh = make_mesh((2, 2), ("data", "model"))
MC.set_mesh(mesh)
specs = []
for shape, names, tp in json.load(open(sys.argv[3])):
    MC.set_tp(tp)
    x = jax.device_put(np.arange(np.prod(shape), dtype=np.float32).reshape(shape),
                       NamedSharding(mesh, P()))
    y = jax.jit(lambda t: MC.shard(t, *names))(x)
    spec = list(y.sharding.spec) + [None] * (len(shape) - len(y.sharding.spec))
    specs.append([None if a is None else [a] if isinstance(a, str) else list(a)
                  for a in spec])
json.dump(specs, open(sys.argv[4], "w"))
"""


def _placements_of(spec) -> list:
    """DTensor placements, one per ("data", "model") mesh dim, that a JAX
    spec (one entry per tensor dim: None or a list of axis names) means."""
    out = []
    for axis in ("data", "model"):
        dims = [d for d, ax in enumerate(spec) if ax and axis in ax]
        out.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    np.savez(tmp / "quegel.npz", *_quegel())
    (tmp / "cases.json").write_text(json.dumps(_torch_mesh.SHARD_CASES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    jax_round = subprocess.Popen(
        [sys.executable, "-c", _JAX_ROUND, str(tmp / "quegel.npz"), str(tmp / "jax.npz"),
         str(tmp / "cases.json"), str(tmp / "specs.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    handle = _torch_mesh.start_ranks(4, "sharding_work", tmp / "ranks", batch=_batch(),
                                     quegel=_quegel())
    try:
        out = _torch_mesh.wait_ranks(handle, timeout=240)
        _, err = jax_round.communicate(timeout=240)
    finally:
        if jax_round.poll() is None:
            jax_round.kill()
    assert jax_round.returncode == 0, err[-3000:]
    return out, {"quegel": list(np.load(tmp / "jax.npz").values()),
                 "shard": json.loads((tmp / "specs.json").read_text())}


def test_shard_placements_follow_the_spec_on_four_ranks(ranks):
    out, jax_out = ranks
    wants = [_placements_of(spec) for spec in jax_out["shard"]]
    assert len(wants) == len(_torch_mesh.SHARD_CASES)
    # the cases reach both of JAX's fallbacks: a dim left unsharded, and a
    # tuple axis cut to its divisible prefix
    assert ["Replicate()", "Shard(dim=2)"] in wants and ["Shard(dim=0)", "Replicate()"] in wants
    for r in out:
        assert len(r["shard"]) == len(wants)
        for (shape, names, tp), want, (got, same) in zip(_torch_mesh.SHARD_CASES, wants,
                                                         r["shard"]):
            assert got == want, (shape, names, tp)
            assert same, (shape, names)


def _unsharded_step():
    from repro_torch.configs import reduced
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(reduced(get_arch("tinyllama-1.1b")), vocab=512)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params, OptConfig())
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    p, o, m = make_train_step(cfg, OptConfig(), n_micro=2)(params, opt, batch)

    def f(t):  # bfloat16 as ml_dtypes' numpy type, as JAX's states arrive
        t = t.detach()
        return t.float().numpy().astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()

    return cfg, tree_map(f, p), tree_map(f, o), tree_map(f, m)


def test_sharded_train_step_equals_unsharded(ranks):
    out, _ = ranks
    _, p, o, m = _unsharded_step()
    for r in out:
        assert_step_matches(r["step"], (p, o, m), rtol=1e-5, metric_rtol=1e-5)
    for r in out[1:]:  # every rank holds the same full state
        for a, b in zip(tree_leaves(r["step"][0]), tree_leaves(out[0]["step"][0])):
            assert torch.equal(a, b)


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    def start(world):
        DR.fake_group(world)

    yield start
    TC.set_mesh(None)
    TC.set_tp(True)
    TC.set_fsdp(True)
    if dist.is_initialized():
        dist.destroy_process_group()


def test_sharded_step_collectives_equal_the_fake_trace(ranks, fake_group):
    """The real gloo step's collective bytes, per kind and mesh dim, are the
    dry run's count of the same step traced under fake tensors."""
    from repro_torch.launch.mesh import make_mesh

    out, _ = ranks
    fake_group(4)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    TC.set_mesh(mesh)
    cfg = dataclasses.replace(_unsharded_step()[0])
    sc = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
    fake = DR._lower_one(cfg, sc, mesh, ("data",), n_micro=2)["coll_detail"]
    assert fake["total"] > 0 and fake["count"] > 0
    for r in out:
        assert r["coll"] == fake


def test_super_round_is_bit_equal_to_jax(ranks):
    out, jax_out = ranks
    want = jax_out["quegel"]
    for r in out:
        assert len(r["quegel"]) == len(want) == 5
        for got, w in zip(r["quegel"], want):
            assert got.dtype == w.dtype and got.shape == w.shape
            np.testing.assert_array_equal(got, w)
    # the round moved: some frontier grew and some distance was set
    assert want[2].any() and (want[0] < 2 ** 30).sum() > 8
