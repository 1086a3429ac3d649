"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the JAX package, and its entry points refuse to run on the
CPU unless the caller asks for it."""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro_torch
from repro_torch.apps import hub2, keyword, ppsp, reach, terrain, xmlkw
from repro_torch.core import graph as tgraph

SRC = Path(repro_torch.__file__).resolve().parents[1]

_CHILD = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         cwd=SRC, capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["modules"] >= 23, got
    assert got["bad"] == [], f"repro_torch imported {got['bad']}"


def test_no_module_names_jax_in_an_import():
    """Every module of the port, and the chip script at the repo root."""
    pkg = Path(repro_torch.__file__).resolve().parent
    smoke = SRC.parent / "chip_smoke.py"
    assert smoke.is_file()
    for path in [*pkg.rglob("*.py"), smoke]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "repro", "jaxlib"), f"{path}: {line}"


@pytest.fixture
def no_gpu(monkeypatch):
    """Behave as this box does whether or not a card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgraph.random_graph(30, 2.0, seed=1)
    g = tgraph.random_graph(30, 2.0, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppsp.make_bfs_engine(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppsp.make_bibfs_engine(g, backend="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hub2.build_hub_index(g, 3)
    eng = ppsp.make_bfs_engine(g, device="cpu")
    assert eng.device.type == "cpu"
    assert int(eng.query(np.asarray([0, 0], np.int32))["dist"]) == 0


def test_app_entry_points_refuse_the_cpu_unless_asked(no_gpu):
    """The four query classes of the second slice, and their generators."""
    for make in (lambda: tgraph.random_dag(30, 2.0),
                 lambda: tgraph.random_tree(30),
                 lambda: tgraph.grid_terrain(4, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    dag = tgraph.random_dag(30, 2.0, seed=1, device="cpu")
    tree, parent = tgraph.random_tree(30, seed=1, device="cpu")
    terr, coords = tgraph.grid_terrain(4, 4, device="cpu")
    tokens = keyword.make_vertex_text(30, 5, 2)
    idx = reach.build_reach_index(dag)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xmlkw.build_xml_index(parent, tokens, tree.n)
    xidx = xmlkw.build_xml_index(parent, tokens, tree.n, device="cpu")
    for make in (lambda **kw: terrain.make_terrain_engine(terr, coords, **kw),
                 lambda **kw: keyword.make_keyword_engine(dag, tokens, **kw),
                 lambda **kw: reach.make_reach_engine(dag, idx, **kw),
                 lambda **kw: xmlkw.make_xml_engine(xmlkw.MaxMatch, tree, xidx, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(backend="cuda")
        assert make(device="cpu").device.type == "cpu"


def test_mesh_entry_points_refuse_without_a_group_or_card(no_gpu, tmp_path):
    """No mesh starts a process group itself or falls back to the CPU."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    assert not dist.is_initialized()
    for make in (lambda: mesh.make_mesh((1,), ("w",), device_type="cpu"),
                 mesh.host_device_mesh, mesh.elastic_mesh):
        with pytest.raises(RuntimeError, match="initialised process group"):
            make()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            mesh.host_device_mesh()
        m = mesh.host_device_mesh(device_type="cpu")
        g = tgraph.random_graph(32, 2.0, seed=1, device="cpu")
        assert ppsp.make_bfs_engine(g, mesh=m).device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_every_module_is_listed():
    """The walk above sees the whole tree the README describes."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for want in ("repro_torch.core.semiring", "repro_torch.core.graph",
                 "repro_torch.core.runtime", "repro_torch.core.engine",
                 "repro_torch.kernels.ref", "repro_torch.kernels.frontier",
                 "repro_torch.kernels.ops", "repro_torch.apps.ppsp",
                 "repro_torch.apps.hub2", "repro_torch.apps.terrain",
                 "repro_torch.apps.keyword", "repro_torch.apps.reach",
                 "repro_torch.apps.xmlkw", "repro_torch.configs.quegel",
                 "repro_torch.carry", "repro_torch.core.store",
                 "repro_torch.train.fault", "repro_torch.launch.supervise",
                 "repro_torch.launch.loadgen", "repro_torch.launch.router",
                 "repro_torch.launch.env", "repro_torch.core.distributed",
                 "repro_torch.launch.mesh", "repro_torch.configs.base",
                 "repro_torch.configs.tinyllama_1_1b", "repro_torch.models.common",
                 "repro_torch.models.attention", "repro_torch.models.mlp",
                 "repro_torch.models.transformer", "repro_torch.launch.serve",
                 "repro_torch.models.ssm", "repro_torch.models.rglru",
                 "repro_torch.train.optimizer", "repro_torch.train.compress",
                 "repro_torch.train.data", "repro_torch.train.checkpoint",
                 "repro_torch.train.train_step", "repro_torch.launch.train",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                 "repro_torch.launch.dryrun_quegel", "repro_torch.launch.rerun_opt",
                 "repro_torch.launch.compare", "repro_torch.launch.report"):
        assert want in names
