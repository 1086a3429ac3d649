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
from repro_torch.apps import hub2, ppsp
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
    assert got["modules"] >= 14, got
    assert got["bad"] == [], f"repro_torch imported {got['bad']}"


def test_no_module_names_jax_in_an_import():
    pkg = Path(repro_torch.__file__).resolve().parent
    for path in pkg.rglob("*.py"):
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


def test_every_module_is_listed():
    """The walk above sees the whole tree the README describes."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for want in ("repro_torch.core.semiring", "repro_torch.core.graph",
                 "repro_torch.core.runtime", "repro_torch.core.engine",
                 "repro_torch.kernels.ref", "repro_torch.kernels.frontier",
                 "repro_torch.kernels.ops", "repro_torch.apps.ppsp",
                 "repro_torch.apps.hub2", "repro_torch.configs.quegel",
                 "repro_torch.carry"):
        assert want in names
