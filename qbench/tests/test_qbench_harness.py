"""The harness on the CPU at a tiny size: its dispatch by name, a cell and a
configuration added by files alone, the refusals, and ``correct`` coming out
false when the timed path is broken underneath (each fault these cells can
have) or when the control takes the program's place.  The cells are those of
``BENCHMARK.json``, each cut to the CPU by its configuration's cut file, and
each is held to the per-cell checks of ``cells.py``; so is the cell of a
configuration that joins by files and entries alone."""
import contextlib
import io
import json
import shutil
import subprocess
import sys

import pytest
import torch

from qbench import harness, loops, trace
from qbench.tests import cells
from qbench.tests.cells import BENCH, CELLS, altered_answer, run_cell
from qbench.tests.cells import only_what_the_run_loads  # noqa: F401
from qbench.tests.tiny import QBENCH, ROOT, make_root

KRON, TERRAIN = "kron20-bibfs-batch", "terrain2m-sssp-batch"
NEW_CELL = "kron20-two-batch"


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(tmp_path, workload):
    cells.sound(make_root(tmp_path), BENCH, workload)


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(tmp_path, workload):
    cells.traced(make_root(tmp_path), BENCH, workload)


def test_a_traced_run_profiles_the_windows_first_part(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_S", 0.3)
    rc, res, err = run_cell(make_root(tmp_path), KRON, "--trace", "1", seconds="1.2")
    assert rc == 0, err
    assert res["correct"] is True
    assert 0.3 <= res["device"]["window_s"] < 0.6
    assert res["attempted"] > 0 and res["metrics"]["round_ms"]["value"] > 0


def test_a_cell_config_traffic_and_metric_added_by_files_alone(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "qbench/configs/kron20-bibfs.json").read_text())
    cfg.update(scale=7, name="kron7-dummy")
    (root / "qbench/configs/kron7-dummy.json").write_text(json.dumps(cfg))
    traffic = {"loop": "open", "arrivals": {"process": "poisson", "rate": 200.0},
               "pairs": {"draw": "uniform"}, "warmup_queries": 4, "drain_s": 2.0}
    (root / "qbench/traffic/poisson200-dummy.json").write_text(json.dumps(traffic))
    (root / "qbench/metrics/dummy_answered.py").write_text(
        "def read(ctx):\n    return float(len(ctx.answered))\n")
    bench["configs"].append({"name": "kron7-dummy", "source": "test", "reduced": [],
                             "file": "qbench/configs/kron7-dummy.json", "why": "test"})
    bench["workloads"].append({"name": "kron7-dummy-open", "config": "kron7-dummy",
                               "traffic": "poisson200-dummy", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "dummy_answered", "unit": "q", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["kron7-dummy-open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cell(root, "kron7-dummy-open")
    assert rc == 0, err
    assert res["correct"] is True
    assert res["metrics"]["dummy_answered"]["value"] == pytest.approx(
        res["metrics"]["qps"]["value"] * 0.5)
    rc, res, _ = run_cell(root, KRON)
    assert "dummy_answered" not in res["metrics"]


# a reader of one of the program's spans, for the joining cell alone
STEP_MS = '''"""The mean of the traced window's ``quegel.step`` spans, in ms."""


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    lo, hi = s.window
    t = [b - a for a, b, name, _ in s.host if name == "quegel.step" and lo <= a and b <= hi]
    return sum(t) / len(t) * 1e3 if t else None
'''


def source_with_new_glue(tmp):
    """Make ``tmp`` a copy of the benchmark that gains by new files and
    entries alone a configuration with an app of its own, its cut, a traffic
    mix, a cell, and a per-layer metric of the program's spans with a reader
    of its own, listed for that cell alone; return its ``BENCHMARK.json``."""
    shutil.copytree(QBENCH, tmp / "qbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    q = tmp / "qbench"
    shutil.copy(q / "apps/bibfs.py", q / "apps/bibfs2.py")
    cfg = json.loads((q / "configs/kron20-bibfs.json").read_text())
    cfg.update(name="kron20-two", app="bibfs2")
    (q / "configs/kron20-two.json").write_text(json.dumps(cfg))
    (q / "tests/cuts/kron20-two.json").write_text(json.dumps({"scale": 7, "check": {"sample": 24}}))
    traffic = json.loads((q / "traffic/closed8-uniform.json").read_text())
    traffic.update(clients=4, warmup_queries=8)
    (q / "traffic/closed4-uniform.json").write_text(json.dumps(traffic))
    (q / "metrics/step_ms.py").write_text(STEP_MS)
    bench["configs"].append({"name": "kron20-two", "source": "test", "reduced": ["scale"],
                             "file": "qbench/configs/kron20-two.json", "why": "test"})
    bench["workloads"].append({"name": NEW_CELL, "config": "kron20-two",
                               "traffic": "closed4-uniform", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "step_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "engine round",
                               "moves": "qps", "workloads": [NEW_CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_a_configuration_with_new_glue_joins_by_files_alone(tmp_path):
    """A checkout gains a configuration with an app of its own, its cut, a
    traffic mix and a cell by new files and new entries alone: the tiny
    checkout is made from it, its cell runs correct, and a broken timed path
    is not correct."""
    source = tmp_path / "source"
    source_with_new_glue(source)
    root = make_root(tmp_path / "root", drain_s=0.5, source=source)
    made = json.loads((root / "qbench/configs/kron20-two.json").read_text())
    assert made["app"] == "bibfs2" and made["scale"] == 7
    rc, res, err = run_cell(root, NEW_CELL)
    assert rc == 0, err
    assert res["correct"] is True and res["attempted"] > 0
    rc, res, err = run_cell(root, NEW_CELL, fault=altered_answer)
    assert rc == 0, err
    assert res["correct"] is False and res["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("check", cells.CHECKS)
def test_a_new_configurations_cell_passes_every_per_cell_check(tmp_path, check):
    """The cell of a configuration that joins by files alone, with only its
    own per-layer metric, passes each per-cell check the cells of
    ``BENCHMARK.json`` pass, the traced ones included: it reports that
    metric and none of the metrics listed for the other cells."""
    source = tmp_path / "source"
    bench = source_with_new_glue(source)
    cells.CHECKS[check](make_root(tmp_path / "root", source=source), bench, NEW_CELL)


@pytest.mark.parametrize("fault", cells.FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    cells.broken(make_root(tmp_path, drain_s=0.5), BENCH, workload, fault)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tmp_path, workload):
    """The control in the program's place: the first-meet search breaks the
    exact hop count, bfloat16 the float32 distances.  The harness's own
    comparison judges its answers and finds them wrong."""
    cells.control(make_root(tmp_path), BENCH, workload)


def test_the_drain_adds_no_bytes_to_the_roofline(tmp_path, monkeypatch):
    """The byte count is read at the window's close; propagate calls made by
    the drain after it are not counted."""
    seen = {}

    class Recording(trace.ByteCounter):
        def close(self):
            seen["closed"] = super().close()
            return seen["closed"]

    inner_drain = loops.Window.drain

    def drain(window):
        rounds = len(window.target.stats.round_times)
        inner_drain(window)
        seen["drain_rounds"] = len(window.target.stats.round_times) - rounds
        seen["after"] = int(seen["counter"].total)

    def init(self, device, _init=trace.ByteCounter.__init__):
        _init(self, device)
        seen["counter"] = self

    monkeypatch.setattr(Recording, "__init__", init)
    monkeypatch.setattr(trace, "ByteCounter", Recording)
    monkeypatch.setattr(loops.Window, "drain", drain)
    rc, res, err = run_cell(make_root(tmp_path), TERRAIN, "--trace", "1")
    assert rc == 0, err
    assert seen["drain_rounds"] > 0
    assert seen["closed"] > 0 and seen["after"] == seen["closed"]


# -------------------------------------------------------------- refusals
def test_no_cuda_device_gives_no_result(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", KRON, "--seed", "1", "--seconds", "1"],
                          root=make_root(tmp_path), device="cuda")
    assert rc != 0 and out.getvalue() == ""
    assert "CUDA" in err.getvalue()


def test_a_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(QBENCH, tmp_path / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "qbench/run.py", "--workload", TERRAIN,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert not done.stdout.strip()


@pytest.mark.parametrize("top", ["jax", "jaxlib", "flax", "repro"])
def test_jax_loaded_by_the_run_gives_no_result(tmp_path, monkeypatch, top):
    name = f"{top}._loaded_by_the_run"
    load = lambda engine: monkeypatch.setitem(sys.modules, name, type(sys)(name))
    rc, res, err = run_cell(make_root(tmp_path), KRON, fault=load)
    assert rc != 0 and res is None
    assert name in err
