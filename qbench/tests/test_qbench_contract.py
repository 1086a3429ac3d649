"""``BENCHMARK.json`` is well formed (keys, names, units, bounds, what each
cell reports), and nothing under ``qbench/`` imports JAX or the JAX package
(top-level names compared whole: ``repro_torch`` begins with ``repro``);
the yardstick imports nothing of the port either."""
import ast
import json
import re
import shutil

import pytest

from qbench.tests.tiny import QBENCH, ROOT, cut_path, make_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# what a CPU cut may not touch: it shrinks sizes and never changes semantics
SEMANTICS = {"engine", "answer", "limits", "guarantees"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: generators, references, byte counts, peaks, trace readers
YARDSTICK = ["gen", "ref", "metrics", "roofline.py", "trace.py", "loops.py"]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield node.args[0].value.split(".")[0]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "qbench/run.py"]
    assert BENCH["paths"] == ["qbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_workloads():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(configs) == len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("qbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (QBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_has_a_cpu_cut_that_only_shrinks_sizes(entry):
    path = cut_path(ROOT, entry["name"])
    assert path.is_file(), f"no {path}"
    cut = json.loads(path.read_text())
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert isinstance(cut, dict) and cut
    assert set(cut) <= set(cfg) and not set(cut) & SEMANTICS
    for key, value in cut.items():
        if isinstance(value, dict):
            assert isinstance(cfg[key], dict) and set(value) <= set(cfg[key]), key


def test_a_configuration_without_its_cut_is_named(tmp_path):
    source = tmp_path / "source"
    shutil.copytree(QBENCH, source / "qbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", source)
    name = BENCH["configs"][0]["name"]
    cut_path(source, name).unlink()
    with pytest.raises(FileNotFoundError, match=re.escape(str(cut_path(source, name)))) as err:
        make_root(tmp_path / "root", source=source)
    assert "engine, answer, limits or guarantees" in str(err.value)


def test_metrics_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layer = BENCH["per_layer"]
    names = [m["name"] for m in BENCH["end_to_end"] + layer]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
    for m in BENCH["end_to_end"] + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (QBENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = lambda m, w: w in m.get("workloads", cells)
    for w in cells:
        mine = [m for m in BENCH["end_to_end"] if reports(m, w)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(reports(m, w) for m in layer)
        for m in layer:
            if reports(m, w):
                assert reports(e2e[m["moves"]], w), (m["name"], w)


def test_file_names_under_the_paths_are_made_of_name_characters():
    for p in QBENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("path", sorted(p.relative_to(QBENCH) for p in QBENCH.rglob("*.py")),
                         ids=str)
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(imports(QBENCH / path))


def test_the_yardstick_imports_nothing_of_the_port():
    files = [f for part in YARDSTICK
             for f in ((QBENCH / part).rglob("*.py") if (QBENCH / part).is_dir() else [QBENCH / part])]
    assert len(files) > 10
    for f in files:
        assert "repro_torch" not in set(imports(f)), f


def test_nothing_reads_the_jax_benchmark():
    for f in QBENCH.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        assert "BENCH_quegel" not in text and "benchmarks/" not in text, f
