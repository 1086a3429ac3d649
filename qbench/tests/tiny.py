"""A checkout in a temporary directory with the cells cut to a CPU's size:
the real ``BENCHMARK.json`` with tiny copies of its configurations, the real
traffic mixes, apps and metric readers, and ``src`` linked to the program.

Each configuration's CPU cut is a data file of its own,
``qbench/tests/cuts/<config name>.json``: the keys of the configuration
file that it overrides, with the values that make the cell run in a second
on a CPU (sizes, and the sample ``check`` compares).  It shrinks sizes and
never changes what is computed or judged, so it holds no ``engine``,
``answer``, ``limits`` or ``guarantees``.

A configuration joins the benchmark, and every harness test here, by files
and entries alone:

- its configuration file, ``qbench/configs/<config>.json``;
- its glue, ``qbench/apps/<app>.py``, where its ``app`` is new;
- its cut, ``qbench/tests/cuts/<config>.json``;
- its traffic mix, ``qbench/traffic/<traffic>.json``, where that is new;
- its entries in ``BENCHMARK.json``: one under ``configs`` and its cells
  under ``workloads``, which the harness tests take their cells from;
- its per-layer entries that name its cells under ``workloads``: each cell
  reports at least one, and each entry's ``moves`` is an end-to-end metric
  that the cell reports.  A per-layer metric already there names the cells
  it was measured in; a new cell reports the metrics that name it and those
  that name no cells (today the end-to-end metrics without a list), and the
  checks of ``cells.py`` hold it to exactly those.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

QBENCH = Path(__file__).resolve().parents[1]
ROOT = QBENCH.parent


def cut_path(source: Path, config: str) -> Path:
    return source / "qbench" / "tests" / "cuts" / f"{config}.json"


def make_root(tmp: Path, drain_s: float = 2.0, source: Path = ROOT) -> Path:
    """``tmp`` as a checkout of the tiny cells of ``source`` (a checkout's
    root: its ``BENCHMARK.json`` and ``qbench/``); returns it."""
    for sub in ("apps", "metrics", "traffic"):
        shutil.copytree(source / "qbench" / sub, tmp / "qbench" / sub)
    (tmp / "qbench" / "configs").mkdir(parents=True)
    (tmp / "src").symlink_to(ROOT / "src")
    bench = json.loads((source / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        cut = cut_path(source, entry["name"])
        if not cut.is_file():
            raise FileNotFoundError(
                f"no CPU cut {cut} for configuration {entry['name']!r}: it must hold a JSON "
                f"object of the keys of its configuration file to override on the CPU "
                f"(sizes and the check's sample), and none of engine, answer, limits or "
                f"guarantees")
        cfg = json.loads((source / entry["file"]).read_text())
        cfg.update(json.loads(cut.read_text()))
        entry["file"] = f"qbench/configs/{entry['name']}.json"
        (tmp / entry["file"]).write_text(json.dumps(cfg))
    for path in (tmp / "qbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["drain_s"] = drain_s
        path.write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
