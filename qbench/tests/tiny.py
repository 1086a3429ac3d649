"""A checkout in a temporary directory with the cells cut to a CPU's size:
the real ``BENCHMARK.json`` with tiny copies of its configurations, the real
traffic mixes, apps and metric readers, and ``src`` linked to the program."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

QBENCH = Path(__file__).resolve().parents[1]
ROOT = QBENCH.parent
TINY = {"kron20-bibfs": {"scale": 8, "check": {"sample": 24}},
        "terrain2m-sssp": {"rows": 6, "cols": 6, "check": {"sample": 24}}}


def make_root(tmp: Path, drain_s: float = 2.0) -> Path:
    """``tmp`` as a checkout of tiny cells; returns it."""
    for sub in ("apps", "metrics", "traffic"):
        shutil.copytree(QBENCH / sub, tmp / "qbench" / sub)
    (tmp / "qbench" / "configs").mkdir(parents=True)
    (tmp / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        cfg.update(TINY[entry["name"]])
        entry["file"] = f"qbench/configs/{entry['name']}.json"
        (tmp / entry["file"]).write_text(json.dumps(cfg))
    for path in (tmp / "qbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["drain_s"] = drain_s
        path.write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
