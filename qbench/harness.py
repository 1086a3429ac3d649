"""One run of one cell of ``BENCHMARK.json``.

The cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the configuration's ``app`` names its glue
(``apps/<app>.py``), and each metric its reader (``metrics/<name>.py``).
Everything is found by name under the checkout's ``qbench/``, so a cell or
a metric is added by adding files and entries.

A run: check the device, make the inputs and the port's engine from the
seed, warm it with queries of the same traffic, then measure one window
(``loops.Window``), its first ``TRACE_S`` seconds traced with ``--trace
1``, which the per-layer metrics read.  Once the window has closed
and the peak memory is read, the port's state is freed, a sample of the
window's answers drawn from the seed is held against the plain reference,
and one JSON line is printed last on stdout, with each number compared
beside its limit under ``checks``, last; the same numbers end stderr.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from qbench import loops, roofline, trace
from qbench.gen.arrivals import make_arrivals
from qbench.gen.queries import PairStream

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
STAT_LISTS = ("round_times", "queue_waits", "service_times", "slot_occupancy")
WARM_LIMIT_S = 120.0
# a traced run profiles the window's first TRACE_S seconds: the trace's
# export and reading grow with its length, and the run has to end in time
TRACE_S = 20.0


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="judge the control's answers in the program's place")
    return p.parse_args(argv)


def load_module(path: Path, name: str):
    """A module from its file (the readers and glue are found by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload with everything its name leads to."""

    workload: dict
    config: dict
    traffic: dict
    app: Any
    end_to_end: list
    per_layer: list
    readers: dict

    @staticmethod
    def find(root: Path, name: str) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        wl = next((w for w in bench["workloads"] if w["name"] == name), None)
        if wl is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
        config = json.loads((root / entry["file"]).read_text())
        traffic = json.loads((root / "qbench" / "traffic" / f"{wl['traffic']}.json").read_text())
        app = load_module(root / "qbench" / "apps" / f"{config['app']}.py",
                          f"qbench_app_{config['app']}")
        mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
        e2e, layer = mine(bench["end_to_end"]), mine(bench["per_layer"])
        readers = {m["name"]: load_module(root / "qbench" / "metrics" / f"{m['name']}.py",
                                          f"qbench_metric_{m['name'].replace('.', '_')}")
                   for m in e2e + layer}
        return Cell(wl, config, traffic, app, e2e, layer, readers)


@dataclasses.dataclass
class Context:
    """What the readers read: the window's answers and timings, the
    program's counters over the window, and the trace's summary."""

    seconds: float
    setup_s: float
    answered: list
    capacity: int
    steps_per_round: int
    stats: dict
    summary: Optional[trace.Summary] = None
    bytes_counted: Optional[int] = None
    peaks: Optional[dict] = None

    def latencies(self) -> np.ndarray:
        return np.asarray([r.t_done - r.t_issue for r in self.answered])


def _marks(stats) -> dict:
    return {k: len(getattr(stats, k)) for k in STAT_LISTS}


def _window_stats(stats, lo: dict, hi: dict) -> dict:
    return {k: list(getattr(stats, k)[lo[k]:hi[k]]) for k in STAT_LISTS}


def _query(pair: np.ndarray) -> np.ndarray:
    return np.asarray(pair, dtype=np.int32)


def warm(engine, stream: PairStream, count: int, limit_s: float) -> None:
    """Run ``count`` queries of the cell's traffic to their answers."""
    pending = {engine.submit(_query(stream.next())) for _ in range(count)}
    t_end = time.perf_counter() + limit_s
    while pending:
        if time.perf_counter() > t_end:
            raise RuntimeError(f"{len(pending)} warm-up queries unanswered after {limit_s} s")
        for qid, _, _ in engine.pump():
            pending.discard(qid)


def make_window(engine, traffic: dict, stream: PairStream, seed: int,
                seconds: float) -> loops.Window:
    nxt = lambda: _query(stream.next())
    if traffic["loop"] == "closed":
        return loops.Window(engine, nxt, seconds=seconds, drain_s=traffic["drain_s"],
                            clients=traffic["clients"])
    a = traffic["arrivals"]
    kw = {k: v for k, v in a.items() if k not in ("process", "rate")}
    n = int(a["rate"] * seconds * 2 + 64)
    times = make_arrivals(a["process"], a["rate"], n, seed=seed, **kw)
    return loops.Window(engine, nxt, seconds=seconds, drain_s=traffic["drain_s"],
                        arrivals=times[times < seconds])


def sample(records: list, size: int, seed: int) -> list:
    """Up to ``size`` answered records drawn from the seed, with the one
    that took longest always among them."""
    if len(records) <= size:
        return list(records)
    rng = np.random.default_rng([int(seed), 7])
    pick = set(rng.choice(len(records), size=size - 1, replace=False).tolist())
    pick.add(int(np.argmax([r.t_done - r.t_submit for r in records])))
    return [records[i] for i in sorted(pick)]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(args, root: Path, device: str, t0: float, fault=None) -> tuple[int, Optional[dict]]:
    """The run itself; ``fault`` (tests only) breaks the timed path."""
    cell = Cell.find(root, args.workload)
    chips = int(cell.workload["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"qbench: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    if not (root / "src" / "repro_torch").is_dir():
        print(f"qbench: the program (src/repro_torch) is not in {root}", file=sys.stderr)
        return 2, None
    sys.path.insert(0, str(root / "src"))
    from repro_torch.launch import env

    print(f"qbench: {env.describe()}", file=sys.stderr)
    config, traffic = cell.config, cell.traffic
    t_build = time.perf_counter()
    system = cell.app.build(config, args.seed, device)
    engine = system.engine
    t_warm = time.perf_counter()
    stream = lambda kind: PairStream(system.pool, args.seed, kind, traffic["pairs"])
    warm(engine, stream("warmup"), traffic["warmup_queries"], WARM_LIMIT_S)
    if fault is not None:
        fault(engine)
    window = make_window(engine, traffic, stream("window"), args.seed, args.seconds)
    print(f"qbench: set-up: start {t_build - t0:.1f} s, inputs and engine "
          f"{t_warm - t_build:.1f} s, warm-up {time.perf_counter() - t_warm:.1f} s; "
          f"{system.data['arcs']} arcs", file=sys.stderr)
    counter = prof = None
    if args.trace:
        counter = trace.ByteCounter(device)
        trace.install_spans(engine, system.views, counter)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    gc.collect()
    gc.freeze()
    stats = engine.stats
    lo = _marks(stats)
    with torch.profiler.record_function(trace.WINDOW):
        window.run(until=TRACE_S if prof is not None else None)
    hi = _marks(stats)
    setup_s = window.t_open - t0
    bytes_counted = None
    if prof is not None:
        if device == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        bytes_counted = counter.close()
        window.run()
    window.drain()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    summary = None
    if prof is not None:
        tmp = Path(tempfile.mkdtemp(prefix="qbench-trace-"))
        try:
            path = tmp / "trace.json"
            t_x = time.perf_counter()
            prof.export_chrome_trace(str(path))
            del prof
            summary = trace.summarize(trace.load_trace(path))
            print(f"qbench: trace of {path.stat().st_size} bytes, {len(summary.host)} host "
                  f"and {len(summary.device)} device events, read in "
                  f"{time.perf_counter() - t_x:.1f} s", file=sys.stderr)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    done = [r for r in window.answered() if r.status == "DONE"]
    ctx = Context(args.seconds, setup_s, done, engine.capacity, engine.steps_per_round,
                  _window_stats(stats, lo, hi), summary, bytes_counted, roofline.peaks(kind))
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = len(window.unanswered()) + sum(
        1 for r in window.records if r.status and r.status != "DONE")
    checked = sample([r for r in window.records if r.status == "DONE"],
                     config["check"]["sample"], args.seed)
    queries = np.stack([r.query for r in checked]) if checked else np.zeros((0, 2), np.int32)
    results = [r.result for r in checked]
    system.release()
    del engine
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if args.control:
        results = cell.app.control(system, queries, config)
        print("qbench: the control answers in the program's place", file=sys.stderr)
    numbers = dict(cell.app.judge(system, queries, results, config), unanswered=failed)
    limits = dict(config["limits"], unanswered=0)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    correct = bool(checked) and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(window.records), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu", "kind": kind, "count": chips,
                      "memory_peak_bytes": int(peak)}}
    if summary is not None:
        busy = trace.measure(trace.busy(summary))
        out["device"].update(busy_s=busy, window_s=summary.window[1] - summary.window[0])
        out["breakdown"] = trace.breakdown(summary)
    out["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"qbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3, None
    print(f"qbench: {len(window.records)} attempted, {len(done)} answered in the window; "
          f"checked {len(checked)} answers", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0, out


def main(argv=None, *, root: Optional[Path] = None, device: str = "cuda",
         t0: Optional[float] = None, fault=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    root = Path(__file__).resolve().parents[1] if root is None else Path(root)
    rc, out = run(args, root, device, t0, fault)
    if out is not None:
        sys.stdout.flush()
        print(json.dumps(out), flush=True)
    return rc
