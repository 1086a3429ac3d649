"""Find the open-loop knee of a cell's engine once, by a sweep on the chip:

    python3 qbench/sweep.py --workload kron20-bibfs-batch --seed 1 \
        --rates 300,600,900 --seconds 8

One set-up, then for each offered rate a window of Poisson arrivals (each
query timed from when it was due) and a drain.  A rate is sustained when
the queries answered in its window are at least ``--tol`` of those offered
and the backlog at the close is no larger than at the window's middle plus
the capacity.  Prints one JSON line per rate and a last line with the knee:
the highest sustained rate below the first that is not.  This measures a
number for a later cell's traffic file; it is no cell.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qbench import harness, loops  # noqa: E402
from qbench.gen.arrivals import make_arrivals  # noqa: E402
from qbench.gen.queries import PairStream  # noqa: E402


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True, help="offered q/s, comma-separated, rising")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--tol", type=float, default=0.9)
    args = p.parse_args(argv)
    cell = harness.Cell.find(root, args.workload)
    if device == "cuda" and not torch.cuda.is_available():
        print("qbench sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    system = cell.app.build(cell.config, args.seed, device)
    engine = system.engine
    stream = lambda kind: PairStream(system.pool, args.seed, kind, cell.traffic["pairs"])
    harness.warm(engine, stream("warmup"), cell.traffic["warmup_queries"],
                 harness.WARM_LIMIT_S)
    print(f"qbench sweep: set-up {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    queries = stream("window")
    knee = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        times = make_arrivals("poisson", rate, int(rate * args.seconds * 2 + 64),
                              seed=args.seed + i)
        w = loops.Window(engine, lambda: harness._query(queries.next()),
                         seconds=args.seconds, drain_s=60.0,
                         arrivals=times[times < args.seconds])
        w.run()
        backlog = len(w.inflight)
        w.drain()
        done = [r for r in w.answered() if r.status == "DONE"]
        lat = np.asarray([r.t_done - r.t_issue for r in done])
        lag = np.asarray([r.t_submit - r.t_issue for r in w.records])
        row = {"offered_qps": len(w.records) / args.seconds,
               "delivered_qps": len(done) / args.seconds,
               "backlog_mid": w.backlog_mid or 0, "backlog_close": backlog,
               "p50_ms": float(np.percentile(lat, 50)) * 1e3 if len(lat) else None,
               "p95_ms": float(np.percentile(lat, 95)) * 1e3 if len(lat) else None,
               "gen_lag_p95_ms": float(np.percentile(lag, 95)) * 1e3 if len(lag) else None,
               "rate": rate}
        row["sustained"] = bool(
            row["delivered_qps"] >= args.tol * row["offered_qps"]
            and backlog <= (w.backlog_mid or 0) + engine.capacity)
        print(json.dumps(row), flush=True)
        if not row["sustained"]:
            break
        knee = rate
    print(json.dumps({"knee_qps": knee, "at_0.8": None if knee is None else 0.8 * knee,
                      "seconds_per_rate": args.seconds, "tol": args.tol}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
