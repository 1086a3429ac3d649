"""Open-loop serving on the PyTorch/CUDA port: sustained Poisson arrivals
against a BFS engine and a two-replica pool.

Closed-loop runs submit a batch and drain it; this demo does what a query
console does — queries keep ARRIVING whether or not the engine is keeping
up.  It shows, on the deterministic virtual clock (1 tick = 1
super-round):

1. the latency-throughput curve of one engine under rising offered load,
   and its saturation knee;
2. hash-affine routing across replicas beating round-robin on cache hits
   for a Zipf-repeated workload (repeats land where their cached answer
   lives), with the merged result map identical either way.

The replicas share one device and are pumped one after another.

Run:  PYTHONPATH=src python examples/torch_open_loop_serving.py            # on a GPU
      PYTHONPATH=src python examples/torch_open_loop_serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.apps.ppsp import make_bfs_engine
from repro_torch.core.graph import grid_terrain
from repro_torch.launch import env as envmod
from repro_torch.launch.loadgen import make_arrivals, run_open_loop, sweep_qps
from repro_torch.launch.router import ReplicaPool


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--zipf-queries", type=int, default=96)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    kw = dict(backend="cuda", device=dev)

    print(f"host tunings: {envmod.describe()}")
    g, _ = grid_terrain(12, 14, seed=0, device=dev)
    rng = np.random.default_rng(1)

    # mixed workload: 1 in 4 corner-to-corner (heavy), rest neighbor hops
    items = []
    for i in range(args.queries):
        if i % 4 == 0:
            items.append((np.asarray([0, g.n_real - 1], np.int32), dict(budget=120)))
        else:
            v = int(rng.integers(0, g.n_real - 2))
            items.append((np.asarray([v, v + 1], np.int32), dict(budget=16)))

    # --- 1. latency-throughput curve, one engine -------------------------
    eng = make_bfs_engine(g, capacity=4, **kw)
    swept = sweep_qps(lambda: eng, items, (0.25, 0.5, 1.0, 2.0, 4.0),
                      process="poisson", seed=2)
    print("\noffered qps -> p50 / p99 latency (ticks), delivered qps")
    for rate, cell in sorted(swept["curve"].items()):
        print(f"  {rate:5.2f} -> {cell['lat_p50']:6.1f} /"
              f" {cell['lat_p99']:6.1f}   delivered {cell['busy_qps']:.2f}")
    print(f"saturation knee: {swept['knee']} qps")

    # --- 2. affine vs round-robin on a Zipf-repeated workload ------------
    keys = [np.asarray([int(a), int(b)], np.int32)
            for a, b in rng.integers(0, g.n_real, (12, 2))]
    p = 1.0 / np.arange(1, len(keys) + 1) ** 1.1
    p /= p.sum()
    mix = [keys[i] for i in rng.choice(len(keys), size=args.zipf_queries, p=p)]
    arrivals = make_arrivals("constant", 2.0, len(mix))

    print(f"\nrouting {len(mix)} Zipf-repeated queries across "
          f"{args.replicas} replicas (per-replica LRU cache of 8):")
    base = None
    for policy in ("affine", "rr"):
        pool = ReplicaPool(
            [make_bfs_engine(g, capacity=4, result_cache=8, **kw)
             for _ in range(args.replicas)],
            policy=policy,
        )
        res = run_open_loop(pool, mix, arrivals, offered_qps=2.0)
        norm = {q: {k: np.asarray(v).tolist() for k, v in r.items()}
                for q, r in pool.results.items()}
        if base is None:
            base = norm
        assert norm == base, "routing must never change results"
        s = pool.stats_summary()
        print(f"  {policy:6s}  hit rate {res.cache_hits / len(mix):5.1%}"
              f"   p99 {res.latency_percentile(99):5.1f} ticks"
              f"   balance {s['balance']:.2f}")
    print("merged result maps identical across policies: routing is placement only")


if __name__ == "__main__":
    main()
