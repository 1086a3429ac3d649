"""Quickstart on the PyTorch/CUDA port: the Quegel engine answering PPSP
queries on a power-law graph — interactive mode, batch mode, and the
Hub^2 index — through the hand-written frontier kernel (``backend="cuda"``;
on a CPU tensor it runs its plain version).

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # on a GPU
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.hub2 import build_hub_index, make_hub2_engine
from repro_torch.apps.ppsp import make_bibfs_engine
from repro_torch.core.graph import barabasi_albert


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--pairs", type=int, default=32)
    ap.add_argument("--hub-k", type=int, default=32)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    kw = dict(backend="cuda", device=dev)

    print(f"== building a {args.n}-vertex power-law graph (hub-heavy, Twitter-like) on {dev}")
    g = barabasi_albert(args.n, 3, seed=0, device=dev)
    print(f"   |V|={g.n_real} |E|={g.num_edges} max_deg={int(g.in_deg.max())}")

    rng = np.random.default_rng(1)
    pairs = rng.integers(0, g.n_real, (args.pairs, 2)).astype(np.int32)

    # ---- scenario (i): interactive querying (paper §3.1) ----------------
    eng = make_bibfs_engine(g, capacity=1, **kw)
    s, t = (int(v) for v in pairs[0])
    t0 = time.perf_counter()
    res = eng.query(pairs[0])
    print(f"== interactive: d({s},{t}) = {int(res['dist'])} "
          f"[{time.perf_counter() - t0:.3f}s, visited {int(res['visited'])} vertices]")

    # ---- scenario (ii): batch querying under superstep-sharing ----------
    answers = {}
    for C in (1, 8):
        eng = make_bibfs_engine(g, capacity=C, **kw)
        for p in pairs:
            eng.submit(p)
        sync(dev)
        t0 = time.perf_counter()
        out = eng.run_until_drained()
        sync(dev)
        dt = time.perf_counter() - t0
        answers[C] = [int(out[q]["dist"]) for q in range(len(pairs))]
        print(f"== batch C={C}: {len(pairs)} queries in {dt:.2f}s "
              f"({len(pairs) / dt:.1f} q/s, {eng.stats.barriers} barriers)")

    # ---- Hub^2 indexing (itself a Quegel job) + indexed querying --------
    t0 = time.perf_counter()
    idx = build_hub_index(g, k=args.hub_k, capacity=8, **kw)
    sync(dev)
    print(f"== Hub^2 index (k={args.hub_k}) built in {time.perf_counter() - t0:.2f}s "
          f"({args.hub_k} BFS queries through the engine)")
    eng = make_hub2_engine(g, idx, capacity=8, **kw)
    for p in pairs:
        eng.submit(p)
    t0 = time.perf_counter()
    res = eng.run_until_drained()
    sync(dev)
    dt = time.perf_counter() - t0
    acc = np.mean([int(r["visited"]) for r in res.values()]) / g.n_real
    print(f"== Hub^2 batch: {len(pairs)} queries in {dt:.2f}s "
          f"({len(pairs) / dt:.1f} q/s, mean access rate {acc:.1%})")
    hub2 = [int(res[q]["dist"]) for q in range(len(pairs))]
    assert answers[1] == answers[8] == hub2, "C=1, C=8 and Hub^2 must agree"
    print(f"== the {len(pairs)} distances are identical at C=1, at C=8 and through Hub^2")


if __name__ == "__main__":
    main()
