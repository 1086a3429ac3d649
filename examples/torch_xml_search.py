"""XML keyword search end-to-end on the PyTorch/CUDA port (paper §5.2):
build the document tree, construct the inverted index at load time, then
answer SLCA / ELCA / MaxMatch queries under superstep-sharing.

Run:  PYTHONPATH=src python examples/torch_xml_search.py            # on a GPU
      PYTHONPATH=src python examples/torch_xml_search.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.apps.keyword import MAXK, make_vertex_text
from repro_torch.apps.xmlkw import (
    MaxMatch,
    SLCALevelAligned,
    SLCANaive,
    build_xml_index,
    make_xml_engine,
)
from repro_torch.core.graph import random_tree


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=16)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    kw = dict(backend="cuda", device=dev)
    n = args.n

    print(f"== synthesizing an XML document tree with {n} vertices on {dev}")
    g, parent = random_tree(n, max_fanout=6, seed=0, device=dev)
    tokens = make_vertex_text(n, 60, 3, seed=1)  # Zipf-distributed text

    t0 = time.perf_counter()
    idx = build_xml_index(parent, tokens, g.n, device=dev)  # load2Idx analogue
    print(f"== inverted index + levels built in {time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(2)
    queries = [rng.integers(0, 25, 2).tolist() for _ in range(args.queries)]

    def padded(kws):
        q = np.full(MAXK, -1, np.int32)
        q[: len(kws)] = kws
        return q

    eng = make_xml_engine(SLCALevelAligned, g, idx, capacity=8, **kw)
    for kws in queries:
        eng.submit(padded(kws))
    t0 = time.perf_counter()
    res = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"== {len(queries)} SLCA/ELCA queries in {dt:.2f}s "
          f"({len(queries) / dt:.1f} q/s, {eng.stats.barriers} barriers)")
    for (qid, r), kws in list(zip(sorted(res.items()), queries))[:5]:
        print(f"   q{qid} kws={kws}: {int(r['num'])} SLCAs, {int(r['num_elca'])} ELCAs")

    # the naive program (one message per step up the tree) finds the same SLCAs
    naive = make_xml_engine(SLCANaive, g, idx, capacity=8, **kw)
    for kws in queries:
        naive.submit(padded(kws))
    nres = naive.run_until_drained()
    assert all(np.array_equal(nres[q]["slca"], res[q]["slca"]) for q in res)
    print(f"== SLCANaive finds the same SLCAs for all {len(queries)} queries")

    # MaxMatch: the pruned matching trees
    eng2 = make_xml_engine(MaxMatch, g, idx, capacity=4, **kw)
    r = eng2.query(padded(queries[0][:2]))
    print(f"== MaxMatch for kws={queries[0]}: {int(r['num'])} vertices in result trees")


if __name__ == "__main__":
    main()
