"""Versioned mutable graphs on the PyTorch/CUDA port: serving PPSP queries
while the graph changes.

A Hub^2 serving engine absorbs batched edge deltas BETWEEN rounds — roads
close and reopen — while queries keep flowing.  Each mutation bumps the
graph version: queries already in flight finish on the version they were
admitted under, new admissions see the new one, the result cache drops
every entry keyed to another version, and the Hub^2 index is maintained
incrementally (only the hubs whose labels can change are re-labeled;
past a delta-size threshold the whole index is rebuilt).

Run:  PYTHONPATH=src python examples/torch_mutation.py            # on a GPU
      PYTHONPATH=src python examples/torch_mutation.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.apps.hub2 import build_hub_index, hub_index_updater, make_hub2_engine
from repro_torch.core.graph import barabasi_albert
from repro_torch.core.semiring import INF


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--hub-k", type=int, default=16)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    kw = dict(backend="cuda", device=dev)
    k = args.hub_k

    g = barabasi_albert(args.n, 3, seed=0, device=dev)
    print(f"== graph: |V|={g.n_real} |E|={g.num_edges} version={g.version} on {dev}")

    t0 = time.perf_counter()
    idx = build_hub_index(g, k=k, **kw)
    print(f"== Hub^2 index: k={k}, built in {time.perf_counter() - t0:.2f}s")
    eng = make_hub2_engine(
        g, idx, capacity=4, result_cache=32,
        index_fn=hub_index_updater(threshold=0.01, backend="cuda"), **kw)

    rng = np.random.default_rng(1)
    pairs = [tuple(int(v) for v in p) for p in rng.integers(0, g.n_real, (6, 2))]

    def serve(tag):
        qids = {eng.submit(np.asarray(p, np.int32)): p for p in pairs}
        res = eng.run_until_drained()
        dists = {qids[q]: int(res[q]["dist"]) for q in qids}
        shown = {p: ("INF" if d >= INF else d) for p, d in dists.items()}
        st = eng.runtime.stats
        print(f"   [{tag}] v={eng.graph.version} answers={shown} "
              f"cache_hits={st.cache_hits} "
              f"cache_invalidations={st.cache_invalidations}")
        return dists

    print("== serve the same 6 PPSP queries across a mutation sequence")
    before = serve("v0 cold")
    serve("v0 warm")  # second pass: all six served from the result cache

    # ---- close a junction: every road at one queried endpoint ----------
    es, ed = g.src.cpu().numpy()[:g.nnz], g.dst.cpu().numpy()[:g.nnz]
    s0, t0_v = pairs[0]
    closed = [(int(a), int(b)) for a, b in zip(es, ed)
              if s0 in (int(a), int(b))]  # undirected: both arcs listed
    t0 = time.perf_counter()
    info = eng.apply_delta(dels=closed)
    print(f"== close all {len(closed) // 2} roads at junction {s0} -> "
          f"v{info['version']} in {(time.perf_counter() - t0) * 1e3:.1f}ms: "
          f"index={info['index']['mode']} "
          f"(relabeled {info['index']['affected_hubs']}/{k} hubs), "
          f"cache dropped {info['cache_invalidated']} entries")
    after = serve("v1")
    assert after[(s0, t0_v)] >= INF and before[(s0, t0_v)] < INF
    print(f"   ({s0}, {t0_v}) went {before[(s0, t0_v)]} -> unreachable "
          "with the junction closed")

    # ---- reopen them: content reverts, answers come back ---------------
    info = eng.apply_delta(adds=closed)
    print(f"== reopen them -> v{info['version']}: "
          f"index={info['index']['mode']} "
          f"(relabeled {info['index']['affected_hubs']}/{k} hubs)")
    assert serve("v2") == before, "reopened graph must answer like v0"
    print("== the reopened graph answers as version 0 did")

    # ---- a big rewiring trips the rebuild threshold --------------------
    adds = []
    present = set(zip(es.tolist(), ed.tolist()))
    while len(adds) < 2 * (g.num_edges // 50):  # ~4% of |E| in one batch
        a, b = (int(v) for v in rng.integers(0, g.n_real, 2))
        if a != b and (a, b) not in present and (a, b) not in adds:
            adds += [(a, b), (b, a)]
    t0 = time.perf_counter()
    info = eng.apply_delta(adds=adds)
    print(f"== add {len(adds) // 2} new roads (~{len(adds) / g.num_edges:.0%} "
          f"of |E|) -> v{info['version']} "
          f"in {(time.perf_counter() - t0) * 1e3:.0f}ms: "
          f"index={info['index']['mode']} (past threshold "
          f"{info['index']['threshold']:.0%}, hubs re-picked)")
    serve("v3")
    print(f"== editions alive: {info['editions']} (old versions are pruned "
          "once no in-flight query pins them)")


if __name__ == "__main__":
    main()
