"""Crash-tolerant serving on the PyTorch/CUDA port: durable store, query
journal, supervised recovery.

Builds a Hub^2 index once into a content-hashed store (restore boots with
ZERO index-construction rounds), then drains a journaled workload that is
crashed twice mid-flight — the recovered qid->result map must be
identical to an uninterrupted run.

Run:  PYTHONPATH=src python examples/torch_recovery.py            # on a GPU
      PYTHONPATH=src python examples/torch_recovery.py --device cpu
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.apps.hub2 import load_or_build_hub_index, make_hub2_engine
from repro_torch.apps.ppsp import make_bfs_engine
from repro_torch.core.graph import barabasi_albert
from repro_torch.core.store import Store
from repro_torch.launch.supervise import _result_map, run_with_recovery
from repro_torch.train.fault import FailureInjector


def demo(root: str, dev, n: int, hub_k: int):
    kw = dict(backend="cuda", device=dev)
    g = barabasi_albert(n, 3, seed=0, device=dev)
    print(f"== graph: |V|={g.n_real} |E|={g.num_edges} on {dev}")

    # ---- durable store: cold index build once, a load after -------------
    store = Store(os.path.join(root, "store"))
    t0 = time.perf_counter()
    idx, info = load_or_build_hub_index(store, g, k=hub_k, capacity=8, **kw)
    cold = time.perf_counter() - t0
    print(f"== cold boot: Hub^2 index built in {cold:.2f}s "
          f"({info['index_rounds']} super-rounds)")
    t0 = time.perf_counter()
    idx2, info2 = load_or_build_hub_index(Store(store.root), g, k=hub_k, **kw)
    warm = time.perf_counter() - t0
    assert not info2["built"] and info2["index_rounds"] == 0
    print(f"== restore:   index loaded in {warm:.3f}s "
          f"(0 super-rounds, {cold / max(warm, 1e-9):.1f}x faster boot)")
    q = np.asarray([3, n - 223], np.int32)
    assert int(make_hub2_engine(g, idx2, **kw).query(q)["dist"]) == \
        int(make_hub2_engine(g, idx, **kw).query(q)["dist"])

    # ---- journaled serving: crash twice, recover, identical answers -----
    rng = np.random.default_rng(1)
    submits = [
        (np.asarray(p, np.int32), dict(budget=int(16 + 8 * (i % 3))))
        for i, p in enumerate(rng.integers(0, g.n_real, (8, 2)))
    ]

    def boot():
        return make_bfs_engine(g, capacity=4, scheduler="sjf", **kw)

    base, _ = run_with_recovery(boot, os.path.join(root, "baseline.wal"),
                                submits, snapshot_every=2)
    want = _result_map(base)

    injector = FailureInjector(fail_at_steps={2, 5})  # crashes mid-drain
    eng, info = run_with_recovery(boot, os.path.join(root, "crashed.wal"),
                                  submits, snapshot_every=2, injector=injector)
    assert _result_map(eng) == want
    print(f"== crashed {info['restarts']}x mid-drain; last recovery "
          f"replayed {info['replayed_done']} retired, resumed "
          f"{info['resumed_from_snapshot']} from snapshot, resubmitted "
          f"{info['resubmitted']} fresh")
    print(f"== recovered map identical to the uninterrupted run ({len(want)} queries)")
    print("   (real SIGKILL drill: python -m repro_torch.launch.supervise "
          "--crash-test --device cuda)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--hub-k", type=int, default=16)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="quegel_recovery_")
    try:
        demo(root, dev, args.n, args.hub_k)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
