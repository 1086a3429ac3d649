"""End-to-end LM serving on the PyTorch/CUDA port: batched requests served
by the slot-table scheduler — continuous batching IS superstep-sharing.

Compares capacity C=1 (one request at a time) with C=8 (shared decode
rounds): far fewer rounds, and the same tokens wherever the reference
server gives them.  It does not for recurrent layers (ssm, hybrid), whose
state takes in the table-wide prefill steps of other slots, nor for MoE,
whose capacity the slots of one decode step share (ROADMAP.md §3); for
those the example prints how many requests differ.  The model is a
reduced config of the architecture (``--arch``, any of the ten) with
seeded random weights.

Run:  PYTHONPATH=src python examples/torch_serve_continuous_batching.py            # on a GPU
      PYTHONPATH=src python examples/torch_serve_continuous_batching.py --device cpu \
          --arch mamba2-780m
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.models import transformer as T


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced(get_arch(args.arch))
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid, rng.integers(0, cfg.vocab, int(rng.integers(4, 12)),
                                  dtype=np.int32),
                max_new_tokens=int(rng.integers(8, 24)))
        for rid in range(args.requests)
    ]

    for C in (1, 8):
        srv = SlotServer(cfg, params, capacity=C, max_len=64, device=dev)
        for r in reqs:
            srv.submit(Request(r.rid, r.prompt, r.max_new_tokens))
        sync(dev)
        t0 = time.perf_counter()
        res = srv.run_until_drained()
        sync(dev)
        dt = time.perf_counter() - t0
        assert len(res) == len(reqs)
        occ = np.mean(srv.stats.slot_occupancy) if srv.stats.slot_occupancy else 0
        print(f"== C={C} on {dev}: {srv.stats.tokens_generated} tokens for {len(reqs)} "
              f"requests in {dt:.2f}s — {srv.stats.rounds} shared rounds, "
              f"mean occupancy {occ:.2f}, {srv.stats.tokens_generated / dt:.1f} tok/s")

    # determinism: same request set, same outputs regardless of capacity
    s1 = SlotServer(cfg, params, capacity=1, max_len=64, device=dev)
    s8 = SlotServer(cfg, params, capacity=8, max_len=64, device=dev)
    for r in reqs[:4]:
        s1.submit(Request(r.rid, r.prompt, 8))
        s8.submit(Request(r.rid, r.prompt, 8))
    r1, r8 = s1.run_until_drained(), s8.run_until_drained()
    differ = sum(not np.array_equal(r1[k], r8[k]) for k in r1)
    if cfg.family in ("ssm", "hybrid") or cfg.n_experts:
        print(f"== {cfg.name}: outputs differ across capacities on {differ} of {len(r1)} "
              "requests (the reference server's shared recurrent state or MoE capacity)")
    else:
        assert not differ
        print("== outputs identical across capacities")

    # schedulers ride the shared SlotRuntime: sjf admits the shortest
    # declared jobs first; over-long prompts are REJECTED up front
    sv = SlotServer(cfg, params, capacity=1, max_len=64, scheduler="sjf", device=dev)
    sv.submit(Request(0, reqs[0].prompt, max_new_tokens=24, budget=24))
    sv.submit(Request(1, reqs[1].prompt, max_new_tokens=4, budget=4))
    sv.submit(Request(2, reqs[2].prompt, max_new_tokens=80))  # > max_len
    sv.run_until_drained()
    print(f"== sjf statuses: {sv.statuses} ({sv.stats.rejected} rejected; "
          "short job admitted first)")


if __name__ == "__main__":
    main()
