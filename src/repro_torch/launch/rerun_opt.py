"""Re-trace the cells the JAX package's §Perf optimizations touched
(``repro.launch.rerun_opt``: blocked MoE dispatch, flash-decode, stacked
cache sharding, the ZeRO-1 policy) into runs/dryrun_opt, the column
beside the baseline dry run that ``launch/compare.py`` reads.

Usage: PYTHONPATH=src python -m repro_torch.launch.rerun_opt [--mp] [--out runs/dryrun_opt]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch.dryrun import fake_group, lower_cell
from repro_torch.launch.mesh import MESH_NAMES

MOE = ["arctic-480b", "deepseek-v2-236b"]
ALL = ["arctic-480b", "deepseek-v2-236b", "gemma2-9b", "glm4-9b",
       "llava-next-34b", "mamba2-780m", "recurrentgemma-2b",
       "starcoder2-15b", "tinyllama-1.1b", "whisper-base"]
SUBQ = ["mamba2-780m", "recurrentgemma-2b"]


DENSE_BIG = ["gemma2-9b", "glm4-9b", "llava-next-34b", "starcoder2-15b",
             "recurrentgemma-2b"]  # FSDP->ZeRO-1 policy change


def cells():
    out = []
    for a in MOE:  # blocked dispatch
        for s in ("train_4k", "prefill_32k"):
            out.append((a, s))
    for a in DENSE_BIG:  # ZeRO-1 moments / TP-only params
        for s in ("train_4k", "prefill_32k"):
            out.append((a, s))
    for a in ("tinyllama-1.1b", "whisper-base", "mamba2-780m"):
        # pure-DP models: ZeRO-1 moments + batch-prefix shard() fix
        out.append((a, "train_4k"))
        out.append((a, "prefill_32k"))
    for a in ALL:  # flash-decode + cache sharding
        out.append((a, "decode_32k"))
    for a in SUBQ:
        out.append((a, "long_500k"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mp", action="store_true", help="also run the multi-pod mesh")
    ap.add_argument("--out", default="runs/dryrun_opt")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.mp else [False]
    failures = 0
    for mp in meshes:
        import torch.distributed as dist

        fake_group(512 if mp else 256)
        try:
            for arch, shape in cells():
                tag = f"{arch}_{shape}_{'mp' if mp else 'sp'}"
                print(f"[rerun_opt] {tag}", flush=True)
                try:
                    res = lower_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # one cell's failure is reported, the sweep goes on
                    traceback.print_exc()
                    res = dict(arch=arch, shape=shape, mesh=MESH_NAMES[mp], status="FAILED",
                               error=f"{type(e).__name__}: {e}")
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=2, default=str)
                print(f"  -> {res['status']}", flush=True)
        finally:
            dist.destroy_process_group()
    print(f"[rerun_opt] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
