"""Baseline-vs-optimized comparison table over the dry runs' JSON
(``repro.launch.compare``): runs/dryrun against runs/dryrun_opt, single-
pod cells, then the multi-pod fit summary.

Usage: PYTHONPATH=src python -m repro_torch.launch.compare
"""
import glob
import json
import math
import os

from repro_torch.launch.mesh import MESH_NAMES


def load(d):
    out = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        with open(f) as fh:
            c = json.load(fh)
        if c.get("status") == "compiled":
            out[(c["arch"], c["shape"], c["mesh"])] = c
    return out


def main():
    base = load("runs/dryrun")
    opt = load("runs/dryrun_opt")
    rows = [
        "| arch | shape | coll B/dev (base→opt) | t_bound (base→opt) | frac (base→opt) | peak mem (base→opt) |",
        "|---|---|---|---|---|---|",
    ]
    gains = []
    for key in sorted(opt):
        if key[2] != MESH_NAMES[False] or key not in base:
            continue
        b, o = base[key], opt[key]
        rb, ro = b.get("roofline"), o.get("roofline")
        if not (rb and ro):
            continue
        tb = max(rb["t_compute"], rb["t_memory"], rb["t_collective"])
        to = max(ro["t_compute"], ro["t_memory"], ro["t_collective"])
        mb = b["memory"]["temp_bytes"] / 2**30
        mo = o["memory"]["temp_bytes"] / 2**30
        gains.append(tb / to if to else 1)
        rows.append(
            f"| {key[0]} | {key[1]} | {rb['coll_bytes']:.2e} → {ro['coll_bytes']:.2e} | "
            f"{tb:.1f}s → {to:.1f}s (**{tb/max(to,1e-9):.1f}×**) | "
            f"{rb['roofline_fraction']:.3f} → {ro['roofline_fraction']:.3f} | "
            f"{mb:.0f} → {mo:.0f} GiB |"
        )
    print("\n".join(rows))
    if gains:
        gm = math.exp(sum(math.log(g) for g in gains) / len(gains))
        print(f"\nGeometric-mean bound-time speedup over {len(gains)} "
              f"re-run cells: **{gm:.2f}×**")
    # multi-pod fit summary for opt cells
    mp = [(k, v) for k, v in opt.items() if k[2] == MESH_NAMES[True]]
    if mp:
        worst = max(mp, key=lambda kv: kv[1]["memory"]["temp_bytes"])
        print(f"\nMulti-pod optimized cells compiled: {len(mp)}; max temp/dev "
              f"{worst[1]['memory']['temp_bytes']/2**30:.1f} GiB "
              f"({worst[0][0]} × {worst[0][1]})")


if __name__ == "__main__":
    main()
