"""Terrain shortest paths (Quegel §5.3) on a DEM mesh built as the paper
builds its terrain network, over a seeded elevation grid.

The port's ``make_terrain_engine`` answers float32 network distances with
the d_E^min early stop, ``unreachable`` where t cannot be reached; the
reference is plain label correction in float64 (``ref/sssp.py``), the
control, answering in the program's place, the same search in bfloat16.
The number compared is the widest gap between an answer and the
reference, relative to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from qbench.apps import System
from qbench.gen.terrain import terrain_arrays
from qbench.ref.sssp import arc_weights, sssp_distances


def build(config: dict, seed: int, device) -> System:
    from repro_torch.apps.terrain import make_terrain_engine
    from repro_torch.core.graph import Graph

    c = config
    coords, src, dst, w, n = terrain_arrays(c["rows"], c["cols"], c["eps_subdiv"], seed)
    graph = Graph.from_edges(src, dst, n, w=w, weight_dtype=np.float32, device=device)
    engine = make_terrain_engine(graph, coords, device=device, **config["engine"])
    t_src = torch.from_numpy(src).to(device)
    t_dst = torch.from_numpy(dst).to(device)
    out_deg = torch.bincount(t_src.long(), minlength=n)
    pool = (out_deg > 0).nonzero().squeeze(1).to(torch.int32).cpu().numpy()
    return System(engine, pool, {"default": out_deg},
                  {"src": t_src, "dst": t_dst, "coords": torch.from_numpy(coords).to(device),
                   "n": n, "arcs": int(src.size)})


def _distances(system: System, queries: np.ndarray, dtype) -> np.ndarray:
    d = system.data
    w = arc_weights(d["coords"], d["src"], d["dst"], dtype)
    got = sssp_distances(d["src"], d["dst"], w, d["n"], queries[:, 0], queries[:, 1])
    return got.double().cpu().numpy()


def max_rel_gap(answers: np.ndarray, ref: np.ndarray) -> float:
    """The widest ``|answer - ref| / ref`` (``|answer|`` where ref is 0);
    both unreachable (inf) is no gap, one of them is an infinite one."""
    both = np.isinf(answers) & np.isinf(ref)
    with np.errstate(invalid="ignore"):
        gap = np.abs(answers - ref) / np.where(ref > 0, ref, 1.0)
    gap = np.where(both, 0.0, np.where(np.isnan(gap), np.inf, gap))
    return float(gap.max(initial=0.0))


def judge(system: System, queries: np.ndarray, results: list, config: dict) -> dict:
    answers = np.asarray([float(r[config["answer"]["key"]]) for r in results], np.float64)
    answers[answers >= config["answer"]["unreachable"]] = np.inf
    return {"max_rel_gap": max_rel_gap(answers, _distances(system, queries, torch.float64))}


def control(system: System, queries: np.ndarray, config: dict) -> list:
    """The search in bfloat16, answering in the program's form."""
    ctl = _distances(system, queries, torch.bfloat16)
    sentinel = config["answer"]["unreachable"]
    return [{config["answer"]["key"]: float(v) if np.isfinite(v) else sentinel} for v in ctl]
