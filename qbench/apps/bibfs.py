"""PPSP by bidirectional BFS (Quegel §5.1) on a Graph500 Kronecker graph.

The port's ``make_bibfs_engine`` answers ``d(s, t)`` in hops, with
``unreachable`` (the port's documented sentinel) where t cannot be reached;
the reference is plain BFS (``ref/hops.py``), and the control, answering
in the program's place, the first-meet bidirectional search that breaks
the exactness guarantee.
"""
from __future__ import annotations

import numpy as np
import torch

from qbench.apps import System
from qbench.gen.kronecker import kronecker_graph
from qbench.ref.hops import first_meet_distances, hop_distances


def build(config: dict, seed: int, device) -> System:
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.core.graph import Graph

    c = config
    src, dst, n = kronecker_graph(c["scale"], c["edgefactor"], c["a"], c["b"], c["c"],
                                  c["structure_seed"], seed, device)
    out_deg = torch.bincount(src.long(), minlength=n)
    in_deg = torch.bincount(dst.long(), minlength=n)
    pool = (out_deg > 0).nonzero().squeeze(1).to(torch.int32).cpu().numpy()
    graph = Graph.from_edges(src.cpu().numpy(), dst.cpu().numpy(), n, device=device)
    engine = make_bibfs_engine(graph, device=device, **config["engine"])
    return System(engine, pool, {"default": out_deg, "rev": in_deg},
                  {"src": src, "dst": dst, "n": n, "arcs": int(src.numel())})


def _reference(system: System, queries: np.ndarray) -> np.ndarray:
    d = system.data
    return hop_distances(d["src"], d["dst"], d["n"], queries[:, 0],
                         queries[:, 1]).cpu().numpy()


def judge(system: System, queries: np.ndarray, results: list, config: dict) -> dict:
    answers = np.asarray([int(r[config["answer"]["key"]]) for r in results], np.int64)
    got = np.where(answers == config["answer"]["unreachable"], -1, answers)
    return {"mismatches": int((got != _reference(system, queries)).sum())}


def control(system: System, queries: np.ndarray, config: dict) -> list:
    """The first-meet search's answers in the program's form."""
    d = system.data
    ctl = first_meet_distances(d["src"], d["dst"], d["n"], queries[:, 0],
                               queries[:, 1]).cpu().numpy()
    sentinel = config["answer"]["unreachable"]
    return [{config["answer"]["key"]: int(v) if v >= 0 else sentinel} for v in ctl]
