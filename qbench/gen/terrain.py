"""A terrain network built as Quegel §5.3 builds it, frozen here as numpy.

A copy of the arithmetic of ``repro_torch.core.graph.grid_terrain``: a
seeded synthetic elevation grid (smooth hills and up to 1.5 m of noise, a
stand-in for a DEM's samples, 10 m apart) of ``rows x cols`` samples,
each cell edge split ``eps_subdiv`` times (the shortcut vertices of the
paper's Fig. 4(b)), 8-connected, with float32 3D-Euclidean arc weights.
It returns the arrays the graph is built from, so the benchmark and its
reference read the same data; a CPU test holds them byte-equal to the
port's generator.
"""
from __future__ import annotations

import numpy as np


def terrain_arrays(rows: int, cols: int, eps_subdiv: int, seed: int):
    """``(coords (n, 3) float32, src, dst (E,) int32, w (E,) float32, n)``."""
    rng = np.random.default_rng(seed)
    r = rows * eps_subdiv - (eps_subdiv - 1)
    c = cols * eps_subdiv - (eps_subdiv - 1)
    yy0, xx0 = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    elev = (
        12.0 * np.sin(yy0 / 6.0) * np.cos(xx0 / 7.0)
        + 6.0 * np.sin((yy0 + xx0) / 11.0)
        + rng.random((rows, cols)) * 1.5
    ).astype(np.float32)
    yi = np.linspace(0, rows - 1, r)
    xi = np.linspace(0, cols - 1, c)
    y0 = np.clip(yi.astype(int), 0, rows - 2)
    x0 = np.clip(xi.astype(int), 0, cols - 2)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    z = (
        elev[y0][:, x0] * (1 - fy) * (1 - fx)
        + elev[y0 + 1][:, x0] * fy * (1 - fx)
        + elev[y0][:, x0 + 1] * (1 - fy) * fx
        + elev[y0 + 1][:, x0 + 1] * fy * fx
    ).astype(np.float32)
    spacing = 10.0 / eps_subdiv
    ys, xs = np.meshgrid(np.arange(r), np.arange(c), indexing="ij")
    coords = np.stack(
        [xs.ravel() * spacing, ys.ravel() * spacing, z.ravel()], axis=1
    ).astype(np.float32)
    n = r * c
    src_l, dst_l = [], []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        y = np.arange(max(0, -dy), r - max(0, dy))
        x = np.arange(max(0, -dx), c - max(0, dx))
        yy, xx = np.meshgrid(y, x, indexing="ij")
        a = (yy * c + xx).ravel()
        b = ((yy + dy) * c + xx + dx).ravel()
        src_l += [a, b]
        dst_l += [b, a]
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    w = np.linalg.norm(coords[src] - coords[dst], axis=1).astype(np.float32)
    return coords, src, dst, w, n
