"""Query pairs drawn from the seed.

A stream hands out ``(s, t)`` pairs uniform over a pool of vertices (the
vertices with at least one arc), with replacement.  The stream named
``kind`` of a seed is its own numpy generator, so the warm-up's queries and
the window's never shift one another.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

STREAMS = {"window": 0, "warmup": 1}


class PairStream:
    """Pairs ``(s, t)`` as int32 rows."""

    def __init__(self, pool: np.ndarray, seed: int, kind: str, draw: Optional[dict] = None):
        pool = np.asarray(pool, dtype=np.int32)
        if len(pool) == 0:
            raise ValueError("the query pool is empty")
        draw = draw or {"draw": "uniform"}
        if draw["draw"] != "uniform":
            raise ValueError(f"unknown pair draw {draw['draw']!r}")
        self.rng = np.random.default_rng([int(seed), STREAMS[kind]])
        self.pool = pool
        self._buf = np.zeros((0, 2), np.int32)
        self._i = 0

    def next(self) -> np.ndarray:
        if self._i == len(self._buf):
            self._buf = self.pool[self.rng.integers(0, len(self.pool), size=(4096, 2))]
            self._i = 0
        row = self._buf[self._i]
        self._i += 1
        return row
