"""Arrival processes for open-loop traffic, frozen here.

A copy of ``repro_torch.launch.loadgen``'s ``poisson_arrivals``,
``constant_arrivals`` and ``mmpp_arrivals`` (numpy only): the same
arguments give the same arrays.  Times are seconds from the window's
opening.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """``n`` arrival times with Exp(1/rate) inter-arrival gaps."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate, int(n)))


def constant_arrivals(rate: float, n: int, *, seed: int = 0,
                      start: float = 0.0) -> np.ndarray:
    """Arrival i at ``start + (i+1)/rate``; ``seed`` is accepted and ignored."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    return start + (np.arange(int(n), dtype=np.float64) + 1.0) / rate


def mmpp_arrivals(rate: float, n: int, *, seed: int = 0, start: float = 0.0,
                  burst: float = 4.0, dwell: float = 8.0) -> np.ndarray:
    """2-state Markov-modulated Poisson process: a hot state (rate
    ``burst * b``) and a cold one (``b / burst``) with Exp(``dwell``)-mean
    dwells, ``b`` chosen so the long-run rate is ``rate``."""
    if rate <= 0 or burst < 1.0 or dwell <= 0:
        raise ValueError("need rate > 0, burst >= 1, dwell > 0")
    rng = np.random.default_rng(seed)
    b = 2.0 * rate / (burst + 1.0 / burst)
    state_rates = (burst * b, b / burst)
    out: list[float] = []
    t = float(start)
    state = 0
    while len(out) < n:
        t_end = t + rng.exponential(dwell)
        r = state_rates[state]
        while len(out) < n:
            t_next = t + rng.exponential(1.0 / r)
            if t_next > t_end:
                break
            out.append(t_next)
            t = t_next
        t = t_end
        state = 1 - state
    return np.asarray(out, dtype=np.float64)


ARRIVALS: dict[str, Callable[..., np.ndarray]] = {
    "poisson": poisson_arrivals,
    "constant": constant_arrivals,
    "mmpp": mmpp_arrivals,
}


def make_arrivals(process: str, rate: float, n: int, *, seed: int = 0,
                  **kw) -> np.ndarray:
    if process not in ARRIVALS:
        raise ValueError(f"unknown arrival process {process!r}: expected one of "
                         f"{sorted(ARRIVALS)}")
    return ARRIVALS[process](rate, n, seed=seed, **kw)
