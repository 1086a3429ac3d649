"""Data pipeline (``repro.train.data``): a deterministic synthetic LM stream
and a background prefetcher.

The stream is seeded per (seed, step), so a restarted job sees exactly
the batches it would have seen and checkpoint/restart equivalence is
testable bit for bit.  A thread prefetches ahead of the training loop.
The batches are numpy arrays, byte-equal to the JAX package's; the port
keeps its own copy so that it imports nothing of that package.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def synthetic_stream(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                     start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, batch, seq, seed, step)
        step += 1


class Prefetcher:
    """Background-thread prefetch with bounded depth."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
