"""LM serving (``repro.launch.serve``): continuous batching as
superstep-sharing.

A *slot table* holds up to C in-flight requests (the engine's capacity
parameter); every shared decode step advances all live slots by one token
with one ``serve_step`` over the whole (C, ...) table and one device->host
copy of the chosen tokens, exactly a Quegel super-round.  Requests are
admitted from a queue as slots free up; a finished request (EOS or
max_new_tokens) releases its slot at the end of the round.

The slot lifecycle (queue, admission, liveness mirror, retirement, stats,
drain, schedulers, budgets with TIMEOUT eviction, preemption, the journal)
is the shared ``core/runtime.py::SlotRuntime``, so this class is only the
device-side ``SlotProgram``: prefill, decode and retirement decisions.  A
request whose ``prompt + max_new_tokens`` exceeds ``max_len`` is REJECTED
up front.

Prefill is the JAX server's: one ``serve_step`` over the whole table per
prompt token, the admitted slot writing positions 0..L-1 while every
other slot rewrites token 0 at its ``base_pos`` (the entry the next
decode step writes again), so every cache entry equals the JAX server's.
Two latent faults of the JAX server come with it (ROADMAP.md §3): a
recurrent layer's state (ssm, rec) takes in every such step of every
slot, and the first decode step's repeat of the last prompt token; and
a MoE layer's capacity is shared by the C slots that one step routes,
so a request's tokens depend on what shares its table.
The cache is float32, as in JAX; a model whose parameters are narrower
and whose layers are stacked cannot be served there (the stacked loop's
carry would change dtype), and ``SlotServer`` refuses it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.runtime import (
    REJECTED, ResumeAdmission, RoundOutcome, SlotProgram, SlotRuntime,
    SlotStats, to_numpy, tree_leaves, tree_map)
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int = 32
    eos_id: int = -1  # -1: never; else stop on this token
    # scheduling attributes: admission priority level, earliest-deadline-
    # first key, and a declared token budget (sjf size estimate + TIMEOUT
    # eviction bound; 0 = undeclared).
    priority: int = 0
    deadline: float = math.inf
    budget: int = 0


@dataclasses.dataclass
class ServeStats(SlotStats):
    """Shared lifecycle counters (SlotStats) under the server's names.
    ``rejected`` counts requests refused at admission (prompt +
    max_new_tokens > max_len); ``timeouts`` counts budget evictions."""

    tokens_generated: int = 0

    @property
    def requests_done(self) -> int:
        return self.queries_done

    @property
    def tokens_per_s(self) -> float:
        t = sum(self.round_times)
        return self.tokens_generated / t if t else 0.0


class SlotServer(SlotProgram):
    """Superstep-shared decode over a slot table of capacity C, on
    ``resolve_device(device)`` (where ``params`` must live)."""

    def __init__(self, cfg: ArchConfig, params, capacity: int = 8,
                 max_len: int = 256, greedy: bool = True,
                 scheduler="fifo", result_cache: Optional[int] = None,
                 preemptive: bool = False, preempt_margin: float = 0.0,
                 journal=None, snapshot_every: int = 0, straggler=None,
                 max_retries: int = 2, device=None):
        if cfg.dtype != "float32" and T.n_stacked(cfg):
            raise ValueError(
                f"{cfg.name}: {cfg.dtype} parameters with stacked layers cannot "
                "decode against the float32 slot cache (the JAX server's "
                "lax.scan carry would turn float32 after the first layer); "
                "serve a float32 config")
        self.device = resolve_device(device)
        if any(t.device.type != self.device.type for t in tree_leaves(params)):
            raise ValueError(f"{cfg.name}: the server runs on {self.device}, and "
                             "its params must live there too")
        self.cfg = cfg
        self.params = params
        self.C = capacity
        self.max_len = max_len
        self.greedy = greedy
        self.runtime = SlotRuntime(
            self, capacity, scheduler=scheduler, stats=ServeStats(),
            cache_size=result_cache, preemptive=preemptive,
            preempt_margin=preempt_margin, journal=journal,
            snapshot_every=snapshot_every, straggler=straggler,
            max_retries=max_retries,
        )
        self._slot_req: dict[int, Request] = {}
        self._pos = np.zeros(capacity, np.int32)  # next position to write
        self._remaining = np.zeros(capacity, np.int32)
        self._generated: list[list[int]] = [[] for _ in range(capacity)]
        self._last_tok = np.zeros(capacity, np.int32)
        # the slot-table cache: leading axis C (batch axis of serve_step)
        self.cache = T.init_cache(cfg, capacity, max_len, dtype=torch.float32,
                                  device=self.device)

    @property
    def stats(self) -> ServeStats:
        return self.runtime.stats

    @stats.setter
    def stats(self, value) -> None:
        self.runtime.stats = value

    @property
    def results(self) -> dict:
        """rid -> generated tokens (int32 array; empty when REJECTED)."""
        return self.runtime.results

    @property
    def statuses(self) -> dict:
        """rid -> DONE | TIMEOUT | REJECTED (see core/runtime.py)."""
        return self.runtime.status

    # -------------------------------------------------------------- round
    def _step(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One ``serve_step`` over all C slots; returns the logits."""
        with torch.no_grad():
            logits, self.cache = T.serve_step(self.params, self.cfg, self.cache,
                                              tokens, pos)
        return logits

    def _prefill_slot(self, slot: int, prompt: np.ndarray):
        """Whole-prompt prefill for one slot: one step per prompt token, the
        admitted slot writing positions 0..L-1 while every other slot is
        masked to a harmless rewrite of its ``base_pos`` entry (the same
        write the next decode step redoes with real data)."""
        dev = self.device
        onehot = torch.arange(self.C, device=dev) == slot
        toks = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)
        base_pos = torch.as_tensor(self._pos_vec(), device=dev)
        for i in range(len(prompt)):
            tok = torch.where(onehot, toks[i], 0)[:, None]
            pos = torch.where(onehot, i, base_pos).to(torch.int32)
            self._step(tok, pos)
        self._pos[slot] = len(prompt)
        self._last_tok[slot] = int(prompt[-1])

    def _pos_vec(self):
        # dead slots decode at position 0 harmlessly (results discarded)
        return np.where(self.runtime.live, self._pos, 0).astype(np.int32)

    # ------------------------------------------- SlotProgram (device side)
    def slot_validate(self, req: Request):
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            return REJECTED, np.asarray([], np.int32)
        return None

    def slot_round(self, admitted: dict) -> RoundOutcome:
        """Prefill newly admitted prompts, then ONE shared decode step for
        all live slots; done/steps come from the host-side token
        bookkeeping (EOS / max_new_tokens / max_len)."""
        axes = self._cache_slot_axes()
        for slot, req in admitted.items():
            if isinstance(req, ResumeAdmission):
                # suspended mid-decode: restore the slot's KV-cache rows and
                # decode bookkeeping instead of prefilling
                p = req.payload
                tree_map(lambda tab, row, ax: tab.select(ax, slot).copy_(
                    torch.as_tensor(row)), self.cache, p["cache"], axes)
                self._pos[slot] = p["pos"]
                self._remaining[slot] = p["remaining"]
                self._generated[slot] = list(p["generated"])
                self._last_tok[slot] = p["last_tok"]
                self._slot_req[slot] = req.query
                continue
            self._prefill_slot(slot, req.prompt)
            self._slot_req[slot] = req
            self._remaining[slot] = req.max_new_tokens
            self._generated[slot] = []
        live = self.runtime.live
        tokens = torch.as_tensor(self._last_tok[:, None], device=self.device)
        # position of the last written token (-1 for a dead slot)
        pos = torch.as_tensor(self._pos_vec() - 1, device=self.device)
        # argmax takes the first index on ties, as jnp.argmax does
        nxt = to_numpy(torch.argmax(self._step(tokens, pos), dim=-1).to(torch.int32))
        done = np.zeros(self.C, bool)
        steps = np.zeros(self.C, np.int32)
        for slot in range(self.C):
            if not live[slot]:
                continue
            tok = int(nxt[slot])
            self._generated[slot].append(tok)
            self.stats.tokens_generated += 1
            self._remaining[slot] -= 1
            self._last_tok[slot] = tok
            self._pos[slot] += 1
            req = self._slot_req[slot]
            done[slot] = (
                self._remaining[slot] <= 0
                or tok == req.eos_id
                or self._pos[slot] >= self.max_len
            )
            steps[slot] = len(self._generated[slot])
        return RoundOutcome(done=done, steps=steps)

    def slot_collect(self, slots: list[int]) -> list:
        return [np.asarray(self._generated[s], np.int32) for s in slots]

    def _cache_slot_axes(self):
        """Pytree (matching ``self.cache``) of the slot/batch axis per leaf:
        ``blocks`` leaves are stacked over super-blocks by init_cache (axis 0
        is the stacked layer axis, slots live on axis 1); everything else
        (``rem_blocks``, ``enc_out``) is slot-leading."""
        axes = tree_map(lambda _: 0, self.cache)
        axes["blocks"] = tree_map(lambda _: 1, self.cache["blocks"])
        return axes

    def slot_suspend(self, slots: list[int]) -> list:
        """Suspend mid-decode: pull each victim's cache rows to host (every
        leaf: keys and values, MLA latents, recurrent and conv states,
        ``enc_out``; the JAX payload: numpy rows on the same axes) along
        with its decode bookkeeping; resuming restores both, so the
        continued generation is token-identical to an uninterrupted run."""
        axes = self._cache_slot_axes()
        payloads = []
        for s in (int(s) for s in slots):
            payloads.append(dict(
                cache=tree_map(lambda tab, ax: to_numpy(tab.select(ax, s)),
                               self.cache, axes),
                pos=int(self._pos[s]),
                remaining=int(self._remaining[s]),
                generated=list(self._generated[s]),
                last_tok=int(self._last_tok[s]),
            ))
            self._slot_req.pop(s, None)
        return payloads

    def cache_key(self, req: Request) -> str:
        h = hashlib.sha1(np.asarray(req.prompt, np.int32).tobytes())
        h.update(f"{req.max_new_tokens},{req.eos_id}".encode())
        return h.hexdigest()

    # ------------------------------------------------------------- client
    def submit(self, req: Request):
        self.runtime.submit(
            req, qid=req.rid,
            priority=req.priority, deadline=req.deadline, budget=req.budget,
        )

    def run_round(self) -> bool:
        """Admission + one shared decode step + retirement (one barrier).
        False when there was nothing to run."""
        return self.runtime.run_round() is not None

    def run_until_drained(self, max_rounds: int = 100_000):
        return self.runtime.run_until_drained(max_rounds)

    def pump(self):
        """Open-loop mode: at most one decode round, returning terminal
        ``(qid, result, status)`` transitions."""
        return self.runtime.pump()

    def poll(self, qid: int):
        return self.runtime.poll(qid)


def main(argv=None):
    import argparse

    from repro_torch.configs import get_arch, reduced

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--scheduler", default="fifo",
                    choices=["fifo", "priority", "sjf", "deadline"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_arch(args.arch))
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    srv = SlotServer(cfg, params, capacity=args.capacity, max_len=96,
                     scheduler=args.scheduler, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        srv.submit(Request(rid, rng.integers(0, cfg.vocab, plen, dtype=np.int32),
                           max_new_tokens=args.max_new,
                           budget=args.max_new))
    res = srv.run_until_drained()
    print(f"served {len(res)} requests, {srv.stats.tokens_generated} tokens, "
          f"{srv.stats.rounds} shared rounds ({args.scheduler}) on {dev}, "
          f"{srv.stats.tokens_per_s:.1f} tok/s, "
          f"mean occupancy {np.mean(srv.stats.slot_occupancy):.2f}/{args.capacity}, "
          f"{srv.stats.rejected} rejected")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
