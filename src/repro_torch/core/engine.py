"""The Quegel engine on PyTorch: query-centric superstep-sharing.

The paper's central idea (§3.1): up to ``C`` concurrent queries each advance
one superstep per *super-round*, sharing a single synchronization barrier.
Per-query state lives in a dense slot table (leading axis C) on the device,
and the vertex program is written batched over that slot axis (the JAX
package vmaps a per-slot program instead: a custom kernel under
``torch.func.vmap`` would need a batching rule, and one batched launch is
what the kernel wants).

One fused round (``slot_round``):
  * batched admission of every newly assigned slot (one ``init`` call over
    the admitted rows, written into the preallocated slot tensors in
    place — the counterpart of the reference's donation);
  * ``steps_per_round`` masked supersteps, run unconditionally: a finished
    slot has ``adv = live`` false and never advances, so results and
    ``step`` counters stay exact with no host sync between supersteps;
  * exactly ONE device->host sync: ``done`` and ``step`` stacked and
    copied together.

The slot lifecycle (queue, admission, liveness mirror, retirement, stats,
drain) lives in ``core/runtime.py::SlotRuntime``.  Propagation is
pluggable: one ``kernels/ops.py::PropagateBackend`` per named view
('default', 'rev', ...).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.core.runtime import (
    DONE, QueryTimeoutError, ResumeAdmission, RoundOutcome, SlotProgram,
    SlotRuntime, SlotStats, default_cache_key, to_numpy, tree_map)
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ops

# Engine options of the JAX package that later slices port, with the
# ROADMAP.md item that carries each.
_NOT_PORTED = {
    "legacy": "§1 item 4 (legacy=True A/B baseline)",
    "mesh": "§1 item 10 (mesh mode)",
    "preemptive": "§1 item 7 (preemption)",
    "journal": "§1 item 7 (durability and recovery)",
    "arg_carried": "§1 item 8 (mutable graphs)",
    "warmup": "§1 item 8 (mutable graphs)",
    "index_fn": "§1 item 8 (mutable graphs)",
    "gather_edges": "§1 item 2 (coo_gated / gather_edges)",
    "track_frontier": "§1 item 4 (track_frontier)",
    "propagate_override": "§1 item 4 (propagate_override)",
}


@dataclasses.dataclass
class StepCtx:
    """Everything ``superstep`` may touch besides its own VQ/Q-data.

    query     : (C, ...) the slots' query content
    step      : (C,) int32, 1-based as in Pregel/Quegel
    propagate : (semiring, x (C, V), frontier (C, V) bool, which=view) ->
                combined messages (C, V)
    """

    graph: Graph
    query: Any
    step: torch.Tensor
    propagate: Callable
    index: Any = None


class VertexProgram:
    """Base class users subclass per query type (paper §4), batched over
    the slot axis.

    ``init(graph, queries, index)`` -> VQ/Q-data pytree with a leading axis
                                       over the A admitted queries
                                       (``queries`` is (A, ...)).
    ``superstep(state, ctx)``       -> (state, done (C,) bool) — one Pregel
                                       superstep for every slot.
    ``extract(state, query)``       -> small result pytree, leading axis C.
    """

    def init(self, graph: Graph, query, index=None):
        raise NotImplementedError

    def superstep(self, state, ctx: StepCtx):
        raise NotImplementedError

    def extract(self, state, query):
        raise NotImplementedError


@dataclasses.dataclass
class EngineStats(SlotStats):
    """Shared lifecycle counters under the engine's names: ``super_rounds``
    and ``barriers`` both read the runtime's round counter."""

    @property
    def super_rounds(self) -> int:
        return self.rounds

    @property
    def barriers(self) -> int:
        return self.rounds


def _expand_as(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable against a (C, ...) leaf."""
    return mask.view(mask.shape + (1,) * (x.dim() - 1))


class QuegelEngine(SlotProgram):
    """Superstep-sharing scheduler (paper §3).

    capacity   : the paper's C — max queries in flight per super-round.
    backend    : 'coo', 'blocks_ref', 'cuda', or a ready PropagateBackend.
                 One backend is built per named view; tile plans build
                 their per-semiring tables at construction.
    blocks     : prebuilt tile table(s) for the default view — one
                 ``BlockSparse`` or a ``{sr.name: BlockSparse}`` dict
                 (``cuda`` packs each once, at construction).
    aux_graphs : named alternate views, e.g. {"rev": g.reverse()}; values
                 may be a Graph or (Graph, blocks).
    steps_per_round : k supersteps per round, one sync per round.
    gate       : sparsity gating on the tile plans (False: dense baseline).
    scheduler, result_cache, max_retries : passed to the SlotRuntime.
    device     : where the slot table and graph live; ``cuda`` unless the
                 caller passes another device.  Raises without a GPU.

    The JAX engine's ``legacy``, ``mesh``, ``preemptive``, ``journal``,
    ``arg_carried``, ``warmup``, ``index_fn``, ``gather_edges``,
    ``track_frontier`` and ``propagate_override`` options raise
    ``NotImplementedError`` naming the ROADMAP.md item that ports them.
    """

    def __init__(
        self,
        graph: Graph,
        program: VertexProgram,
        capacity: int = 8,
        *,
        index: Any = None,
        backend: Any = "coo",
        blocks: Optional[Any] = None,
        aux_graphs: Optional[dict] = None,
        block: int = 128,
        example_query: Any = None,
        steps_per_round: int = 1,
        gate: bool = True,
        scheduler: Any = "fifo",
        result_cache: Optional[int] = None,
        max_retries: int = 2,
        device=None,
        **later,
    ):
        for name, val in later.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"QuegelEngine got an unexpected argument {name!r}")
            if val:
                raise NotImplementedError(
                    f"{name}= is not ported yet: ROADMAP.md {_NOT_PORTED[name]}")
        if example_query is None:
            raise ValueError("example_query required to shape the slot table")
        self.device = resolve_device(device)
        self.graph = graph = graph.to(self.device)
        self.index = index if index is None else index.to(self.device)
        self.program = program
        self.capacity = int(capacity)
        self.steps_per_round = int(steps_per_round)
        if self.steps_per_round < 1:
            raise ValueError("steps_per_round must be >= 1")

        views = {"default": (graph, blocks)}
        for name, val in (aux_graphs or {}).items():
            g_, b_ = val if isinstance(val, tuple) else (val, None)
            views[name] = (g_.to(self.device), b_)
        self.aux_graphs = {k: v[0] for k, v in views.items() if k != "default"}
        if isinstance(backend, ops.PropagateBackend) and self.aux_graphs:
            # a ready instance owns ONE view's graph; reusing it for aux
            # views would propagate them over the wrong adjacency
            raise ValueError(
                f"backend instance cannot serve auxiliary views "
                f"{sorted(self.aux_graphs)}: pass a spec string"
            )
        self._backends = {
            name: ops.make_backend(backend, g_, blocks=b_, block=block, gate=gate)
            for name, (g_, b_) in views.items()
        }
        self.runtime = SlotRuntime(
            self, self.capacity, scheduler=scheduler, stats=EngineStats(),
            cache_size=result_cache, max_retries=max_retries,
        )
        self._build(example_query)

    @property
    def stats(self) -> EngineStats:
        return self.runtime.stats

    @property
    def status(self) -> dict:
        """qid -> DONE | TIMEOUT | REJECTED (see core/runtime.py)."""
        return self.runtime.status

    @property
    def _results(self) -> dict:
        return self.runtime.results

    # ------------------------------------------------------------ plumbing
    def _to_device(self, tree):
        return tree_map(lambda a: torch.as_tensor(np.asarray(a), device=self.device), tree)

    def _build(self, example_query) -> None:
        """The slot table (zeros, preallocated once) and the table warm-up:
        one superstep over the zero table with a shape-preserving recording
        propagate learns every (view, semiring) the program propagates, so
        tile plans build their tables here and never inside a round."""
        C = self.capacity
        proto_q = tree_map(lambda a: np.asarray(a), example_query)
        self._proto_q_np = proto_q
        q0 = self._to_device(tree_map(lambda a: np.stack([a] * C), proto_q))
        st0 = self.program.init(self.graph, q0, self.index)
        self._slots = dict(
            state=tree_map(torch.zeros_like, st0),
            query=tree_map(torch.zeros_like, q0),
            step=torch.zeros((C,), dtype=torch.int32, device=self.device),
            live=torch.zeros((C,), dtype=torch.bool, device=self.device),
            done=torch.zeros((C,), dtype=torch.bool, device=self.device),
        )
        seen = []

        def recording(sr, x, frontier=None, which="default"):
            seen.append((which, sr))
            return x

        ctx = StepCtx(self.graph, self._slots["query"], self._slots["step"] + 1,
                      recording, self.index)
        self.program.superstep(self._slots["state"], ctx)
        for which, sr in seen:
            warm = getattr(self._backends[which], "table_for", None)
            if warm is not None:
                warm(sr)

    def _propagate_for(self, adv: torch.Tensor) -> Callable:
        """The round's propagate: a non-advancing slot's frontier is masked
        off, so its stale lanes light no tiles (its output is discarded)."""
        backends = self._backends

        def propagate(sr: Semiring, x, frontier=None, which: str = "default"):
            if frontier is not None:
                frontier = frontier & _expand_as(adv, frontier)
            return backends[which].propagate(sr, x, frontier)

        return propagate

    def _admit(self, admitted: dict) -> None:
        """Batched admission: ``init`` over the admitted rows only, written
        into the slot tensors in place."""
        for q in admitted.values():
            if isinstance(q, ResumeAdmission):
                raise NotImplementedError(
                    "resume admission is not ported yet (ROADMAP.md §1 item 7)")
        rows = sorted(admitted)
        S = self._slots
        queries = self._to_device(
            tree_map(lambda *xs: np.stack(xs), *[admitted[r] for r in rows]))
        st = self.program.init(self.graph, queries, self.index)
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        tree_map(lambda tab, v: tab.index_copy_(0, idx, v.to(tab.dtype)),
                 S["state"], st)
        tree_map(lambda tab, v: tab.index_copy_(0, idx, v.to(tab.dtype)),
                 S["query"], queries)
        S["step"].index_fill_(0, idx, 0)
        S["live"].index_fill_(0, idx, True)
        S["done"].index_fill_(0, idx, False)

    def _superstep(self) -> None:
        """ONE superstep for every live slot.  ``done`` accumulates over the
        round (a slot finishing at superstep j of k still reads True at the
        round's readback)."""
        S = self._slots
        adv = S["live"].clone()
        ctx = StepCtx(self.graph, S["query"], S["step"] + 1,
                      self._propagate_for(adv), self.index)
        new_state, done = self.program.superstep(S["state"], ctx)
        tree_map(lambda tab, v: tab.copy_(torch.where(_expand_as(adv, tab), v, tab)),
                 S["state"], new_state)
        done = done & adv
        S["step"].add_(adv.to(torch.int32))
        S["live"].logical_and_(~done)
        S["done"].logical_or_(done)

    # ------------------------------------------- SlotProgram (device side)
    def slot_round(self, admitted: dict[int, Any]) -> RoundOutcome:
        """One super-round: batched admission, k masked supersteps, and the
        done/step readback — THE barrier, one device->host sync."""
        if admitted:
            self._admit(admitted)
        self._slots["done"].zero_()
        for _ in range(self.steps_per_round):
            self._superstep()
        S = self._slots
        out = torch.stack([S["done"].to(torch.int32), S["step"]]).cpu().numpy()
        return RoundOutcome(done=out[0].astype(bool), steps=out[1])

    def slot_collect(self, slots: list[int]) -> list[Any]:
        """Results for retiring slots: one batched extract, copied to the
        host, rows sliced host-side (results are small Q-data)."""
        S = self._slots
        all_res = tree_map(to_numpy, self.program.extract(S["state"], S["query"]))
        return [tree_map(lambda tab: tab[int(s)], all_res) for s in slots]

    def slot_evict(self, slots: list[int]) -> None:
        """Budget-exhausted queries (TIMEOUT): clear device liveness."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        self._slots["live"].index_fill_(0, idx, False)

    def cache_key(self, query) -> str:
        """Cache keys are prefixed by the graph's content hash."""
        return self.graph.content_hash() + ":" + default_cache_key(query)

    def export_tables(self) -> dict:
        """Prebuilt per-semiring tile tables by view name (empty for coo)."""
        out = {}
        for name, be in self._backends.items():
            t = be.export_tables()
            if t is not None:
                out[name] = t
        return out

    def table_bytes(self) -> int:
        """Device bytes held by every view's tile tables (dense for
        ``blocks_ref``, packed for ``cuda``), each table counted once."""
        tables = {}
        for t in self.export_tables().values():
            for bs in (t.values() if isinstance(t, dict) else [t]):
                tables[id(bs)] = bs
        return sum(bs.nbytes for bs in tables.values())

    # -------------------------------------------------------------- client
    def submit(self, query, *, qid: Optional[int] = None, priority: int = 0,
               deadline: float = math.inf, budget: int = 0) -> int:
        """Queue a query; its content is staged host-side (numpy) so batched
        admission stacks it without device round-trips."""
        return self.runtime.submit(
            tree_map(to_numpy, query),
            qid=qid, priority=priority, deadline=deadline, budget=budget,
        )

    def run_round(self) -> list[tuple[int, Any]]:
        """One super-round; returns [(qid, result)] for queries that
        COMPLETED this round (TIMEOUTs land only in ``_results``)."""
        return [
            (qid, res)
            for qid, res, status in self.runtime.run_round() or []
            if status == DONE
        ]

    def run_until_drained(self, max_rounds: int = 100_000) -> dict[int, Any]:
        """Batch-querying mode (paper scenario ii)."""
        return self.runtime.run_until_drained(max_rounds)

    def pump(self) -> list[tuple[int, Any, str]]:
        """Open-loop mode: advance at most one round and return every
        terminal transition since the last pump."""
        return self.runtime.pump()

    def poll(self, qid: int) -> Optional[tuple[str, Any]]:
        return self.runtime.poll(qid)

    def pending(self) -> int:
        return self.runtime.pending()

    def inflight(self) -> int:
        return self.runtime.inflight()

    def query(self, q, max_rounds: int = 100_000, **submit_kw):
        """Interactive mode (paper scenario i): submit and wait."""
        qid = self.submit(q, **submit_kw)
        rounds = 0
        while qid not in self._results and rounds < max_rounds:
            self.runtime.run_round()
            rounds += 1
        if qid not in self._results:
            raise QueryTimeoutError(
                f"query {qid} still unfinished after {max_rounds} "
                f"super-rounds (capacity={self.capacity}, "
                f"steps_per_round={self.steps_per_round})"
            )
        return self._results[qid]
