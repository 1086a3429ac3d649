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

The three are spanned while a profiler records (``quegel.admit``, one
``quegel.step`` per superstep, ``quegel.sync``; ``core/spans.py``).

``legacy=True`` keeps the pre-overhaul round as the A/B baseline: a
device->host read of the liveness before admission, one ``init`` and
row copy per admitted query, a second liveness read after admission,
and one extract and host copy per retiring slot.  Its answers and
counters equal the fused round's.

The slot lifecycle (queue, admission, liveness mirror, retirement, stats,
drain, preemption, journal and snapshots) lives in
``core/runtime.py::SlotRuntime``; the engine is its device-side
``SlotProgram``, and suspends a slot by copying its state row to the host
(``slot_suspend``) and restores it in the batched admission of a later
round.  Propagation is
pluggable: one ``kernels/ops.py::PropagateBackend`` per named view
('default', 'rev', ...).

Mutable graphs: ``apply_delta`` installs a new *edition* (graph version,
its views, refreshed backends and maintained index) between rounds.  Each
slot is pinned to the version it was admitted under and advances through
that edition's backends, so in-flight queries answer on their own
version; editions no slot, suspended payload or the current version
needs are pruned.  The port compiles nothing, so where the JAX engine
counts recompiles this one counts editions whose arrays changed shape
(``EngineStats.shape_changes``); ``arg_carried=True`` pads every view to
fixed capacities so that an in-capacity delta changes values only (off
by default: nothing in eager torch reads shape stability yet), and
``warmup`` moves a new edition's first-use work (device copies, work
items, index arrays) onto a background thread.

Mesh mode (``mesh=``, a ``torch.distributed`` ``DeviceMesh``): every
slot-table leaf whose trailing dim is |V| (ndim >= 2) lives V-sharded
between rounds, each rank holding its block of the mesh axis; Q-data
(``step``, ``live``, ``done``, ``query``) is replicated.  A round
all-gathers the V-sharded leaves at entry (one collective), runs
admission and the k supersteps on full values, propagating through each
edition's ``ShardedBackend`` (``core/distributed.py``: each rank combines
over its edge partition, one collective per propagate call), slices this
rank's V-shard back out, and does the one done/step readback.  Results
are the single-device engine's.

The JAX engine has one controller; torch.distributed has one per rank.
So every rank builds the same engine and submits the same queries, and
every host decision (scheduler order, result cache, admission,
retirement, preemption, snapshots) comes out the same on every rank,
because each follows from the submits and the replicated done/step
readback.  Results are returned on every rank.  Only rank 0 writes a
journal, a store or a result file (``launch/supervise.py`` gives the
other ranks a journal that records nothing).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distributed import all_gather_vertex, mesh_axis_info, mesh_device
from repro_torch.core.graph import EdgeDelta, Graph, grow_capacity
from repro_torch.core.runtime import (
    DONE, QueryTimeoutError, ResumeAdmission, RoundOutcome, SlotProgram,
    SlotRuntime, SlotStats, default_cache_key, to_numpy, tree_leaves, tree_map)
from repro_torch.core.semiring import BY_NAME, Semiring
from repro_torch.core.spans import span
from repro_torch.kernels import ops


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
    ``frontier_of(state)``          -> optional pytree of (C, ...) bool masks:
                                       the vertices each slot activates next
                                       superstep; the engine counts them per
                                       round with ``track_frontier=True``.
    """

    def init(self, graph: Graph, query, index=None):
        raise NotImplementedError

    def superstep(self, state, ctx: StepCtx):
        raise NotImplementedError

    def extract(self, state, query):
        raise NotImplementedError

    def frontier_of(self, state):
        return None


@dataclasses.dataclass
class EngineStats(SlotStats):
    """Shared lifecycle counters under the engine's names: ``super_rounds``
    and ``barriers`` both read the runtime's round counter."""

    # per-round active frontier vertex count, only when track_frontier=True
    # (one extra readback per round: diagnostics, not the hot path)
    frontier_active: list = dataclasses.field(default_factory=list)
    # editions (after the first) whose propagated arrays took shapes no
    # earlier edition had: in the JAX engine, each is a recompile; in
    # arg-carried mode an in-capacity mutation must leave this at 0
    shape_changes: int = 0
    # background edition warm-ups started (warmup=True)
    warmups: int = 0

    @property
    def super_rounds(self) -> int:
        return self.rounds

    @property
    def barriers(self) -> int:
        return self.rounds


@dataclasses.dataclass
class _Edition:
    """One graph version: the exact graph, its views, index and backends
    (what the next mutation refreshes from), and what its slots' rounds
    run on — the same backends, or in arg-carried mode their copies over
    capacity-padded arrays (``run``, ``run_graph``; None until the
    edition is finished, see ``QuegelEngine._finish``)."""

    version: int
    graph: Graph
    index: Any
    aux: dict                 # view name -> Graph (non-default views)
    backends: dict            # view name -> PropagateBackend
    run: Optional[dict] = None
    run_graph: Optional[Graph] = None


def _signature(run: dict, graph: Graph) -> tuple:
    """The shapes of every array an edition's rounds read: its graph's and
    those its backends propagate over."""
    shapes = lambda arrays: tuple(tuple(a.shape) for a in arrays if a is not None)
    views = tuple(sorted((name, shapes(be.arrays())) for name, be in run.items()))
    return shapes(getattr(graph, f.name) for f in dataclasses.fields(graph)
                  if isinstance(getattr(graph, f.name), torch.Tensor)), views


def _expand_as(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable against a (C, ...) leaf."""
    return mask.view(mask.shape + (1,) * (x.dim() - 1))


class QuegelEngine(SlotProgram):
    """Superstep-sharing scheduler (paper §3).

    capacity   : the paper's C — max queries in flight per super-round.
    backend    : 'coo', 'coo_gated', 'blocks_ref', 'cuda', or a ready
                 PropagateBackend.  One backend is built per named view;
                 tile plans build their per-semiring tables at
                 construction.
    blocks     : prebuilt tile table(s) for the default view — one
                 ``BlockSparse`` or a ``{sr.name: BlockSparse}`` dict
                 (``cuda`` packs each once, at construction).
    aux_graphs : named alternate views, e.g. {"rev": g.reverse()}; values
                 may be a Graph or (Graph, blocks).
    steps_per_round : k supersteps per round, one sync per round.
    gate       : sparsity gating on the tile plans (False: dense baseline).
    gather_edges : (coo) frontier-carrying propagation reduces over chunks
                 of this many ACTIVE edges instead of all E, at one extra
                 device->host sync per propagate.
    track_frontier : after each round, append the live slots' active-vertex
                 count (summed over ``program.frontier_of``) to
                 ``EngineStats.frontier_active`` (one extra readback).
    propagate_override : {view: callable (sr, x, frontier) -> y}, each
                 wrapped in ``ops.CallableBackend`` in place of that view's
                 backend.
    scheduler, result_cache : passed to the SlotRuntime.
    preemptive : round-boundary preemption (the paper's console
                 *suspend*): a waiting query that beats the worst-ranked
                 running one by ``preempt_margin`` suspends it (state
                 copied to the host by ``slot_suspend``, slot freed, query
                 re-queued with its superstep accounting intact).  Needs a
                 key-ordered scheduler (priority/sjf/deadline); results
                 are identical to the non-preemptive run.
    preempt_margin : how far a waiting key must beat a running rank.
    journal, snapshot_every, straggler, max_retries : fault tolerance,
                 passed to the SlotRuntime — a ``QueryJournal`` of the
                 query lifecycle, its in-flight snapshot cadence, a
                 ``StragglerMonitor`` fed per-round wall time, and the
                 poison-quarantine retry bound.
    index_fn   : index maintainer for mutable graphs, ``fn(new_graph,
                 old_index, delta) -> (new_index, info)`` (e.g.
                 ``apps/hub2.py::hub_index_updater``); ``apply_delta`` on
                 an indexed engine needs one.
    arg_carried : shape-stable editions.  ``True``: each edition's rounds
                 run over its views capacity-padded (``Graph.
                 with_capacity``) and its tile tables padded to a slot and
                 entry capacity, so an in-capacity ``apply_delta`` changes
                 values, never shapes (``EngineStats.shape_changes`` stays
                 0; overflow grows the capacity once).  Needs carriable
                 backends (no ``propagate_override``, no one shared table).
                 ``'auto'`` (the default) is off: the JAX engine turns it
                 on from ``arg_carried_threshold`` edges to avoid
                 recompiles, but eager torch compiles nothing and captures
                 no CUDA graph, so nothing here reads shape stability yet
                 (``arg_carried_threshold`` is accepted for the JAX
                 signature and ignored).
    edge_capacity : the initial padded edge capacity per view (default:
                 ~25% headroom over |E|).
    warmup     : ``apply_delta`` returns after the host splices and a
                 background thread does the new edition's first-use work
                 (padding, device copies of the tables, the kernel's work
                 items, int64 COO indices) while older editions keep
                 serving; ``wait_warmup()`` joins it.
    legacy     : the pre-overhaul round, kept as the A/B baseline (module
                 docstring); single superstep rounds only, no
                 ``arg_carried=True``, no ``warmup``.
    donate, interpret : accepted for the JAX signature and ignored: eager
                 torch donates no buffers and has no interpret mode (the
                 ``cuda`` plan launches its kernel on a CUDA tensor and
                 runs its plain version on a CPU one).
    mesh       : a ``DeviceMesh`` (``launch/mesh.py``) — turns on mesh mode
                 (module docstring): V-sharded slot leaves over
                 ``mesh_axis`` (default: the mesh's last dim), edge
                 partitions per ``partition``.  Implies the ``sharded``
                 backend; |V| must be a multiple of the axis size
                 (``Graph.padded``); no ``legacy``, ``propagate_override``,
                 ``blocks`` or ``warmup``.
    partition  : 'dst' (all-gather of combined blocks) or 'src' (MIN/MAX/SUM
                 all-reduce of dense partials).
    device     : where the slot table and graph live; ``cuda`` unless the
                 caller passes another device (under ``mesh=``: the mesh's
                 device for this rank).  Raises without a GPU.
    """

    def __init__(
        self,
        graph: Graph,
        program: VertexProgram,
        capacity: int = 8,
        *,
        index: Any = None,
        index_fn: Optional[Callable] = None,
        backend: Any = "coo",
        blocks: Optional[Any] = None,
        aux_graphs: Optional[dict] = None,
        block: int = 128,
        example_query: Any = None,
        steps_per_round: int = 1,
        gate: bool = True,
        gather_edges: Optional[int] = None,
        track_frontier: bool = False,
        propagate_override: Optional[dict] = None,
        scheduler: Any = "fifo",
        result_cache: Optional[int] = None,
        preemptive: bool = False,
        preempt_margin: float = 0.0,
        journal: Any = None,
        snapshot_every: int = 0,
        straggler: Any = None,
        max_retries: int = 2,
        arg_carried: Any = "auto",
        arg_carried_threshold: int = 100_000,
        edge_capacity: Optional[int] = None,
        warmup: bool = False,
        legacy: bool = False,
        donate: Any = "auto",
        interpret: bool = True,
        mesh: Any = None,
        mesh_axis: Optional[str] = None,
        partition: str = "dst",
        device=None,
    ):
        del donate, interpret  # no buffer donation, no interpret mode in eager torch
        self.mesh = mesh
        self.partition = partition
        if mesh is not None:
            if not isinstance(backend, str) or backend not in ("coo", "sharded"):
                raise ValueError(
                    f"mesh= implies the sharded backend; got backend={backend!r}")
            backend = "sharded"
            self._mesh_axis = mesh_axis or mesh.mesh_dim_names[-1]
            self._mesh_rank, self._n_parts, self._group = mesh_axis_info(
                mesh, self._mesh_axis)
            if legacy:
                raise ValueError("legacy mode is single-device only")
            if propagate_override:
                raise ValueError(
                    "propagate_override and mesh= are mutually exclusive: "
                    "override callables cannot run inside the SPMD round")
            if graph.n % self._n_parts:
                raise ValueError(
                    f"|V|={graph.n} must be a multiple of mesh axis "
                    f"'{self._mesh_axis}'={self._n_parts}: repad via "
                    f"Graph.padded({self._n_parts})")
            if device is None:
                device = mesh_device(mesh)
            elif torch.device(device).type != mesh.device_type:
                raise ValueError(f"device={device!r} is not on the mesh's "
                                 f"{mesh.device_type!r} devices")
        elif backend == "sharded":
            raise ValueError("backend='sharded' needs mesh=")
        if example_query is None:
            raise ValueError("example_query required to shape the slot table")
        self.device = resolve_device(device)
        self.graph = graph = graph.to(self.device)
        self.index = index if index is None else index.to(self.device)
        self.index_fn = index_fn
        self.program = program
        self.capacity = int(capacity)
        self.steps_per_round = int(steps_per_round)
        if self.steps_per_round < 1:
            raise ValueError("steps_per_round must be >= 1")
        self.legacy = bool(legacy)
        if self.legacy and self.steps_per_round != 1:
            raise ValueError("legacy mode predates multi-superstep rounds")

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
        for name, (g_, b_) in views.items():
            if mesh is not None and g_.n != graph.n:
                raise ValueError(
                    f"view '{name}' has |V|={g_.n} != {graph.n}: all views "
                    "must share one padded vertex space under mesh=")
            if mesh is not None and b_ is not None:
                raise ValueError(
                    f"blocks for view '{name}' have no effect under mesh=: "
                    "the sharded backend combines over edge partitions, not "
                    "tile tables")
        self._backends = {
            name: ops.make_backend(backend, g_, blocks=b_, block=block, gate=gate,
                                   gather_edges=gather_edges, mesh=mesh,
                                   mesh_axis=mesh_axis, partition=partition)
            for name, (g_, b_) in views.items()
        }
        self.propagate_override = dict(propagate_override or {})
        for name, fn in self.propagate_override.items():
            self._backends[name] = ops.CallableBackend(fn)
        # 'auto' is off: see arg_carried above.  Capacity padding needs
        # every view's CSR view (a graph built by hand without it, as
        # keyword search's weighted 'rev', is not carriable)
        self._arg_carried = bool(arg_carried) and arg_carried != "auto"
        if self._arg_carried:
            carriable = not self.legacy and all(not isinstance(be, ops.CallableBackend)
                            and getattr(be, "_shared", None) is None
                            for be in self._backends.values()) and all(
                g_.csr_row is not None for g_, _ in views.values())
            if not carriable:
                raise ValueError(
                    "arg_carried=True needs carriable backends: legacy=False, no "
                    "propagate_override, no shared single-table blocks= "
                    "(pass a {sr.name: table} dict instead), and views "
                    "with the CSR view (built by Graph.from_edges)")
        self._edge_capacity = None if edge_capacity is None else int(edge_capacity)
        self.warmup = bool(warmup)
        if self.warmup and self.legacy:
            raise ValueError(
                "warmup=True needs the fused round (legacy admission "
                "dispatches per query)")
        if self.warmup and mesh is not None:
            raise ValueError(
                "warmup=True is a single-device knob; mesh mode absorbs "
                "mutations via arg_carried=True instead")
        self._view_caps: dict = {}
        self._slot_caps: dict = {}
        self._entry_caps: dict = {}
        self.shape_counts: dict[int, int] = {}
        self._seen_shapes: set = set()
        self._finish_lock = threading.Lock()
        self._warm_threads: list = []
        self.track_frontier = bool(track_frontier)
        self.runtime = SlotRuntime(
            self, self.capacity, scheduler=scheduler, stats=EngineStats(),
            cache_size=result_cache, preemptive=preemptive,
            preempt_margin=preempt_margin, journal=journal,
            snapshot_every=snapshot_every, straggler=straggler,
            max_retries=max_retries,
        )
        self._build(example_query)
        # graph versioning: _slot_version pins each slot to the version it
        # was admitted under; _resume_refs pins editions that only
        # suspended (off-device) payloads still reference
        self._editions: dict[int, _Edition] = {}
        self._resume_refs: dict[int, int] = {}
        self._slot_version = np.full((self.capacity,), int(graph.version), dtype=np.int64)
        ed = _Edition(int(graph.version), graph, self.index, dict(self.aux_graphs),
                      dict(self._backends))
        self._finish(ed)
        self._editions[ed.version] = ed
        self._current_version = ed.version

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
        tile plans build their tables here and never inside a round (a
        refreshed plan carries every table it had)."""
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
            seen.append((which, sr, math.prod(x.shape) * x.element_size()))
            return x

        ctx = StepCtx(self.graph, self._slots["query"], self._slots["step"] + 1,
                      recording, self.index)
        self.program.superstep(self._slots["state"], ctx)
        for which, sr, _ in seen:
            warm = getattr(self._backends[which], "table_for", None)
            if warm is not None:
                warm(sr)
        self._collective_model = None
        if self.mesh is not None:
            n = self.graph.n
            self._vq = tree_map(lambda t: t.dim() >= 2 and t.shape[-1] == n, self._slots)
            vq = []
            tree_map(lambda t, m: vq.append(t) if m else None, self._slots, self._vq)
            # payloads of the collectives, from this pass: one (C, ..., V)
            # slab per propagate call per superstep, and the V-sharded
            # leaves gathered at round entry
            self._collective_model = dict(
                propagate_calls_per_superstep=len(seen),
                propagate_payload_bytes_per_superstep=sum(b for _, _, b in seen),
                state_gather_payload_bytes=sum(t.numel() * t.element_size() for t in vq))
            self._slots = self._shard(self._slots, self._vq)

    # ----------------------------------------------------------------- mesh
    def _gather(self, tree, mask):
        """``tree`` with its V-sharded leaves (``mask``) all-gathered to
        full |V|, in one collective."""
        leaves = []
        tree_map(lambda t, m: leaves.append(t) if m else None, tree, mask)
        if not leaves:
            return tree
        full = iter(all_gather_vertex(leaves, self._group, self._n_parts))
        return tree_map(lambda t, m: next(full) if m else t, tree, mask)

    def _shard(self, tree, mask):
        """``tree`` with this rank's V-shard of each leaf of ``mask``."""
        b = self.graph.n // self._n_parts
        lo = self._mesh_rank * b
        return tree_map(lambda t, m: t[..., lo:lo + b].contiguous() if m else t,
                        tree, mask)

    def _rows(self, keys: tuple, slots=None) -> dict:
        """The slot table's ``keys`` (only the rows ``slots``, if given) at
        full |V|: under a mesh, gathered by every rank."""
        part = {k: self._slots[k] for k in keys}
        if slots is not None:
            idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
            part = tree_map(lambda tab: tab.index_select(0, idx), part)
        if self.mesh is None:
            return part
        return self._gather(part, {k: self._vq[k] for k in keys})

    def collective_bytes_per_round(self, n_parts: Optional[int] = None) -> Optional[dict]:
        """Modeled per-rank wire bytes for one mesh round; None outside
        mesh mode.

        dst partition all-gathers each propagate's combined (C, V) payload
        (ring wire cost ≈ payload · (w-1)/w per rank); src all-reduces
        the dense partial (≈ 2× that for a ring).  Round entry additionally
        all-gathers the V-sharded slot leaves.  The JAX engine's model,
        key for key.  ``n_parts`` models another axis size w for the same
        program and capacity (the payloads do not depend on w).
        """
        if self._collective_model is None:
            return None
        m = self._collective_model
        w = self._n_parts if n_parts is None else int(n_parts)
        f = (w - 1) / w if w > 1 else 0.0
        prop_factor = f if self.partition == "dst" else 2.0 * f
        per_step = m["propagate_payload_bytes_per_superstep"] * prop_factor
        state = m["state_gather_payload_bytes"] * f
        return dict(
            n_parts=w,
            partition=self.partition,
            propagate_calls_per_superstep=m["propagate_calls_per_superstep"],
            state_gather_bytes=state,
            propagate_bytes_per_superstep=per_step,
            round_total_bytes=state + self.steps_per_round * per_step,
        )

    # ------------------------------------------------------------ editions
    def _finish(self, ed: _Edition) -> dict:
        """Make ``ed`` ready to run, once: in arg-carried mode its backends'
        copies over padded arrays (``_carry``), then every run backend's
        first-use work (``warm``), and the shape accounting.  Locked, so a
        warm-up thread and a round never both do it."""
        with self._finish_lock:
            if ed.run is not None:
                return ed.run
            if self._arg_carried:
                run, run_graph = self._carry(ed)
            else:
                run, run_graph = dict(ed.backends), ed.graph
            for be in run.values():
                be.warm()
            sig = _signature(run, run_graph)
            if sig not in self._seen_shapes:
                if self._seen_shapes:
                    self.stats.shape_changes += 1
                self._seen_shapes.add(sig)
                self.shape_counts[ed.version] = self.shape_counts.get(ed.version, 0) + 1
            ed.run, ed.run_graph = run, run_graph
            return run

    def _carry(self, ed: _Edition):
        """The edition's backends rebound to capacity-padded arrays: per
        view, the graph padded to the view's edge capacity and stripped of
        lineage, tile tables padded to the view's slot and entry
        capacities.  Capacities only grow: an overflowing edition raises
        its view's capacity (new shapes, counted once) and later
        in-capacity editions keep it."""
        graphs = {"default": ed.graph, **ed.aux}
        run, run_graph = {}, None
        for name, be in ed.backends.items():
            g_v = graphs[name]
            cap = self._view_caps.get(name)
            if cap is None:
                # an explicit edge_capacity= is taken at face value (tests
                # use it to provoke overflow)
                cap = max(self._edge_capacity if self._edge_capacity is not None
                          else grow_capacity(g_v.num_edges), g_v.num_edges)
            elif g_v.num_edges > cap:
                cap = grow_capacity(g_v.num_edges)
            self._view_caps[name] = cap
            gcar = g_v.with_capacity(max_e=cap).carrier()
            scap = ecap = None
            if isinstance(be, ops._TileBackend):
                tabs = [be.table_for(BY_NAME[name]) for name in list(be.tables)]
                need = max((t.max_bpr for t in tabs), default=1)
                scap = self._slot_caps.get(name)
                if scap is None or need > scap:
                    scap = self._slot_caps[name] = need + 2
                if isinstance(be, ops.CudaBackend):
                    need_e = max((t.entries.numel() for t in tabs), default=0)
                    ecap = self._entry_caps.get(name)
                    if ecap is None or need_e > ecap:
                        ecap = self._entry_caps[name] = grow_capacity(need_e)
            run[name] = be.from_args(be.as_args(gcar, slot_cap=scap, entry_cap=ecap))
            if name == "default":
                run_graph = gcar
        return run, run_graph

    def _spawn_warmup(self, ed: _Edition) -> None:
        """Finish a new edition on a daemon thread while older editions
        keep serving; a round that needs it first waits on the lock.  A
        failure there is left for that round to raise again."""
        self.stats.warmups += 1

        def work():
            try:
                self._finish(ed)
            except Exception:  # noqa: BLE001 - re-raised by the round's _finish
                pass

        t = threading.Thread(target=work, name=f"edition-warmup-v{ed.version}",
                             daemon=True)
        self._warm_threads.append(t)
        t.start()

    def wait_warmup(self, timeout: Optional[float] = None) -> bool:
        """Join outstanding warm-up threads; True when none is running."""
        for t in list(self._warm_threads):
            t.join(timeout)
        self._warm_threads = [t for t in self._warm_threads if t.is_alive()]
        return not self._warm_threads

    # --------------------------------------------------------------- rounds
    @staticmethod
    def _propagate_for(adv: torch.Tensor, backends: dict) -> Callable:
        """The round's propagate: a non-advancing slot's frontier is masked
        off, so its stale lanes light no tiles (its output is discarded)."""

        def propagate(sr: Semiring, x, frontier=None, which: str = "default"):
            if frontier is not None:
                frontier = frontier & _expand_as(adv, frontier)
            return backends[which].propagate(sr, x, frontier)

        return propagate

    def _admit(self, admitted: dict) -> None:
        """Batched admission of fresh and resumed queries in one go: fresh
        rows run ``init`` (over those rows only, on the current version),
        resumed rows take the state a ``slot_suspend`` copied to the host
        and their superstep count; both are written into the slot tensors
        in place."""
        S = self._slots
        fresh = sorted(s for s, q in admitted.items()
                       if not isinstance(q, ResumeAdmission))
        resumed = sorted(s for s, q in admitted.items()
                         if isinstance(q, ResumeAdmission))
        put = lambda idx, tree, new: tree_map(
            lambda tab, v: tab.index_copy_(0, idx, v.to(tab.dtype)), tree, new)
        stack = lambda rows: tree_map(lambda *xs: np.stack(xs), *rows)
        if fresh:
            idx = torch.as_tensor(fresh, dtype=torch.long, device=self.device)
            queries = self._to_device(stack([admitted[r] for r in fresh]))
            put(idx, S["state"], self.program.init(self.graph, queries, self.index))
            put(idx, S["query"], queries)
            S["step"].index_fill_(0, idx, 0)
        if resumed:
            idx = torch.as_tensor(resumed, dtype=torch.long, device=self.device)
            adm = [admitted[r] for r in resumed]
            put(idx, S["state"], self._to_device(
                stack([self._resume_state(a.payload)[1] for a in adm])))
            put(idx, S["query"], self._to_device(stack([a.query for a in adm])))
            S["step"].index_copy_(0, idx, torch.as_tensor(
                [a.steps for a in adm], dtype=torch.int32, device=self.device))
        idx = torch.as_tensor(fresh + resumed, dtype=torch.long, device=self.device)
        S["live"].index_fill_(0, idx, True)
        S["done"].index_fill_(0, idx, False)

    def _resume_state(self, payload):
        """(version, state rows) of a ``slot_suspend`` payload, the JAX
        engine's ``{"v": version, "state": ...}``; a payload without a
        version (an external caller's state) resumes on the current one."""
        if isinstance(payload, dict) and "v" in payload and "state" in payload:
            return int(payload["v"]), payload["state"]
        return self._current_version, payload

    def _superstep(self, adv: torch.Tensor, ed: _Edition) -> None:
        """ONE superstep for the slots of ``adv`` on edition ``ed``.
        ``done`` accumulates over the round (a slot finishing at superstep
        j of k still reads True at the round's readback)."""
        with span("quegel.step"):
            S = self._slots
            ctx = StepCtx(ed.run_graph, S["query"], S["step"] + 1,
                          self._propagate_for(adv, ed.run), ed.index)
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
        done/step readback — THE barrier, one device->host sync.

        Fresh admissions pin their slot to the current version, resumed
        ones to the version in their payload.  The slots of each version
        present advance through that version's edition (normally there is
        one, and its mask is the live mask itself)."""
        cur = self._current_version
        for slot, q in admitted.items():
            v = self._resume_state(q.payload)[0] if isinstance(q, ResumeAdmission) else cur
            if v not in self._editions:
                raise RuntimeError(
                    f"cannot resume query pinned to graph version {v}: edition "
                    "was pruned (resume payloads must keep their version "
                    "referenced via slot_register_resume)")
            if isinstance(q, ResumeAdmission):
                self._release_resume_ref(v)
            self._slot_version[slot] = v
        if self.mesh is not None:
            self._slots = self._gather(self._slots, self._vq)
        S = self._slots
        if self.legacy:
            # the two liveness reads the fused round removed: before
            # admission (free-slot discovery) and after it (any live?)
            with span("quegel.admit"):
                to_numpy(S["live"])
                for slot in admitted:
                    self._admit({slot: admitted[slot]})
                bool(S["live"].any())
        elif admitted:
            with span("quegel.admit"):
                self._admit(admitted)
        live = np.asarray(self.runtime.live, dtype=bool)
        versions = sorted({int(self._slot_version[s]) for s in np.flatnonzero(live)}) or [cur]
        groups = []
        for v in versions:
            ed = self._editions[v]
            self._finish(ed)
            mask = None if len(versions) == 1 else torch.as_tensor(
                (self._slot_version == v) & live, device=self.device)
            groups.append((mask, ed))
        S["done"].zero_()
        for _ in range(self.steps_per_round):
            for mask, ed in groups:
                adv = S["live"].clone() if mask is None else S["live"] & mask
                self._superstep(adv, ed)
        with span("quegel.sync"):
            out = torch.stack([S["done"].to(torch.int32), S["step"]]).cpu().numpy()
        if self.mesh is not None:
            self._slots = self._shard(S, self._vq)
        return RoundOutcome(done=out[0].astype(bool), steps=out[1])

    def slot_collect(self, slots: list[int]) -> list[Any]:
        """Results for retiring slots: one batched extract, copied to the
        host, rows sliced host-side (results are small Q-data); legacy
        extracts and copies each slot on its own."""
        S = self._slots
        if self.legacy:
            row = lambda s: lambda tab: tab[int(s):int(s) + 1]
            return [tree_map(lambda tab: to_numpy(tab)[0], self.program.extract(
                tree_map(row(s), S["state"]), tree_map(row(s), S["query"])))
                for s in slots]
        if self.mesh is not None:
            # full rows of the retiring slots, gathered by every rank
            rows = self._rows(("state", "query"), slots)
            res = tree_map(to_numpy, self.program.extract(rows["state"], rows["query"]))
            return [tree_map(lambda tab: tab[i], res) for i in range(len(slots))]
        all_res = tree_map(to_numpy, self.program.extract(S["state"], S["query"]))
        return [tree_map(lambda tab: tab[int(s)], all_res) for s in slots]

    def slot_evict(self, slots: list[int]) -> None:
        """Budget-exhausted queries (TIMEOUT): clear device liveness."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=self.device)
        self._slots["live"].index_fill_(0, idx, False)

    def slot_suspend(self, slots: list[int]) -> list[Any]:
        """Preemption and snapshots: gather the victims' state rows on the
        device, copy them to the host in one transfer (the rows of every
        leaf as bytes, side by side), and clear their liveness.  Each
        payload is ``{"v": version, "state": {leaf: numpy row}}`` with the
        leaf names of ``program.init`` — the JAX engine's payload — and
        owns its rows (a fresh host copy: the slot tensors are updated in
        place).  The version's resume reference keeps its edition from
        being pruned while the payload is off the device."""
        rows = [int(s) for s in slots]
        got = []
        tree_map(got.append, self._rows(("state",), rows)["state"])
        # one device->host copy: every leaf's rows as bytes, side by side
        host = to_numpy(torch.cat(
            [g.reshape(len(rows), -1).view(torch.uint8) for g in got], 1))
        spans, end = [], 0
        for g in got:
            start, end = end, end + g[0].numel() * g.element_size()
            spans.append((start, end, torch.empty(0, dtype=g.dtype).numpy().dtype,
                          tuple(g.shape[1:])))
        self.slot_evict(rows)

        def row(i):
            it = iter(spans)

            def leaf(_):
                a, b, dtype, shape = next(it)
                return host[i, a:b].view(dtype).reshape(shape).copy()

            return tree_map(leaf, self._slots["state"])

        payloads = []
        for i, s in enumerate(rows):
            v = int(self._slot_version[s])
            self._resume_refs[v] = self._resume_refs.get(v, 0) + 1
            payloads.append({"v": v, "state": row(i)})
        return payloads

    def slot_register_resume(self, payload) -> None:
        """A journal-replayed suspend payload re-entered the queue: re-pin
        its graph edition so that pruning cannot drop it before the resume
        round."""
        if isinstance(payload, dict) and "v" in payload:
            v = int(payload["v"])
            if v not in self._editions:
                raise RuntimeError(
                    f"resume payload references graph version {v} but no such "
                    "edition exists — replay the journal's mutation records "
                    "(apply_delta_record) before restore_pending")
            self._resume_refs[v] = self._resume_refs.get(v, 0) + 1

    def _release_resume_ref(self, v: int) -> None:
        c = self._resume_refs.get(v, 0)
        if c <= 1:
            self._resume_refs.pop(v, None)
        else:
            self._resume_refs[v] = c - 1

    def slot_observe(self) -> None:
        """With ``track_frontier``: the live slots' active-vertex count,
        summed over every leaf of ``program.frontier_of``."""
        if not self.track_frontier:
            return
        S = self._slots
        front = self.program.frontier_of(self._rows(("state",))["state"])
        if front is None:
            return
        leaves = tree_leaves(front)
        per_slot = sum(leaf.reshape(self.capacity, -1).sum(-1) for leaf in leaves)
        self.stats.frontier_active.append(int(torch.where(S["live"], per_slot, 0).sum()))

    # ------------------------------------------------- version-keyed cache
    def cache_key(self, query) -> str:
        """Submit-time key: prefixed by the CURRENT version's content hash,
        so a lookup only hits results computed on the graph the submitter
        queries."""
        return self.graph.content_hash() + ":" + default_cache_key(query)

    def cache_key_for_slot(self, query, slot: int) -> str:
        """Retirement-time key: prefixed by the content hash of the edition
        the slot was pinned to (editions are pruned only between rounds)."""
        ed = self._editions.get(int(self._slot_version[int(slot)]))
        g = self.graph if ed is None else ed.graph
        return g.content_hash() + ":" + default_cache_key(query)

    # ------------------------------------------------------ graph mutation
    def apply_delta(self, adds=None, dels=None, *, w=None,
                    aux_deltas: Any = "reverse", index_fn=None,
                    prune: bool = True, _from_journal: bool = False) -> dict:
        """Mutate the graph between rounds: apply a batched edge delta, bump
        the version and install a new edition — views merged incrementally
        (``Graph.apply_delta`` and each backend's ``refresh``), the index
        maintained by ``index_fn``, the result cache invalidated down to
        the new version's entries.  In-flight queries keep answering on
        the version they were admitted under.

        adds/dels : ``(k, 2)`` (src, dst) pair arrays (or (src, dst)
                    tuples); ``adds`` may instead be a validated
                    ``EdgeDelta``.  ``w`` gives per-added-edge weights.
        aux_deltas: how auxiliary views follow the default view's delta —
                    ``"reverse"`` (every aux view is the edge-reversed
                    graph) maps it through ``EdgeDelta.reversed()``; or a
                    dict {view: EdgeDelta | (adds, dels) | None} (None:
                    the view, its backend and tables are reused).
        index_fn  : overrides the constructor's ``index_fn`` for this call.
        prune     : drop editions no live slot, suspended payload or the
                    current version references (False while replaying a
                    journal, whose later records may resume older
                    versions).

        Returns {version, parent_hash, content_hash, delta_size,
        cache_invalidated, editions, index, ms}: ``index`` is the
        maintainer's info (None when indexless), ``ms`` the wall time of
        each stage — host ``splice`` and ``upload`` of the graph views,
        ``tables`` (the backends' refresh), ``index``, ``hash`` (the new
        content hash), ``finish`` (padding, device copies and first-use
        work, 0 when a warm-up thread does it) and ``invalidate``.
        """
        if self.propagate_override:
            raise ValueError(
                "apply_delta cannot refresh propagate_override callables: "
                "override closures capture graph arrays the engine cannot "
                "see; rebuild the engine instead")
        cur = self._editions[self._current_version]
        if isinstance(adds, EdgeDelta):
            if dels is not None or w is not None:
                raise ValueError("pass either a prevalidated EdgeDelta or "
                                 "adds/dels/w arrays, not both")
            delta = adds
        else:
            delta = cur.graph.make_delta(adds, dels, w=w)
        fn = index_fn if index_fn is not None else self.index_fn
        if cur.index is not None and fn is None:
            raise ValueError(
                "engine carries an index but no index maintainer: pass "
                "index_fn= (e.g. apps/hub2.py::hub_index_updater(...)) at "
                "construction or to apply_delta")
        aux_delta = self._aux_deltas(cur, delta, aux_deltas)

        rt = self.runtime
        old_hash = cur.graph.content_hash()
        if rt.journal is not None and not _from_journal:
            # WAL in-flight state BEFORE the mutation record: each snapshot
            # payload pins its pre-mutation version, so recovery replays
            # submit -> snapshot -> mutation in order
            rt.snapshot()
        ms, tm = {}, {}
        clock = time.perf_counter
        new_graph = cur.graph.apply_delta(delta, timings=tm)
        new_aux = {}
        for name, g_old in cur.aux.items():
            d = aux_delta[name]
            new_aux[name] = g_old if d is None else g_old.apply_delta(d, timings=tm)
        ms["splice"] = 1e3 * tm.get("splice_s", 0.0)
        ms["upload"] = 1e3 * tm.get("upload_s", 0.0)

        t0 = clock()
        new_backends = {"default": cur.backends["default"].refresh(new_graph, delta)}
        for name in cur.aux:
            d = aux_delta[name]
            new_backends[name] = (cur.backends[name] if d is None
                                  else cur.backends[name].refresh(new_aux[name], d))
        ms["tables"] = 1e3 * (clock() - t0)

        t0 = clock()
        new_index, index_info = None, None
        if cur.index is not None:
            new_index, index_info = fn(new_graph, cur.index, delta)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        ms["index"] = 1e3 * (clock() - t0)

        t0 = clock()
        new_hash = new_graph.content_hash()
        ms["hash"] = 1e3 * (clock() - t0)
        if rt.journal is not None and not _from_journal:
            rt.journal.mutation(
                version=int(new_graph.version), parent_hash=old_hash,
                content_hash=new_hash,
                adds=np.stack([delta.add_src, delta.add_dst], axis=1),
                add_w=delta.add_w,
                dels=np.stack([delta.del_src, delta.del_dst], axis=1))

        # install the new edition; older ones stay until their readers go
        ed = _Edition(int(new_graph.version), new_graph, new_index, new_aux, new_backends)
        t0 = clock()
        if self.warmup:
            self._spawn_warmup(ed)
        else:
            self._finish(ed)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        ms["finish"] = 1e3 * (clock() - t0)
        self._editions[ed.version] = ed
        self._current_version = ed.version
        self.graph, self.index = new_graph, new_index
        self._backends = new_backends
        self.aux_graphs = dict(new_aux)

        # version-keyed invalidation: only entries whose prefix is the new
        # content hash stay servable (an old-version entry a later
        # retirement inserts is unreachable unless the content reverts, in
        # which case it is byte-identical)
        invalidated = 0
        t0 = clock()
        if rt.cache is not None:
            invalidated = rt.cache.invalidate_except(new_hash)
            rt.stats.cache_invalidations += invalidated
            rt.stats.cache_invalidation_ms += (clock() - t0) * 1e3
        ms["invalidate"] = 1e3 * (clock() - t0)
        if prune:
            self._prune_editions()
        return dict(version=ed.version, parent_hash=old_hash, content_hash=new_hash,
                    delta_size=delta.size, cache_invalidated=invalidated,
                    editions=sorted(self._editions), index=index_info, ms=ms)

    @staticmethod
    def _aux_deltas(cur: _Edition, delta: EdgeDelta, aux_deltas) -> dict:
        """Each auxiliary view's delta (None: the view is unaffected)."""
        if aux_deltas == "reverse":
            rev = delta.reversed()
            return {name: rev for name in cur.aux}
        if aux_deltas is None or isinstance(aux_deltas, dict):
            spec = dict(aux_deltas or {})
            unknown = set(spec) - set(cur.aux)
            if unknown:
                raise ValueError(f"aux_deltas names unknown views {sorted(unknown)}: "
                                 f"engine has {sorted(cur.aux)}")
            out = {}
            for name in cur.aux:
                d = spec.get(name)
                if d is not None and not isinstance(d, EdgeDelta):
                    d = cur.aux[name].make_delta(*d)
                out[name] = d
            return out
        raise ValueError("aux_deltas must be 'reverse', None, or a "
                         "{view: EdgeDelta | (adds, dels) | None} dict")

    def apply_delta_record(self, rec: dict) -> dict:
        """Replay one journaled ``mutation`` record (the recovery path,
        ``launch/supervise.py``).  The hash chain makes replay exact or
        refused: the record's ``parent_hash`` must be the engine's current
        content hash, and the replayed graph must hash to the recorded
        ``content_hash``."""
        cur_hash = self._editions[self._current_version].graph.content_hash()
        if rec["parent_hash"] != cur_hash:
            raise RuntimeError(
                "mutation chain mismatch: journal expects parent "
                f"{rec['parent_hash'][:12]}… but the engine's graph hashes "
                f"{cur_hash[:12]}… — booted from the wrong store snapshot "
                "for this journal?")
        adds = np.asarray(rec["adds"], np.int32).reshape(-1, 2)
        dels = np.asarray(rec["dels"], np.int32).reshape(-1, 2)
        info = self.apply_delta(
            adds if len(adds) else None, dels if len(dels) else None,
            w=np.asarray(rec["add_w"]) if len(adds) else None,
            prune=False, _from_journal=True)
        if info["content_hash"] != rec["content_hash"]:
            raise RuntimeError(
                "mutation replay diverged: journal recorded content "
                f"{rec['content_hash'][:12]}… but replay produced "
                f"{info['content_hash'][:12]}…")
        return info

    def _prune_editions(self) -> None:
        """Drop editions no reader can reach: not current, not pinned by a
        live slot, not referenced by a suspended payload.  Called only
        between rounds (from ``apply_delta``)."""
        live = np.asarray(self.runtime.live, dtype=bool)
        needed = {self._current_version}
        needed.update(int(self._slot_version[s]) for s in np.flatnonzero(live))
        needed.update(v for v, c in self._resume_refs.items() if c > 0)
        for v in [v for v in self._editions if v not in needed]:
            del self._editions[v]

    def export_tables(self) -> dict:
        """Prebuilt per-semiring tile tables by view name (empty for coo)."""
        out = {}
        for name, be in self._backends.items():
            t = be.export_tables()
            if t is not None:
                out[name] = t
        return out

    def poison_slot(self, slot: int, value: float = float("nan")) -> int:
        """Fault injection: overwrite one slot's row of every float state
        leaf with ``value`` in place, modeling in-flight memory corruption.
        Returns the number of leaves poisoned; raises if the state has no
        float leaves (int lanes saturate at the finite ``semiring.INF``
        sentinel and cannot encode a poison).  The runtime detects the
        non-finite result at extraction and quarantines the query."""
        floats = [t for t in tree_leaves(self._slots["state"])
                  if t.dtype.is_floating_point]
        if not floats:
            raise ValueError(
                "cannot poison slot state: no float leaves (int-state "
                "programs saturate at the finite INF sentinel)")
        for t in floats:
            t[int(slot)].fill_(value)
        return len(floats)

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
