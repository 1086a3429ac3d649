#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path, its other query classes, its
LM server, its LM trainer, its sharding layer and its report on one GPU
and hold its kernel against the plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing its own lines; any mismatch exits nonzero:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the hand-written kernel (csrc/frontier.cu) with nvcc, and print
     what ptxas reports (registers, shared memory, spills);
  2. the kernel against its plain version on packed tables of random
     graphs of 1,000 and 4,096 vertices, of a 1,000-vertex graph with
     duplicate edges and weights equal to add_id (which the packer must
     combine or drop) and of barabasi_albert(4096, 3), whose hub rows span
     several work items: five semirings (int32; float32 for min_plus,
     max_plus and sum_times, with weights beyond +-32 so that add_id + t
     passes add_id), B in {16, 128}, Q in {1, 5, 8}, gated by the
     per-slot bitmap and by the per-source-block live table (the engine's
     form) and dense, with and without a mask, V not a multiple of B, and
     all dead in both forms.  Exact equality, except float sum_times
     (atomic order) to 1e-4, and the same outputs at add_id in every case.
     Then the gate plus the kernel per call on a kron20-shaped table
     (a Graph500 Kronecker graph at SCALE 20, edge factor 16, built here,
     B=128, Q=8 two BFS supersteps out), the per-slot form against the
     live form, by CUDA events;
  3. the main path — BiBFS (interactive C=1 and batch C=8), the Hub² index
     build (k=1000, C=8) and Hub² batch queries on
     barabasi_albert(262144, 3) through backend="cuda", then the same work
     through backend="coo": identical answers and index, answers checked
     against a host BFS, and a kernel launch counter showing the cuda runs
     went through the kernel;
  4. one propagate at two shapes, Q=8 and a BFS frontier two hops out on
     barabasi_albert(n, 3) for n = 32768 (where the dense-tile kernel was
     timed) and n = 262144 (the main path's), gated as the engine gates
     it (block_live's table, held against its plain reduction, then the
     kernel): the gate plus the kernel, the kernel alone, plain version,
     COO scatter_reduce and gated COO (gather_edges=65536, one host sync)
     times, and the bound (the bytes the inputs need over 3.35 TB/s: per
     lit edge its position, x, mask and y once, the gate's read of the
     mask, its table written and read, and the source block of each slot
     that holds entries); at n = 32768 the kernel is also held against
     the dense tile loop over the dense table;
  5. the paper's other four query classes at full size, each through
     backend="cuda" and again through backend="coo" at C=8: terrain SSSP
     on grid_terrain(257, 257, eps_subdiv=2) (float32 min_plus), graph
     keyword search on the main path's graph (int32 min_plus, 4 lanes per
     slot), P2P reachability on random_dag(262144, 2.5) with its SCC and
     label index (int32 min_right) and XML SLCA/ELCA/MaxMatch on
     random_tree(262144, 8) (int32 max_right, 5, 9 and 21 lanes per
     slot): identical answers across the plans, a sample checked against
     a host oracle (scipy.sparse.csgraph, numpy), and the kernel launched
     in every cuda run.  Phase 2 also holds the kernel against its plain
     version at these paths' shapes: Q in {32, 42, 72, 168} on a reversed
     graph with weight N (int32 min_plus), a grid_terrain graph (float32
     min_plus), a random_tree (max_right) and a random_dag (min_right).
  6. fault tolerance, reusing phase 3's graph, rev view, pairs, packed
     tables, Hub² index and answers and phase 5's terrain data, C=8 on
     cuda: (6a) save_engine_store of the graph, rev view, tables and the
     k=1000 index into a temp dir (at least 4 GB free), load_engine_store,
     a BiBFS engine booted from it (0 table builds, the 256 answers of
     phase 3) and load_or_build_hub_index (no rebuild); (6b) the 256 BiBFS
     pairs with every live slot suspended at every round boundary; (6c)
     terrain, sjf, k=4: 8 heavy pairs across the mesh then 16 light ones,
     with and without preemption (every light before any heavy, identical
     answers); (6d) run_with_recovery of the 256 pairs from the store, an
     fsynced journal with a snapshot every 4 rounds, crashes injected at
     rounds 5 and 17 (the result map of phase 3); (6e) terrain with qid 3
     poisoned with NaN every round (POISONED, the other 7 as phase 5);
     (6f) the supervisor's SIGKILL crash test on the card.  Results,
     statuses and steps must be identical to the uninterrupted runs.
  7. mutable graphs and the gated COO plan, reusing phase 3's graph, rev
     view, pairs, tables, Hub2 index and answers and 6a's store, C=8 on
     cuda: (7a) a BiBFS engine with arg_carried=True and edge capacity
     |E| + 4096 per view, 8 queries in flight, through 6 deltas of 64
     added and 64 deleted undirected pairs (default_rng(7), both
     directions): the in-flight queries answer on version 0 as phase 3,
     after each delta 32 fresh pairs answer as a fresh coo engine (4 as a
     host BFS), both spliced packed tables equal to_packed_blocks of the
     mutated views, shape_changes stays 0, and one delta of 5,000 edges
     overflows the capacity and changes shapes once; per delta the host
     splice, upload, table splice (against a full to_packed_blocks),
     content_hash and cache invalidation times; (7b) a Hub2 engine with
     index_fn=hub_index_updater(backend="cuda") through the same deltas:
     each maintained index equals a pinned rebuild (every row re-labeled
     through coo; 4 sampled affected rows against a host loop; the
     engine's pinned build at every delta, through cuda at the first and
     last and through coo between), indexed answers
     equal 7a's BiBFS answers; then the delete of one undirected edge,
     chosen on the host from the current hub_dist, for which affected_hubs
     names between 1 and k - 1 rows (the incremental subset path; its
     count and maintenance ms printed, the index held against the pinned
     re-label, the indexed answers against a BiBFS drain); and a delta
     past the 1 % threshold takes the rebuild path (equal to the
     engine's build); (7c) run_with_recovery of
     the 256 pairs from 6a's store in three waves with a delta before each
     later wave, crashes at rounds 5 and 17, equal to the uninterrupted
     run, and a store saved at version 2 keeping its lineage; (7d) the 256
     BiBFS pairs through the gated COO gather and through ungated COO,
     twice each, both equal to phase 3.
  8. open-loop serving and the legacy round, reusing phase 3's graph, rev
     view, pairs, tables and answers and 6a's store, C=8, after printing
     the host tunings (launch/env.py): (8a) BFS with legacy=True against
     the fused round, k=1, through cuda and coo, 3 interleaved reps of
     each: median rounds/s and q/s and the fused/legacy ratio, answers
     identical across modes and plans and equal to phase 3's distances;
     (8b) BiBFS under Poisson arrivals (seed 2) at 0.5, 1, 2 and 4 queries
     per tick on the virtual clock, through cuda and coo: ticks,
     latencies, max_backlog and result maps identical; (8c) the
     wall-clock sweep on cuda at 0.25-3 x phase 3's closed-loop BiBFS q/s
     (q_max), 3 interleaved passes, each rate's median pass (by busy q/s:
     queries over the seconds spent pumping) printed and read for the
     knee: offered, achieved and busy q/s, p50/p99 latency split into
     queue wait and service, max_backlog, the saturation knee, one MMPP
     run (burst 4, dwell 32/rate) at 0.5 x q_max and the device busy share
     at q_max; (8d) 12 BiBFS replicas (result_cache=16) booted from 6a's
     store with one load_engine_store call, two per ReplicaPool, pumped
     one after another on the one card: a Zipf(1.1) mix of 512 queries
     over 64 of phase 3's pairs at 2 per tick on the virtual clock under
     affine, rr and p2c (hit rate, balance, spills, p99 ticks; the merged
     map equal to phase 3's single engine; affine hits above rr's), then
     one wall-clock affine run at 0.5 x q_max.
  9. mesh mode (core/distributed.py, launch/mesh.py, QuegelEngine(mesh=)),
     reusing phase 3's graph, pairs and answers, phase 5's reach DAG,
     index, pairs and answers and 7a's first three deltas, C=8: (9a) one
     NCCL rank, mesh (1,) axis "w" on cuda:0, batch BiBFS through mesh=
     with partition dst and src x steps_per_round 1 and 4, two interleaved
     passes beside a single-device coo drain of the same pairs: answers
     equal phase 3's; wall s, rounds/s, q/s, the device busy share and the
     share of device time in NCCL kernels (profiler), the engine's
     collective_bytes_per_round() and the model's bytes at w = 2, 4 and 8
     (labelled modeled); (9b) reach with its label index through mesh= on
     both partitions, answers equal phase 5's; (9c) BiBFS with
     arg_carried=True under the mesh through the three deltas with a wave
     of queries admitted before each and in flight across it: the spliced
     partitions equal a full re-partition of each new view row for row,
     Emax held, no shape change, every answer equal to a fresh
     single-device coo engine's on its admission version; (9d) four gloo
     ranks sharing the card with CUDA tensors, each a process of this
     script (--gloo-rank), batch BiBFS dst and src, every rank's answers
     equal phase 3's (timings labelled host-staged gloo, not NCCL); (9e)
     the supervisor's SIGKILL drill with the child as one NCCL rank under
     a mesh, 1 seed.  No frontier kernel launches in phase 9.
 10. LM serving (configs/*, models/*, launch/serve.py) in float32, TF32
     off, after freeing the graph phases' state: (10a) TinyLlama-1.1B at
     full width and depth (22 layers, d 2,048, 32 heads over 4 KV heads,
     d_ff 5,632, vocab 32,000), its weights drawn on the host by
     init_params from a seeded CPU generator and copied to the card; one
     32-token prompt's forward on the card against the host's forward,
     and teacher-forced serve_step against the card's forward, each
     within 1e-3 x max |logit|; (10b) SlotServer(capacity=8,
     max_len=512), fifo, 32 requests (prompts of 16-128 tokens,
     max_new_tokens 16-64, default_rng(0)) plus one over max_len, which
     must be REJECTED: requests, rounds, tokens, prefill tokens, wall,
     tok/s, ms per decode round and per prefill token (each prefill
     synchronized and timed apart), max_memory_allocated; 4 requests
     held against a no-cache greedy decode through forward on the card;
     8 requests at C=1 against C=8 and against the 32-request run; the
     device busy share and top device ops of a short C=8 mix (profiler);
     preemptive sjf at C=2 (2 long requests, then 6 short ones) retiring
     every short request before either long one with the tokens of the
     run without preemption; (10c) gemma2-9b at full width (d 3,584, 16
     heads over 8 KV heads of 256, d_ff 14,336, vocab 256,000, both
     softcaps), depth cut to 8 layers, weights drawn on the card from a
     seeded CUDA generator: teacher-forced decode against forward within
     1e-3 x max |logit|, and 8 requests at C=1 against C=4.  Near-tie
     rule: two token streams may differ only where the reference's top-2
     logit gap at the first differing step is within 1e-3 x max |logit|
     (through forward on the card); the smallest such gap is printed, and
     any other divergence fails.  No frontier kernel launches in phase 10.
 11. the other LM families in float32, TF32 off, after phase 10, each part
     printing its parameters (count, GB, weight-read bound per step over
     3.35 TB/s), one line per served run (as 10b, with
     max_memory_allocated), the device busy share of a short C=4 mix, and
     its seconds: (11a) mamba2-780m at full width and depth (48 stacked
     SSD layers), weights drawn on the host: a 320-token forward (two
     SSD chunks) on the card against the host's, teacher-forced
     serve_step against it; 8 requests (default_rng(1), prompts 8-32,
     8-24 new tokens) at C=4 twice (identical tokens) and at C=1; the two
     shortest at C=2 on the host, held against the card's C=2 run;
     (11b) recurrentgemma-2b at full width and depth (26 layers,
     rec/rec/attn), drawn on the card: teacher-forced decode against
     forward on 64 tokens, the 8 requests at C=4 twice and at C=1;
     (11c) deepseek-v2-236b at full width (MLA, 160 routed experts top-6
     plus 2 shared), depth cut to 2 stacked layers, drawn on the card:
     at capacity_factor = n_experts (no assignment dropped) decode
     against forward, the 8 requests at C=1 and C=8, 4 of them against
     a no-cache greedy forward; at the config's 1.25 the 8 requests at
     C=8, printing how many differ; (11d) whisper-base at full width and
     depth, drawn on the host: encode of 1,500 seeded frames and a
     32-token forward on the card against the host, decode against
     forward with enc_out = encode(frames), the 8 requests at C=1 and
     C=4.  The C=1 and C=4 streams of 11a and 11b, and 11c's at 1.25,
     legitimately differ: the reference server's recurrent state and
     shared MoE capacity (ROADMAP.md §3).  Near-tie rule as phase 10's,
     with the gap read from the reference server's own logits at the
     first differing step.  No frontier kernel launches in phase 11.
 12. LM training (train/*, models/* backward, launch/train.py), TF32 off:
     (12a) TinyLlama-1.1B at full width and depth in its own bfloat16
     with bf16 moments, drawn on the card: make_train_step(n_micro=2)
     with remat, OptConfig(warmup_steps=2, total_steps=12), synthetic
     batches of 8 x 2,048 tokens through the prefetch thread, 2 warm-up
     and 10 timed steps: loss, grad norm and lr per step (finite, the
     parameters move, the loss trend DOWN or flat as the JAX driver
     prints it), ms per step, tokens/s, mfu (6 N + 12 L S d model FLOPs a
     token, remat's recompute not counted, over 989.4 TFLOP/s bf16 dense),
     max_memory_allocated, and the device busy and GEMM shares of 2
     profiled steps; (12b) TinyLlama's width cut to 2 layers (153.6 M
     parameters) in float32, drawn on the host: one step of 2 x 256
     tokens (n_micro 2) on the card against the host, plain and with int8
     compression (loss and grad norm within 1e-4; parameters, moments
     and residuals by tests/_torch_train.py's rule); (12c) every arch at
     reduced size, 2 x 64 tokens, card against host by the same rule: the
     MoE's index_put_ backward, the SSD einsums, the RG-LRU loop and the
     encoder run backward on CUDA; (12d) `python -m
     repro_torch.launch.train --device cuda` with examples/train_lm.py's
     arguments (its last line "finished at step 30 with 1 restart(s)"),
     then tests/test_train.py's drill (tinyllama reduced, 8 steps, a
     failure at 5, checkpoints every 2) in a child (`chip_smoke.py
     --train-drill OUT`, CUBLAS_WORKSPACE_CONFIG=:4096:8, deterministic
     algorithms on before its first CUDA call): the restarted run's final
     parameters bit-identical to the clean run's.  No frontier kernel
     launches in phase 12.
 13. the sharding layer and the dry runs (models/common.py on DTensors,
     launch/{roofline,dryrun,dryrun_quegel}.py), TF32 off: (13a)
     attention's kv_shard path at llava-next-34b's heads (56 over 8 KV
     heads of 128, S 4,096, float32) against kv_shard=False on the card
     and one row against the host, within 1e-5 x max |out|, with the ms
     of each; (13b) TinyLlama-1.1B in bf16 on a (1, 1) ("data", "model")
     NCCL mesh: one step (8 x 2,048 tokens, n_micro 2, remat) on DTensors
     placed by param_spec against the plain step from the same state and
     batch (tests/_torch_train.py's rule), the ms of each, its local
     FLOPs equal to the dry run of the same cell on a one-rank fake mesh,
     max_memory_allocated beside MemTracker's peak; (13c) four gloo ranks
     (`chip_smoke.py --dist-rank OUT` children, CPU tensors: DTensor's
     collectives on gloo with CUDA tensors segfault under torch 2.11) on a
     (2, 2) mesh, TinyLlama's width cut to 2 layers in float32 with TP on
     'model' and FSDP on 'data': one step against the single-process step
     on the card, and its collective bytes equal to the fake dry run's;
     (13d) the Quegel BiBFS super-round at |V| 2^26, C 8 and 2^28 edges
     (a device's shard of 2^31 on the (32, 8) mesh) on the one rank, ms
     per round against the port's byte count over 3.35 TB/s, and a
     reduced round bit-equal on the card and the host; (13e) the fake dry
     runs (CPU children): the Quegel round at 2^26 / 2^31 on both
     production meshes and tinyllama train_4k and decode_32k on (32, 8),
     labelled fake-traced.  No frontier kernel launches in phase 13.
 14. the report (launch/report.py, host only) over JSON written in this
     run: (14a) `python -m repro_torch.launch.report --dir` over 13e's
     four JSONs as a CPU child, equal to report.main in-process: 4
     compiled, 0 skipped-by-design, 0 failed, 4 cells, the two tinyllama
     rows in each table (their 2x32x8 column "—"), each roofline row
     carrying its JSON's times through fmt_s and its temp_bytes in GiB;
     (14b) a JSON in BENCH_quegel.json's schema from phase 3's batch BiBFS
     and Hub2 batch at C=8 on cuda and coo (rounds/s, q/s, the engines'
     own p50/p95 latency, barriers) and 8a's cuda A/B, meta naming the
     card line of phase 0, rendered with --bench, every figure as
     bench_tables formats it; (14c) --bench BENCH_quegel.json through the
     CLI, its line count the one tests/test_torch_report.py pins.  No
     frontier kernel launches in phase 14.
Every cuda path of phases 2-8 runs with the kernel's launch counts set to
0 just before it and read just after, with the gate's: block_live's
launches, which must equal the kernel's calls gated by the live table,
and no call gated by a per-slot bitmap.  Then its work runs again with the kernel's output
held against the plain version, exactly, on the inputs of the 1st, 2nd,
4th, 8th, ... launch of each (semiring, dtype, Q) that the path
launched (all but 6e, whose poisoned lanes are NaN), and the live table
of each such launch against the mask's plain reduction; phase 7 holds each
delta's launches on that delta's spliced tables.  The last lines are the card, one JSON object
describing the kernel (its launches per path, semiring, dtype and Q
under "paths", the gate's launches per path under "gate_paths"), and
{"ok": true, "device": {...}}.
"""
import collections
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
MAIN_N, MAIN_M, MAIN_PAIRS = 262144, 3, 256
FIRST_N = 32768             # the dense-tile kernel's main path, timed like for like
TERRAIN_SIDE = 257          # grid_terrain(257, 257, eps_subdiv=2): 513 x 513 vertices
TERRAIN_K = 4               # terrain supersteps per round (hundreds per query)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Median of per-call CUDA event times, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def take_counts():
    """The kernel's launch counts since the last call, as (launches,
    {(semiring, dtype, Q): launches}, gates), and reset them to 0; gates
    counts block_live's launches ("block_live") and the kernel's calls by
    gating form ("live", "slots", "none")."""
    from repro_torch.kernels import frontier

    f = frontier.propagate_blocks
    gates = collections.Counter(f.gating)
    gates["block_live"] = sum(frontier.block_live.shapes.values())
    out = (frontier.launches(), dict(f.shapes), gates)
    for counter in (f.shapes, f.gating, frontier.block_live.shapes):
        counter.clear()
    return out


GATE_PATHS = {}  # path -> the gate's counts of its counted runs (take_counts)


def path_gates(path: str, gates, backend: str = "cuda") -> None:
    """Record one counted run's gate counts under its path.  On cuda every
    table the kernel is gated by is block_live's, one launch a call, and
    no call takes a per-slot bitmap; coo launches neither."""
    n = gates["block_live"]
    if backend == "cuda" and (gates["slots"] or n != gates["live"]):
        fail(f"{path}: {n} block_live launches for {gates['live']} live-gated and "
             f"{gates['slots']} bitmap-gated kernel calls")
    if backend != "cuda" and (n or sum(gates.values())):
        fail(f"{path}: the {backend} plan launched the gate or the kernel: {dict(gates)}")
    row = GATE_PATHS.setdefault(path, collections.Counter())
    row.update({k: v for k, v in gates.items() if v})


def path_rows(path: str, shapes: dict) -> list:
    """The kernel line's "paths" rows of one path's launch counts."""
    return [dict(path=path, semiring=sr, dtype=dt, q=q, launches=n)
            for (sr, dt, q), n in sorted(shapes.items())]


def path_keys(rows: list, path: str) -> set:
    """The (semiring, dtype, Q) keys that one path's counted run launched."""
    return {(r["semiring"], r["dtype"], r["q"]) for r in rows if r["path"] == path}


def check_launches(path: str, run, keys: set) -> None:
    """Run a path's work again with the kernel's output held against its
    plain version on exactly the inputs that launch was given: the 1st,
    2nd, 4th, 8th, ... launch of each (semiring, dtype, Q), so early,
    middle and late supersteps of the path's queries.  Exact
    (torch.equal) on every path: none of them runs float sum_times.
    Fails unless each key of ``keys`` (the path's counted run) was
    checked.  Each checked launch's live table (block_live's, as the plan
    gates) is held against the mask's plain reduction first.  The
    launches of this run are not counted."""
    from repro_torch.kernels import frontier, ops

    orig = ops.CudaBackend._run
    seen, checked, tables = collections.Counter(), collections.Counter(), [0]

    def checked_run(self, bs, sr, flat, mflat, **gate):
        out = orig(self, bs, sr, flat, mflat, **gate)
        key = (sr.name, str(flat.dtype).removeprefix("torch."), flat.shape[0])
        seen[key] += 1
        if seen[key] & (seen[key] - 1) == 0:
            if "live" in gate:
                want_live = frontier.block_live_plain(mflat, bs.num_dst_blocks, bs.block)
                if not torch.equal(gate["live"], want_live):
                    fail(f"{path}: launch {seen[key]} at {key}: block_live's table "
                         "differs from the mask's plain reduction")
                tables[0] += 1
            want = frontier.propagate_blocks_plain(bs, sr, flat, mflat, **gate)
            if out.shape != want.shape or not torch.equal(out, want):
                fail(f"{path}: launch {seen[key]} at {key} differs from the plain "
                     "version on its own inputs")
            checked[key] += 1
        return out

    f = frontier.propagate_blocks
    saved = f.shapes.copy()
    ops.CudaBackend._run = checked_run
    try:
        run()
        torch.cuda.synchronize()
    finally:
        ops.CudaBackend._run = orig
        f.shapes = saved  # a check, not the path
    missing = set(keys) - set(checked)
    if missing:
        fail(f"{path}: no launch at {sorted(missing)} was held against the plain version")
    done = ", ".join(f"{sr}/{dt}/Q={q} x{n}" for (sr, dt, q), n in sorted(checked.items()))
    print(f"  [cuda] {path}: kernel == plain, exactly, on {sum(checked.values())} of "
          f"{sum(seen.values())} launches, on their own inputs ({done}); block_live == "
          f"plain on the {tables[0]} live tables among them", flush=True)


# ------------------------------------------------------------ phase 2
def parity_graph(n: int, kind: str, sr, dtype, rng):
    """A random graph on the card; "hubs": barabasi_albert(n, 3), whose hub
    rows span several work items at B=128; "dups": duplicate edges, a lone
    edge whose weight is add_id and a duplicate pair that combines to
    add_id."""
    from repro_torch.core.graph import Graph, barabasi_albert, random_graph

    dups = kind == "dups"
    base = (barabasi_albert(n, 3, seed=n, device="cpu") if kind == "hubs"
            else random_graph(n, 3.0, seed=n, device="cpu"))
    s, d, w = base._edges_np()
    if dups:
        extra = rng.integers(0, len(s), n // 4)
        s, d = np.concatenate([s, s[extra], s[:1]]), np.concatenate([d, d[extra], d[:1]])
    if dtype == torch.float32:  # |t| > 32: add_id + t passes add_id
        w = (64 * rng.standard_normal(len(s))).astype(np.float32)
    elif dups:
        w = rng.integers(1, 9, len(s)).astype(np.int32)
    if dups:
        add_id = sr.identity(dtype)
        w[len(s) // 2] = add_id
        w[0], w[-1] = (add_id, add_id) if add_id else (w[-1], -w[-1])
    return Graph.from_edges(s, d, n, w=w, weight_dtype=w.dtype, device="cuda")


def kernel_cases(pb, sr, x, m, where: str):
    """The kernel against its plain version on one packed table and x:
    gated by the per-slot bitmap and by the live table, and dense, with
    and without the mask m, and all dead in both forms.  Exact, except
    float sum_times (atomic order) to 1e-4; the outputs at add_id are the
    same in every case.  Returns (cases, max abs error)."""
    from repro_torch.kernels import frontier, ops

    nb = pb.num_dst_blocks
    dead = dict(active=torch.zeros((nb, pb.max_bpr), dtype=torch.bool, device="cuda"))
    dead_live = dict(live=torch.zeros(nb, dtype=torch.bool, device="cuda"))
    variants = [
        (None, dict(active=ops.block_activity(pb, None))),       # gated, no mask
        (m, dict(active=ops.block_activity(pb, m))),             # gated, mask
        (m, dict(live=frontier.block_live(m, nb, pb.block))),    # the engine's gate
        (None, {}),                                              # dense
        (m, {}),                                                 # dense, mask
        (m, dead),                                               # all dead
        (m, dead_live),                                          # all dead, live form
    ]
    worst = 0.0
    add_id = sr.identity(x.dtype)
    for mask, gate in variants:
        got = frontier.propagate_blocks(pb, sr, x, mask, **gate)
        want = frontier.propagate_blocks_plain(pb, sr, x, mask, **gate)
        torch.cuda.synchronize()
        at = f"{where} mask={mask is not None} gate={sorted(gate)}"
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"kernel shape/dtype differs: {at}")
        if not torch.equal(got == add_id, want == add_id):
            fail(f"kernel and plain differ on which outputs are add_id: {at}")
        if x.dtype == torch.float32 and sr.name == "sum_times":
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                fail(f"kernel disagrees beyond 1e-4: {at}")
            worst = max(worst, float((got - want).abs().max()))
        elif not torch.equal(got, want):
            fail(f"kernel differs from plain version: {at}")
        if (gate is dead or gate is dead_live) and not (got == add_id).all():
            fail(f"all-dead gate left a non-identity output: {at}")
    return len(variants), worst


def kronecker_arcs(scale: int, edgefactor: int, seed: int, device="cuda"):
    """A Graph500 Kronecker graph (A, B, C = 0.57, 0.19, 0.19): each of
    edgefactor * 2**scale edges placed bit by bit in a quadrant, labels
    permuted and edges shuffled, the quadrants and the labels both drawn
    from ``seed``; then both arcs of every edge, self-loops and duplicates
    dropped.  Returns int32 (src, dst) sorted by (src, dst), and n."""
    m, n = edgefactor << scale, 1 << scale
    a, b, c = 0.57, 0.19, 0.19
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    gens = [torch.Generator(device=device) for _ in range(2)]
    for gen in gens:
        gen.manual_seed(seed)
    ii = torch.zeros(m, dtype=torch.int64, device=device)
    jj = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii_bit = torch.rand(m, generator=gens[0], device=device) > ab
        jj_bit = torch.rand(m, generator=gens[0], device=device) > torch.where(
            ii_bit, c_norm, a_norm)
        ii += ii_bit.to(torch.int64) << bit
        jj += jj_bit.to(torch.int64) << bit
    perm = torch.randperm(n, generator=gens[1], device=device)
    shuffle = torch.randperm(m, generator=gens[1], device=device)
    u, v = perm[ii][shuffle], perm[jj][shuffle]
    s, d = torch.cat([u, v]), torch.cat([v, u])
    key = torch.unique(s[s != d] * n + d[s != d])
    return (key // n).to(torch.int32), (key % n).to(torch.int32), n


def phase_gate_timing() -> dict:
    """The tile gate plus the kernel per call on a kron20-shaped table:
    :func:`kronecker_arcs` at SCALE 20, edge factor 16, seed 1, B=128,
    min_right, Q=8 lanes two BFS supersteps out.  The per-slot form
    (``block_activity``'s (nb, max_bpr) grid, then the kernel) against the
    live form (``block_live``'s one launch, then the kernel), by CUDA
    events, the two outputs held equal; and each form's peak memory above
    what the inputs hold."""
    from repro_torch.core.graph import Graph
    from repro_torch.core.semiring import MIN_RIGHT
    from repro_torch.kernels import frontier, ops

    sr, q = MIN_RIGHT, 8
    src, dst, n = kronecker_arcs(20, 16, seed=1)
    g = Graph.from_edges(src.cpu().numpy(), dst.cpu().numpy(), n, device="cuda")
    del src, dst
    (pb, dt) = sync_time(lambda: g.to_packed_blocks(128, sr))
    dist, front = bfs_frontier(g, q)
    nb, b = pb.num_dst_blocks, pb.block
    if not torch.equal(frontier.block_live(front, nb, b),
                       frontier.block_live_plain(front, nb, b)):
        fail("gate timing: block_live differs from the mask's plain reduction")
    slots = lambda: frontier.propagate_blocks(pb, sr, dist, front,
                                              ops.block_activity(pb, front))
    live = lambda: frontier.propagate_blocks(pb, sr, dist, front,
                                             live=frontier.block_live(front, nb, b))
    if not torch.equal(slots(), live()):
        fail("gate timing: the live form differs from the per-slot form")
    peak = {}
    for name, fn in (("slots", slots), ("live", live)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    act, table = ops.block_activity(pb, front), frontier.block_live(front, nb, b)
    out = dict(
        gate_slots_ms=event_ms(lambda: ops.block_activity(pb, front), 50),
        gate_live_ms=event_ms(lambda: frontier.block_live(front, nb, b), 50),
        kernel_slots_ms=event_ms(lambda: frontier.propagate_blocks(pb, sr, dist, front, act), 50),
        kernel_live_ms=event_ms(lambda: frontier.propagate_blocks(pb, sr, dist, front,
                                                                  live=table), 50),
        call_slots_ms=event_ms(slots, 50), call_live_ms=event_ms(live, 50),
        peak_slots_bytes=peak["slots"], peak_live_bytes=peak["live"])
    take_counts()  # timing launches are not a path's
    print(f"phase 2 gate timing: kronecker SCALE {n.bit_length() - 1}, {g.num_edges} arcs, packed table "
          f"{pb.nbytes} bytes (slot grid {tuple(pb.src_ids.shape)}) in {dt:.2f} s; "
          f"{int(front.sum())} frontier vertices light {int(table.sum())} of {nb} "
          f"source blocks; per call, ms: " + ", ".join(
              f"{k} {v!r}" for k, v in out.items()), flush=True)
    del g, pb, dist, front, act, table
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_kernel_parity() -> float:
    """Every case of the kernel against its plain version; returns the
    largest absolute difference seen (0 on every integer case)."""
    from repro_torch.core.graph import pack_blocks
    from repro_torch.core.semiring import BY_NAME

    cases = [("min_plus", torch.int32), ("min_right", torch.int32),
             ("max_right", torch.int32), ("max_plus", torch.int32),
             ("sum_times", torch.int32), ("min_plus", torch.float32),
             ("max_plus", torch.float32), ("sum_times", torch.float32)]
    worst, n_cases = 0.0, 0
    for n, kind in ((1000, "random"), (4096, "random"), (1000, "dups"),
                    (4096, "hubs")):
        rng = np.random.default_rng(n + len(kind))
        dups = kind == "dups"
        for sr_name, dtype in cases:
            sr = BY_NAME[sr_name]
            g = parity_graph(n, kind, sr, dtype, rng)
            for block in (16, 128):
                pb = g.to_packed_blocks(block, sr)
                if dups:  # packing the dense table on the card gives the same
                    packed = pack_blocks(g.to_blocks(block, sr.add_id), sr)
                    for name in ("src_ids", "nslots", "row_ptr", "entries", "w"):
                        a, b = getattr(pb, name), getattr(packed, name)
                        if (a is None) != (b is None) or (
                                a is not None and not torch.equal(a, b)):
                            fail(f"pack_blocks and to_packed_blocks differ in {name}: "
                                 f"{sr_name}/{dtype} B={block}")
                for q in (1, 5, 8):
                    if dtype == torch.float32:
                        x = rng.standard_normal((q, n)).astype(np.float32)
                    else:
                        x = rng.integers(0, 20, (q, n)).astype(np.int32)
                        x[rng.random((q, n)) < 0.5] = sr.add_id
                    x = torch.from_numpy(x).cuda()
                    m = torch.from_numpy(rng.random((q, n)) < 0.2).cuda()
                    where = f"{sr_name}/{dtype} n={n} {kind} B={block} Q={q}"
                    k, err = kernel_cases(pb, sr, x, m, where)
                    n_cases += k
                    worst = max(worst, err)
    print(f"phase 2: packed kernel == plain on {n_cases} cases (exact, float "
          f"sum_times to rtol=atol=1e-4); max_abs_err={worst!r}", flush=True)
    return worst


def phase_kernel_parity_apps() -> None:
    """The kernel against its plain version at the shapes of phase 5's
    paths, exactly: Q in {32, 42, 72, 168} (42 is no multiple of the
    8-lane tile) on a reversed random graph with weight N under int32
    min_plus (x = hop * N + vid or INF), a grid_terrain graph under
    float32 min_plus (x = distances >= 0 or 2^30), a random_tree under
    max_right (x in {0, 1}) and a random_dag under min_right."""
    from repro_torch.core.graph import (Graph, grid_terrain, random_dag, random_graph,
                                        random_tree)
    from repro_torch.core.semiring import INF, MAX_RIGHT, MIN_PLUS, MIN_RIGHT

    rev = random_graph(4096, 3.0, seed=7, device="cpu").reverse()
    s_, d_, _ = rev._edges_np()
    keyword_g = Graph.from_edges(s_, d_, rev.n_real, w=np.full(len(s_), rev.n, np.int32),
                                 device="cuda")
    terrain_g, _ = grid_terrain(32, 32, eps_subdiv=2, seed=0, device="cuda")
    tree_g, _ = random_tree(4096, max_fanout=8, seed=0, device="cuda")
    dag_g = random_dag(4096, 2.5, seed=0, device="cuda")

    def keyword_x(rng, q, n):
        x = (rng.integers(0, 4, (q, n)) * n + rng.integers(0, n, (q, n))).astype(np.int32)
        x[rng.random((q, n)) < 0.5] = INF
        return x

    def terrain_x(rng, q, n):
        x = (rng.random((q, n)) * 5000).astype(np.float32)
        x[rng.random((q, n)) < 0.5] = float(INF)
        return x

    paths = [("keyword", keyword_g, MIN_PLUS, keyword_x),
             ("terrain", terrain_g, MIN_PLUS, terrain_x),
             ("xml", tree_g, MAX_RIGHT,
              lambda rng, q, n: rng.integers(0, 2, (q, n)).astype(np.int32)),
             ("reach", dag_g, MIN_RIGHT,
              lambda rng, q, n: np.where(rng.random((q, n)) < 0.5, INF,
                                         rng.integers(0, 20, (q, n))).astype(np.int32))]
    n_cases = 0
    for name, g, sr, make_x in paths:
        rng = np.random.default_rng(len(name))
        for block in (16, 128):
            pb = g.to_packed_blocks(block, sr)
            for q in (32, 42, 72, 168):
                x = torch.from_numpy(make_x(rng, q, g.n)).cuda()
                m = torch.from_numpy(rng.random((q, g.n)) < 0.3).cuda()
                k, err = kernel_cases(pb, sr, x, m, f"{name} {sr.name} B={block} Q={q}")
                if err != 0.0:
                    fail(f"{name}: the kernel is not exact")
                n_cases += k
    print(f"phase 2: packed kernel == plain, exactly, on {n_cases} cases at the "
          f"app paths' shapes (Q in 32, 42, 72, 168)", flush=True)


# ------------------------------------------------------------ phase 3
def host_bfs(graph, s: int) -> np.ndarray:
    """Hop distances from s by a plain frontier loop over the host COO."""
    src, dst, _ = graph._edges_np()
    dist = np.full(graph.n, -1, np.int64)
    dist[s] = 0
    front = np.zeros(graph.n, bool)
    front[s] = True
    step = 0
    while front.any():
        step += 1
        reach = np.zeros(graph.n, bool)
        reach[dst[front[src]]] = True
        front = reach & (dist < 0)
        dist[front] = step
    return dist


def host_hub_labels(graph, is_hub: np.ndarray, h: int):
    """HubLabelBFS's row for hub h by a plain frontier loop over the host
    COO: (dist, pre), pre[v] set when some shortest h-v path passes a hub
    other than h."""
    src, dst, _ = graph._edges_np()
    dist = np.full(graph.n, 2**30, np.int64)
    dist[h] = 0
    pre = np.zeros(graph.n, bool)
    front = np.zeros(graph.n, bool)
    front[h] = True
    other = is_hub.copy()
    other[h] = False
    step = 0
    while front.any():
        step += 1
        act = front[src]
        reach = np.zeros(graph.n, bool)
        reach[dst[act]] = True
        flagged = np.zeros(graph.n, bool)
        flagged[dst[act & (other | pre)[src]]] = True
        front = reach & (dist >= 2**30)
        dist[front] = step
        pre |= front & flagged
    return dist, pre


def device_breakdown(run, wall_s: float, what: str, kernel: str = "propagate_packed"):
    """Run the same work again under torch.profiler and split the device
    time by kernel; the busy share is over the unprofiled wall time of the
    same work (the profiler's own overhead would inflate it).  Only device
    activity is traced: host op events cost tens of seconds on the
    terrain path's 16,000 supersteps.  Returns (device busy s, the device
    s of the kernels whose lowercased name holds ``kernel``: the frontier
    kernel by default), None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import frontier

    f = frontier.propagate_blocks
    saved = f.shapes.copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    f.shapes = saved  # a measurement, not the path
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0:
            dev[e.key] = dev.get(e.key, 0) + us
    if not dev:
        print(f"  {what}: profiler saw no device time: device busy share not measured",
              flush=True)
        return None, None
    busy = sum(dev.values()) / 1e6
    kernel_s = sum(v for k, v in dev.items() if kernel in k.lower()) / 1e6
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:4]
    names = "; ".join(f"{k[:60]} {v / 1e6:.4f} s" for k, v in top)
    print(f"  {what}: device busy {busy:.4f} s of {wall_s:.4f} s wall "
          f"({100 * busy / wall_s:.1f} %); top kernels: {names} (profiled in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return busy, kernel_s


def redrain(eng, pairs):
    """Queue the same queries again; returns the drain to profile."""
    for p in pairs:
        eng.submit(p)
    return eng.run_until_drained


def hot_cell(st, n_queries: int, wall: float) -> dict:
    """One drain's cell in BENCH_quegel.json's ``workloads`` schema, from the
    engine's own stats (read before anything else runs on the engine)."""
    return dict(wall_s=wall, super_rounds=st.super_rounds, barriers=st.barriers,
                super_rounds_per_sec=st.super_rounds / wall,
                queries_per_sec=n_queries / wall,
                p50_query_latency_s=st.latency_percentile(50),
                p95_query_latency_s=st.latency_percentile(95),
                supersteps_total=st.supersteps_total)


def run_main_path(g, pairs, backend: str) -> dict:
    from repro_torch.apps.hub2 import build_hub_index, make_hub2_engine
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.configs.quegel import QuegelConfig
    from repro_torch.launch.supervise import _result_map

    cfg = QuegelConfig()
    kw = dict(backend=backend, block=cfg.block_size)
    out, rounds, paths, total = {}, 0, [], [0]
    torch.cuda.reset_peak_memory_stats()

    def launched(path: str) -> int:
        """Read the counts of the path just driven (and set them to 0)."""
        n, shapes, gates = take_counts()
        total[0] += n
        paths.extend(path_rows(path, shapes))
        path_gates(path, gates, backend)
        return n

    eng = make_bibfs_engine(g, capacity=1, **kw)
    take_counts()
    res, dt = sync_time(lambda: [eng.query(p) for p in pairs[:8]])
    out["interactive"] = dict(enumerate(res))
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] interactive BiBFS C=1: 8 queries, {st.rounds} rounds, "
          f"{st.supersteps_total} supersteps, {8 / dt:.3f} q/s, "
          f"{dt / max(st.rounds, 1):.6f} s/round, {launched('bibfs_interactive')} "
          "kernel launches",
          flush=True)
    if backend == "cuda":
        check_launches("bibfs_interactive", lambda: [eng.query(p) for p in pairs[:8]],
                       path_keys(paths, "bibfs_interactive"))
    del eng
    gc.collect()

    eng = make_bibfs_engine(g, capacity=cfg.capacity, **kw)
    table_bytes = eng.table_bytes()
    for p in pairs:
        eng.submit(p)
    take_counts()
    res, dt = sync_time(eng.run_until_drained)
    out["bibfs"], out["bibfs_qps"] = res, len(pairs) / dt
    out["hot"] = {"bibfs": hot_cell(eng.stats, len(pairs), dt)}
    # phase 6 reuses the uninterrupted answers, the rev view and the tables,
    # kept on the host so that later phases' peak memory does not hold them
    out["bibfs_map"] = _result_map(eng)
    out["rev"] = eng.aux_graphs["rev"].to("cpu")
    out["tables"] = tables_to(eng.export_tables(), "cpu")
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] batch BiBFS C={cfg.capacity}: {len(pairs)} queries, "
          f"{st.rounds} rounds, {st.supersteps_total} supersteps, "
          f"{len(pairs) / dt:.3f} q/s, {dt / st.rounds:.6f} s/round, "
          f"table bytes {table_bytes}, {launched('bibfs')} kernel launches", flush=True)
    device_breakdown(redrain(eng, pairs), dt, f"[{backend}] batch BiBFS")
    if backend == "cuda":
        check_launches("bibfs", redrain(eng, pairs), path_keys(paths, "bibfs"))
    del eng
    gc.collect()

    take_counts()
    build = lambda: build_hub_index(g, cfg.hub_k, capacity=cfg.capacity, **kw)
    idx, build_s = sync_time(build)
    out["index"] = {k: getattr(idx, k).cpu().numpy()
                    for k in ("hub_ids", "is_hub", "hub_dist", "core")}
    out["hub_index"], out["build_s"] = idx.to("cpu"), build_s
    print(f"  [{backend}] Hub2 index build k={cfg.hub_k} C={cfg.capacity}: "
          f"{build_s:.3f} s wall (table build included), {launched('hub2_build')} "
          "kernel launches",
          flush=True)
    gc.collect()

    eng = make_hub2_engine(g, idx, capacity=cfg.capacity, **kw)
    hub2_table_bytes = eng.table_bytes()
    for p in pairs:
        eng.submit(p)
    take_counts()
    res, dt = sync_time(eng.run_until_drained)
    out["hub2"] = res
    out["hot"]["hub2"] = hot_cell(eng.stats, len(pairs), dt)
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] Hub2 batch C={cfg.capacity}: {len(pairs)} queries, "
          f"{st.rounds} rounds, {st.supersteps_total} supersteps, "
          f"{len(pairs) / dt:.3f} q/s, {dt / st.rounds:.6f} s/round, "
          f"table bytes {hub2_table_bytes}, {launched('hub2')} kernel launches", flush=True)
    device_breakdown(redrain(eng, pairs), dt, f"[{backend}] Hub2 batch")
    if backend == "cuda":
        check_launches("hub2", redrain(eng, pairs), path_keys(paths, "hub2"))
    del eng, idx
    gc.collect()
    torch.cuda.empty_cache()
    out["engine_rounds"] = rounds
    out["launches"], out["paths"] = total[0], paths
    print(f"  [{backend}] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    def rebuild():  # after the peak is read: a second index holds 1.3 GB
        build()

    device_breakdown(rebuild, build_s, f"[{backend}] Hub2 index build")
    if backend == "cuda":
        check_launches("hub2_build", rebuild, path_keys(paths, "hub2_build"))
    return out


def tables_to(tables: dict, device) -> dict:
    """{view: {semiring: table}} with every table on ``device``."""
    return {v: {k: t.to(device) for k, t in d.items()} for v, d in tables.items()}


def same_results(a: dict, b: dict) -> bool:
    if sorted(a) != sorted(b):
        return False
    for q in a:
        for k in a[q]:
            if not np.array_equal(np.asarray(a[q][k]), np.asarray(b[q][k])):
                return False
    return True


def phase_main_path():
    from repro_torch.configs.quegel import QuegelConfig
    from repro_torch.core.graph import barabasi_albert

    (g, dt) = sync_time(lambda: barabasi_albert(MAIN_N, MAIN_M, seed=0))
    print(f"phase 3: barabasi_albert({MAIN_N}, {MAIN_M}): {g.num_edges} edges "
          f"in {dt:.2f} s", flush=True)
    pairs = np.random.default_rng(1).integers(0, g.n_real, (MAIN_PAIRS, 2)).astype(np.int32)

    cuda = run_main_path(g, pairs, "cuda")
    launches = cuda["launches"]
    rounds = cuda["engine_rounds"]
    print(f"  kernel launches in the cuda runs: {launches} over {rounds} "
          "engine rounds (hub build rounds not counted)", flush=True)
    if launches < rounds or launches == 0:
        fail(f"kernel launched {launches} times over {rounds} rounds")

    coo = run_main_path(g, pairs, "coo")
    if coo["launches"]:
        fail(f"the coo runs launched the kernel {coo['launches']} times")
    for part in ("interactive", "bibfs", "hub2"):
        if not same_results(cuda[part], coo[part]):
            fail(f"{part}: cuda and coo answers differ")
    for k, a in cuda["index"].items():
        if not np.array_equal(a, coo["index"][k]):
            fail(f"Hub2 index field {k}: cuda and coo differ")
    # an independent check: hop distances from a host BFS
    for q, (s, t) in enumerate(pairs[:16]):
        d = host_bfs(g, int(s))[int(t)]
        want = d if d >= 0 else 2**30
        for part in ("bibfs", "hub2"):
            got = int(cuda[part][q]["dist"])
            if got != want:
                fail(f"{part} d({s},{t}) = {got}, host BFS says {want}")
    hubs = cuda["index"]["hub_ids"]
    for r in (0, 1, len(hubs) - 1):
        d = host_bfs(g, int(hubs[r]))
        want = np.where(d >= 0, d, 2**30).astype(np.int32)
        if not np.array_equal(cuda["index"]["hub_dist"][r], want):
            fail(f"hub_dist row {r} differs from host BFS")
    print("phase 3: cuda == coo on every answer and index array; 16 pairs "
          "and 3 hub rows match a host BFS", flush=True)
    cuda["hot"] = {wl: {be: {f"C{QuegelConfig().capacity}": run["hot"][wl]}
                        for be, run in (("cuda", cuda), ("coo", coo))}
                   for wl in ("bibfs", "hub2")}
    return g, pairs, launches, cuda


# ------------------------------------------------------------ phase 4
def bfs_frontier(g, q: int):
    """Q=8 lanes two BFS supersteps out from the first q sources of the
    main path's pairs (default_rng(1)): (dist, frontier) on the card."""
    from repro_torch.core.semiring import INF, MIN_RIGHT
    from repro_torch.kernels import ops

    pairs = np.random.default_rng(1).integers(0, g.n_real, (MAIN_PAIRS, 2))
    src = torch.as_tensor(pairs[:q, 0].astype(np.int64), device="cuda")
    rows = torch.arange(q, device="cuda")
    dist = torch.full((q, g.n), INF, dtype=torch.int32, device="cuda")
    dist[rows, src] = 0
    front = torch.zeros((q, g.n), dtype=torch.bool, device="cuda")
    front[rows, src] = True
    coo = ops.CooBackend(g)
    for step in (1, 2):
        got = coo.propagate(MIN_RIGHT, dist, front)
        front = (got < INF) & (dist >= INF)
        dist = torch.where(front, step, dist)
    return dist, front


def time_propagate(g, check_dense: bool) -> dict:
    """One propagate at the main path's shapes on ``g``, gated as the
    engine gates it (block_live's table, then the kernel): gate plus
    kernel, kernel alone, plain version and COO scatter_reduce times, and
    the bound from the bytes these inputs need."""
    from repro_torch.core.graph import pack_blocks
    from repro_torch.core.semiring import MIN_RIGHT
    from repro_torch.kernels import frontier, ops, ref

    q, sr = 8, MIN_RIGHT
    dist, front = bfs_frontier(g, q)
    (pb, dt) = sync_time(lambda: g.to_packed_blocks(128, sr))
    nb, b = pb.num_dst_blocks, pb.block
    live = frontier.block_live(front, nb, b)
    if not torch.equal(live, frontier.block_live_plain(front, nb, b)):
        fail(f"n={g.n}: block_live differs from the mask's plain reduction")
    k, _, _ = pb.decode()
    i = torch.repeat_interleave(torch.arange(nb, device="cuda"), pb.row_ptr.diff().long())
    slot = i * pb.max_bpr + k
    lit_edges = int(live[pb.src_ids.reshape(-1)[slot].long()].sum())
    real = ops.block_activity(pb, None)  # the slots below nslots
    lit_tiles = int((real & live[pb.src_ids.long()]).sum())
    # the slots that hold entries (no entry names the padding of the
    # (nb, max_bpr) grid): the kernel reads the source block of each
    held = torch.zeros(real.numel(), dtype=torch.bool, device="cuda")
    held[slot] = True
    held_slots = int(held.sum())
    print(f"phase 4 n={g.n}: packed table {pb.nbytes} bytes ({pb.entries.numel()} "
          f"entries, slot grid {tuple(pb.src_ids.shape)}) built in {dt:.2f} s; "
          f"{int(front.sum())} frontier vertices light {int(live.sum())} of {nb} source "
          f"blocks, {lit_tiles} of {int(pb.nslots.sum())} tiles ({held_slots} holding "
          f"entries) and {lit_edges} edges; block_live == its plain reduction", flush=True)

    gated = lambda: frontier.propagate_blocks(pb, sr, dist, front,
                                              live=frontier.block_live(front, nb, b))
    kern = lambda: frontier.propagate_blocks(pb, sr, dist, front, live=live)
    plain = lambda: frontier.propagate_blocks_plain(pb, sr, dist, front, live=live)
    coo = ops.CooBackend(g)
    lib = lambda: coo.propagate(sr, dist, front)
    y_k, y_p, y_c = gated(), plain(), lib()
    if not (torch.equal(y_k, y_p) and torch.equal(y_k, y_c)):
        fail(f"n={g.n} propagate: kernel, plain and coo disagree")
    if check_dense:
        (bs, dt) = sync_time(lambda: g.to_blocks(128, sr.add_id))
        y_d = ref.propagate_blocks_ref(bs, sr, dist, front, ops.block_activity(pb, front))
        packed = pack_blocks(bs, sr)
        same = all(torch.equal(getattr(pb, f), getattr(packed, f))
                   for f in ("src_ids", "nslots", "row_ptr", "entries"))
        print(f"phase 4 n={g.n}: dense table {tuple(bs.tiles.shape)} "
              f"({bs.nbytes} bytes) built in {dt:.2f} s; kernel == dense tile "
              f"loop: {torch.equal(y_k, y_d)}; pack_blocks(dense) == packed: "
              f"{same}", flush=True)
        if not (torch.equal(y_k, y_d) and same):
            fail(f"n={g.n}: the packed kernel differs from the dense tile semantics")
        del bs, packed, y_d
        gc.collect()
        torch.cuda.empty_cache()
    gated_coo_be = ops.CooBackend(g, gather_edges=65536)
    gated_coo = lambda: gated_coo_be.propagate(sr, dist, front)
    if not torch.equal(gated_coo(), y_k):
        fail(f"n={g.n} propagate: gated coo differs from the kernel")
    ms = event_ms(gated, 50)
    kernel_ms = event_ms(kern, 50)
    plain_ms = event_ms(plain, 10)
    library_ms = event_ms(lib, 50)
    gated_ms = event_ms(gated_coo, 50)
    take_counts()  # timing launches are not a path's
    v = g.n
    per_edge = 4 + (4 if sr.reads_weight else 0)   # packed position (+ weight)
    gate_bytes = q * v + 2 * nb                    # block_live: mask read, table written, read
    nbytes = (lit_edges * per_edge
              + q * v * (4 + 1 + 4)                # x, mask, y
              + gate_bytes + held_slots * 4)       # the gate, src_ids
    dense_bytes = (lit_tiles * pb.block ** 2 * 4 + q * v * (4 + 1 + 4)
                   + gate_bytes + held_slots * 4)
    ops_ = lit_edges * q * 2                       # select + min per edge and lane
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    active_edges = int(gated_coo_be.graph.out_deg[front.any(0)].sum())
    print(f"phase 4 n={g.n}: gate + kernel {ms!r} ms (kernel alone {kernel_ms!r} ms), "
          f"plain {plain_ms!r} ms, coo scatter_reduce {library_ms!r} ms, gated coo "
          f"(gather_edges=65536, {active_edges} active edges, one host sync) {gated_ms!r} "
          f"ms, bound {bound_ms!r} ms by {bound_by} ({nbytes} bytes, {ops_} ops); for "
          f"information, the dense layout's bytes {dense_bytes} "
          f"({dense_bytes / HBM_BYTES_PER_S * 1e3!r} ms)", flush=True)
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, gated_coo_ms=gated_ms,
                bound_bytes=nbytes, lit_edges=lit_edges, held_slots=held_slots,
                live_blocks=int(live.sum()))


def phase_timing(g_main) -> dict:
    from repro_torch.core.graph import barabasi_albert

    first = time_propagate(barabasi_albert(FIRST_N, MAIN_M, seed=0, device="cuda"),
                           check_dense=True)
    gc.collect()
    torch.cuda.empty_cache()
    main = time_propagate(g_main, check_dense=False)
    return dict(main, n=g_main.n, **{f"at_n_{FIRST_N}": first})


# ------------------------------------------------------------ phase 5
APPS_C = 8  # QuegelConfig.capacity


def run_app(path: str, make_engine, queries, backend: str) -> dict:
    """One query class through one plan: build its engine, drain the
    queries with the kernel's counts set to 0 just before and read just
    after, then profile a second drain of the same queries; on cuda, a
    third drain holds launches of the kernel against its plain version
    on their own inputs (:func:`check_launches`)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, build_s = sync_time(lambda: make_engine(backend))
    for q in queries:
        eng.submit(q)
    take_counts()
    res, dt = sync_time(eng.run_until_drained)
    launches, shapes, gates = take_counts()
    path_gates(path, gates, backend)
    st = eng.stats
    rounds, steps = st.rounds, st.supersteps_total
    mem = torch.cuda.max_memory_allocated()
    busy, kernel_s = device_breakdown(redrain(eng, queries), dt, f"[{backend}] {path}")
    kernel = ("no kernel" if backend == "coo" else "not measured" if kernel_s is None
              else f"{kernel_s:.4f} s")
    print(f"  [{backend}] {path}: {len(queries)} queries, {rounds} rounds, {steps} "
          f"supersteps, wall {dt:.4f} s, {len(queries) / dt:.3f} q/s, {launches} kernel "
          f"launches, kernel device {kernel}, engine built in {build_s:.3f} s, "
          f"max_memory_allocated {mem} bytes", flush=True)
    if backend == "cuda" and (launches == 0 or launches < rounds):
        fail(f"{path}: the cuda run launched the kernel {launches} times in {rounds} rounds")
    if backend == "coo" and launches:
        fail(f"{path}: the coo run launched the kernel {launches} times")
    rows = path_rows(path, shapes)
    if backend == "cuda":
        check_launches(path, redrain(eng, queries), path_keys(rows, path))
    tables = eng.export_tables()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(results=res, launches=launches, rows=rows, tables=tables)


def both_plans(path: str, make_engine, queries) -> tuple:
    """The same queries through cuda and coo; fails unless every answer is
    identical.  Returns (cuda answers, launches, path rows, cuda tables)."""
    cuda = run_app(path, make_engine, queries, "cuda")
    coo = run_app(path, make_engine, queries, "coo")
    if not same_results(cuda["results"], coo["results"]):
        fail(f"{path}: cuda and coo answers differ")
    return cuda["results"], cuda["launches"], cuda["rows"], cuda["tables"]


def keyword_queries(rng, count: int, maxk: int) -> np.ndarray:
    """count queries of 2 or 3 distinct keywords among the 30 most frequent
    token ids (the paper's K_30 selection), padded with -1."""
    out = np.full((count, maxk), -1, np.int32)
    for i in range(count):
        k = 2 + i % 2
        out[i, :k] = rng.choice(30, k, replace=False)
    return out


def app_terrain(keep: dict):
    """Terrain through both plans; ``keep`` receives the graph, coords,
    pairs, cuda answers and tables that phase 6 reuses."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.apps.terrain import euclidean, make_terrain_engine
    from repro_torch.core.graph import grid_terrain

    (g, coords), dt = sync_time(
        lambda: grid_terrain(TERRAIN_SIDE, TERRAIN_SIDE, eps_subdiv=2, seed=0, device="cuda"))
    print(f"phase 5 terrain: grid_terrain({TERRAIN_SIDE}, {TERRAIN_SIDE}, eps_subdiv=2): "
          f"{g.n} vertices, "
          f"{g.num_edges} edges, float32 weights, in {dt:.2f} s; C={APPS_C}, "
          f"steps_per_round={TERRAIN_K}", flush=True)
    pairs = np.random.default_rng(1).integers(0, g.n_real, (64, 2)).astype(np.int32)
    make = lambda b: make_terrain_engine(g, coords, capacity=APPS_C, backend=b,
                                         steps_per_round=TERRAIN_K)
    res, launches, rows, tables = both_plans("terrain", make, pairs)
    keep.update(g=g.to("cpu"), coords=coords, pairs=pairs, results=res,
                tables=tables_to(tables, "cpu"))
    src, dst, w = g._edges_np()
    want = dijkstra(csr_matrix((w, (src, dst)), shape=(g.n, g.n)),
                    indices=pairs[:8, 0].astype(np.int64))
    for q, (s, t) in enumerate(pairs[:8]):
        got = float(res[q]["dist"])
        if not np.isclose(got, want[q, t], rtol=1e-4, atol=0.0):
            fail(f"terrain d({s},{t}) = {got!r}, Dijkstra says {want[q, t]!r}")
    # the Euclidean distances the early-termination test reads: the port's
    # are the same on the card as on the host (where they equal XLA's)
    tc, src8 = torch.from_numpy(coords), torch.from_numpy(pairs[:8, 0].astype(np.int64))
    if not torch.equal(euclidean(tc.cuda(), src8.cuda()).cpu(), euclidean(tc, src8)):
        fail("terrain: the Euclidean distances differ between the card and the host")
    differ = sum(int((torch.linalg.vector_norm(tc.cuda() - tc.cuda()[int(s)], dim=-1).cpu()
                      != torch.linalg.vector_norm(tc - tc[int(s)], dim=-1)).sum())
                 for s in src8)
    print(f"  terrain: cuda == coo on all 64 answers; 8 match scipy Dijkstra to rtol 1e-4; "
          f"the Euclidean distances equal the host's; torch.linalg.vector_norm on the card "
          f"differs from the host's in {differ} of {8 * g.n} float32 values", flush=True)
    return launches, rows


def app_keyword(g):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.apps.keyword import MAXK, make_keyword_engine, make_vertex_text
    from repro_torch.core.semiring import INF

    tokens, dt = sync_time(lambda: make_vertex_text(g.n_real, 10_000, 4, seed=2))
    print(f"phase 5 keyword: the main path's graph ({g.n} vertices, {g.num_edges} edges), "
          f"make_vertex_text(vocab=10000, 4 tokens) in {dt:.2f} s; delta_max=3, "
          f"C={APPS_C} ({MAXK * APPS_C} lanes a propagate)", flush=True)
    queries = keyword_queries(np.random.default_rng(3), 64, MAXK)
    make = lambda b: make_keyword_engine(g, tokens, capacity=APPS_C, delta_max=3, backend=b)
    res, launches, rows, _ = both_plans("keyword", make, queries)
    src, dst, _ = g._edges_np()
    rev = csr_matrix((np.ones(len(src)), (dst, src)), shape=(g.n, g.n))
    for q, kws in enumerate(queries[:8]):
        hops = []
        for k in kws[kws >= 0]:
            hits = np.nonzero((tokens == k).any(1))[0]
            hops.append(dijkstra(rev, indices=hits, min_only=True, unweighted=True, limit=3)
                        if len(hits) else np.full(g.n, np.inf))
        hops = np.stack(hops)
        root = np.isfinite(hops).all(0)
        total = np.where(root, np.where(root, hops, 0).sum(0), INF).astype(np.int64)
        order = np.argsort(total, kind="stable")[:16]
        r = res[q]
        if (int(r["num_roots"]) != int(root.sum())
                or not np.array_equal(r["top_roots"], order)
                or not np.array_equal(r["top_scores"], total[order])):
            fail(f"keyword query {kws}: {r} differs from the oracle ({int(root.sum())} "
                 f"roots, {order}, {total[order]})")
    print("  keyword: cuda == coo on all 64 answers; 8 match a multi-source Dijkstra "
          "(num_roots, top roots, top scores)", flush=True)
    return launches, rows


def app_reach(keep: dict):
    """Reach through both plans; ``keep`` receives the DAG, its index, the
    condensed pairs and the cuda answers that phase 9 reuses."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import breadth_first_order

    from repro_torch.apps.reach import build_reach_index, make_reach_engine, scc_condense
    from repro_torch.core.graph import random_dag

    g0, dt = sync_time(lambda: random_dag(MAIN_N, 2.5, seed=0, device="cuda"))
    (comp, dag), scc_s = sync_time(lambda: scc_condense(g0))
    if dag.n_real != g0.n_real:
        fail(f"random_dag: {dag.n_real} SCCs for {g0.n_real} vertices")
    idx, idx_s = sync_time(lambda: build_reach_index(dag))
    print(f"phase 5 reach: random_dag({MAIN_N}, 2.5): {g0.num_edges} edges in {dt:.2f} s; "
          f"scc_condense {scc_s:.2f} s ({dag.n_real} singleton SCCs); build_reach_index "
          f"{idx_s:.2f} s (longest path {int(idx.level.max())}); C={APPS_C}", flush=True)
    src, dst, _ = g0._edges_np()
    adj = csr_matrix((np.ones(len(src)), (src, dst)), shape=(g0.n, g0.n))
    reached = lambda s: breadth_first_order(adj, int(s), return_predecessors=False)
    # 256 uniform pairs (almost none reachable on this DAG) and 64 pairs whose
    # t a host BFS from s reaches, which the labels and the BiBFS must find
    rng = np.random.default_rng(1)
    pairs0 = [tuple(p) for p in rng.integers(0, g0.n_real, (256, 2))]
    while len(pairs0) < 320:
        s = int(rng.integers(g0.n_real))
        out = reached(s)[1:]
        if len(out):
            pairs0.append((s, int(out[rng.integers(len(out))])))
    pairs0 = np.asarray(pairs0)
    pairs = comp[pairs0].astype(np.int32)
    make = lambda b: make_reach_engine(dag, idx, capacity=APPS_C, backend=b)
    res, launches, rows, _ = both_plans("reach", make, pairs)
    keep.update(dag=dag.to("cpu"), index=idx.to("cpu"), pairs=pairs, results=res)
    for q, (s, t) in enumerate(pairs0):
        want = bool(np.isin(t, reached(s)))
        if bool(res[q]["reach"]) != want:
            fail(f"reach({s},{t}) = {bool(res[q]['reach'])}, BFS says {want}")
    hits = sum(bool(r["reach"]) for r in res.values())
    print(f"  reach: cuda == coo on all {len(pairs)} answers ({hits} reachable), and all "
          "match breadth_first_order from s on the uncondensed graph", flush=True)
    return launches, rows


def xml_oracle(parent: np.ndarray, level: np.ndarray, tokens: np.ndarray, kws):
    """SLCA, ELCA and MaxMatch masks, bottom-up and top-down level by level
    (the tests/test_xmlkw.py oracles in numpy)."""
    n = len(parent)
    own = np.zeros(n, np.int64)
    for i, k in enumerate(kws):
        own |= (tokens[:n] == k).any(1).astype(np.int64) << i
    kid = np.nonzero(parent >= 0)[0]
    K = own.copy()
    for lvl in range(int(level.max()), 0, -1):
        vs = np.nonzero(level == lvl)[0]
        np.bitwise_or.at(K, parent[vs], K[vs])
    full = (1 << len(kws)) - 1
    cover = K == full
    covered_kid = np.zeros(n, bool)
    covered_kid[parent[kid[cover[kid]]]] = True
    slca = cover & ~covered_kid
    acc = own.copy()
    part = kid[K[kid] != full]
    np.bitwise_or.at(acc, parent[part], K[part])
    elca = acc == full
    present = np.zeros(n, np.int64)  # the bitmap values among each vertex's children
    np.bitwise_or.at(present, parent[kid], np.int64(1) << K[kid])
    sib = present[np.maximum(parent, 0)]
    dominated = np.zeros(n, bool)
    for b in range(full + 1):
        dominated |= ((K & b) == K) & (K != b) & ((sib >> b) & 1).astype(bool)
    dominated &= parent >= 0
    kept = slca.copy()
    for lvl in range(1, int(level.max()) + 1):
        vs = np.nonzero(level == lvl)[0]
        kept[vs] |= kept[parent[vs]] & ~dominated[vs]
    return dict(slca=slca, elca=elca, labeled=kept)


def app_xml():
    from repro_torch.apps import xmlkw
    from repro_torch.apps.keyword import make_vertex_text
    from repro_torch.core.graph import random_tree

    (tree, parent), dt = sync_time(
        lambda: random_tree(MAIN_N, max_fanout=8, seed=0, device="cuda"))
    tokens = make_vertex_text(MAIN_N, 10_000, 4, seed=1)
    idx, idx_s = sync_time(lambda: xmlkw.build_xml_index(parent, tokens, tree.n,
                                                         device="cuda"))
    level = idx.level.cpu().numpy()[:MAIN_N]
    print(f"phase 5 xml: random_tree({MAIN_N}, 8) in {dt:.2f} s (depth {int(level.max())}); "
          f"build_xml_index {idx_s:.2f} s; C={APPS_C}", flush=True)
    queries = keyword_queries(np.random.default_rng(4), 32, xmlkw.MAXK)
    launches, rows = 0, []
    for name, path, keys in (("SLCANaive", "slca_naive", ("slca",)),
                             ("SLCALevelAligned", "slca_level_aligned", ("slca", "elca")),
                             ("MaxMatch", "maxmatch", ("labeled",))):
        cls = getattr(xmlkw, name)
        make = lambda b: xmlkw.make_xml_engine(cls, tree, idx, capacity=APPS_C, backend=b)
        res, n, r, _ = both_plans(path, make, queries)
        launches += n
        rows += r
        for q, kws in enumerate(queries[:4]):
            want = xml_oracle(parent, level, tokens, [int(k) for k in kws if k >= 0])
            for key in keys:
                if not np.array_equal(np.asarray(res[q][key])[:MAIN_N], want[key]):
                    fail(f"{name} query {kws}: {key} differs from the oracle")
        print(f"  {name}: cuda == coo on all 32 answers; 4 match the oracle "
              f"({', '.join(keys)})", flush=True)
    return launches, rows


def phase_apps(g_main):
    """Phase 5: each query class through cuda and coo, checked.  Returns
    (launches, path rows, the terrain data phase 6 reuses, the reach data
    phase 9 reuses)."""
    t0 = time.perf_counter()
    launches, rows, terrain, reach = 0, [], {}, {}
    for app in (lambda: app_terrain(terrain), lambda: app_keyword(g_main),
                lambda: app_reach(reach), app_xml):
        t = time.perf_counter()
        n, r = app()
        launches += n
        rows += r
        print(f"  {time.perf_counter() - t:.1f} s", flush=True)
    print(f"phase 5: {launches} kernel launches in the cuda runs; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, rows, terrain, reach


# ------------------------------------------------------------ phase 6
FT_C = 8              # QuegelConfig.capacity
SNAPSHOT_EVERY = 4    # journal snapshot cadence of 6d, in rounds
CRASH_SEEDS = 1       # 6f's --seeds (2 took 83 s of phase 6's 122 s on the card)
MIN_FREE_DISK = 4e9   # the Hub2 index alone is 1.31 GB on disk


def same_tree(a, b) -> bool:
    """Dataclasses, dicts and tensors equal leaf by leaf (torch.equal on
    the same device and dtype), other leaves by ==."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            same_tree(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    return a == b


def bibfs_engine(g, rev, tables, **kw):
    """A BiBFS engine on the card over prebuilt packed tables: it builds none."""
    from repro_torch.apps.ppsp import BiBFSProgram
    from repro_torch.core.engine import QuegelEngine

    return QuegelEngine(g, BiBFSProgram(), FT_C, backend="cuda",
                        blocks=tables["default"], aux_graphs={"rev": (rev, tables["rev"])},
                        example_query=np.zeros(2, np.int32), **kw)


def counted(path: str, run, paths: list):
    """Drive one cuda path with the kernel's counts set to 0 just before and
    read just after; fails unless it launched the kernel.  Returns what
    ``run`` returned and the path's launches."""
    take_counts()
    out = run()
    torch.cuda.synchronize()
    n, shapes, gates = take_counts()
    if n == 0:
        fail(f"{path}: the cuda run never launched the kernel")
    paths.extend(path_rows(path, shapes))
    path_gates(path, gates)
    return out, n


def no_launch(what: str, run):
    """Run a coo path, failing if it launched the kernel."""
    take_counts()
    out = run()
    if take_counts()[0]:
        fail(f"{what}: the coo plan launched the kernel")
    return out


def drain(eng, queries, each_round=None):
    """Submit, then run round by round until idle, calling
    ``each_round(runtime, round index)`` after each round; returns the
    retirement order."""
    for q in queries:
        eng.submit(q)
    return drain_submitted(eng, each_round)


def drain_submitted(eng, each_round=None) -> list:
    rt, order, r = eng.runtime, [], 0
    while rt.pending() or rt.live.any():
        order += [qid for qid, _, _ in rt.run_round() or []]
        if each_round is not None:
            each_round(rt, r)
        r += 1
    return order


def ft_store(tmp, g, pairs, main, paths):
    """6a: save the main graph, its rev view, the BiBFS engine's packed
    tables and the Hub2 index; load them; boot an engine from them."""
    from repro_torch.apps.hub2 import load_or_build_hub_index
    from repro_torch.configs.quegel import QuegelConfig
    from repro_torch.core.store import Store, load_engine_store, save_engine_store
    from repro_torch.kernels import ops
    from repro_torch.launch.supervise import _result_map

    store = Store(os.path.join(tmp, "store"))
    put = dict(graph=g, index=main["hub_index"], aux_graphs={"rev": main["rev"]},
               tables=main["tables"])
    _, put_s = sync_time(lambda: save_engine_store(store, g, **{
        k: v for k, v in put.items() if k != "graph"}))
    nbytes = sum(f.stat().st_size for f in Path(store.root).rglob("*") if f.is_file())
    state, get_s = sync_time(lambda: load_engine_store(store, device="cuda"))
    for name, want in put.items():
        if not same_tree(state[name], want):
            fail(f"6a: the loaded {name} differs from what was put")
    for got, want in ((state["graph"], g), (state["aux_graphs"]["rev"], main["rev"])):
        if got.content_hash() != want.content_hash():
            fail("6a: a loaded graph's content_hash differs")
    builds = [0]
    orig = ops.CudaBackend._build

    def build(self, sr, graph):
        builds[0] += 1
        return orig(self, sr, graph)

    ops.CudaBackend._build = build
    try:
        eng = bibfs_engine(state["graph"], state["aux_graphs"]["rev"], state["tables"])
        counted("ft_store_boot", lambda: drain(eng, pairs), paths)
    finally:
        ops.CudaBackend._build = orig
    if builds[0] or _result_map(eng) != main["bibfs_map"]:
        fail(f"6a: the booted engine built {builds[0]} tables or answered otherwise")
    check_launches("ft_store_boot", lambda: drain(
        bibfs_engine(state["graph"], state["aux_graphs"]["rev"], state["tables"]), pairs),
        path_keys(paths, "ft_store_boot"))
    cfg = QuegelConfig()
    (idx, info), hit_s = sync_time(lambda: load_or_build_hub_index(
        store, g, cfg.hub_k, capacity=cfg.capacity, backend="cuda", device="cuda"))
    if info["built"] or info["index_rounds"] != 0 or not same_tree(idx, main["hub_index"]):
        fail(f"6a: load_or_build_hub_index rebuilt or differs: {info}")
    print(f"  6a store: {nbytes} bytes written in {put_s:.3f} s (put), loaded in "
          f"{get_s:.3f} s (get), every array and content_hash equal; the booted engine "
          f"built 0 tables and answered the {len(pairs)} pairs as phase 3; "
          f"load_or_build_hub_index built=False, index_rounds=0 in {hit_s:.3f} s, index "
          f"equal; phase 3's cuda Hub2 build {main['build_s']:.3f} s", flush=True)
    return store


def ft_suspend(g, pairs, main, paths) -> None:
    """6b: every live slot suspended at every round boundary."""
    from repro_torch.launch.supervise import _result_map

    def suspending(tally):
        def suspend_all(rt, r):
            live = [s for s in range(rt.capacity) if rt.live[s]]
            if live:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rt.suspend(live)  # ends in the device->host copy
                tally["s"] += time.perf_counter() - t0
                tally["n"] += len(live)
                tally["calls"] += 1
        return suspend_all

    tally = dict(n=0, calls=0, s=0.0)
    eng = bibfs_engine(g, main["rev"], main["tables"])
    (_, wall) = sync_time(lambda: counted(
        "ft_suspend", lambda: drain(eng, pairs, suspending(tally)), paths))
    if _result_map(eng) != main["bibfs_map"]:
        fail("6b: suspended results, statuses or steps differ from phase 3's")
    if eng.stats.preemptions != tally["n"] or eng.stats.resumes != tally["n"]:
        fail(f"6b: {tally['n']} suspensions but {eng.stats.resumes} resumes")
    row_bytes = sum(t[0].numel() * t.element_size() for t in eng._slots["state"].values())
    check_launches("ft_suspend", lambda: drain(
        bibfs_engine(g, main["rev"], main["tables"]), pairs,
        suspending(dict(n=0, calls=0, s=0.0))), path_keys(paths, "ft_suspend"))
    print(f"  6b suspend: {tally['n']} suspensions in {tally['calls']} calls over "
          f"{eng.stats.rounds} rounds, payload {row_bytes} bytes per slot, "
          f"{1e3 * tally['s'] / tally['calls']:.3f} ms per suspend call "
          f"({1e3 * tally['s'] / tally['n']:.3f} ms per slot), wall {wall:.3f} s; results, "
          f"statuses and steps identical to phase 3's", flush=True)


def terrain_preempt_pairs(side: int, rng):
    """8 heavy pairs (s on the mesh's left column, t on its right column)
    and 16 light ones (t within 8 vertices of s along each axis)."""
    rows = rng.integers(0, side, (8, 2))
    heavy = np.stack([rows[:, 0] * side, rows[:, 1] * side + side - 1], 1)
    s = rng.integers(0, side, (16, 2))
    t = np.clip(s + rng.integers(-8, 9, (16, 2)), 0, side - 1)
    light = np.stack([s[:, 0] * side + s[:, 1], t[:, 0] * side + t[:, 1]], 1)
    return heavy.astype(np.int32), light.astype(np.int32)


def ft_preempt(terrain, paths) -> None:
    """6c: lights arrive a round after a convoy of heavies, sjf with and
    without preemption."""
    from repro_torch.apps.terrain import make_terrain_engine
    from repro_torch.launch.supervise import _result_map

    side = TERRAIN_SIDE * 2 - 1
    heavy, light = terrain_preempt_pairs(side, np.random.default_rng(6))

    def run(preemptive: bool):
        eng = make_terrain_engine(terrain["g"], terrain["coords"], capacity=FT_C,
                                  backend="cuda", steps_per_round=TERRAIN_K,
                                  blocks=terrain["tables"]["default"], scheduler="sjf",
                                  preemptive=preemptive)
        for p in heavy:
            eng.submit(p, budget=4096)
        order = [qid for qid, _, _ in eng.runtime.run_round() or []]
        for p in light:
            eng.submit(p, budget=256)
        order += drain_submitted(eng)
        return eng, order

    runs = {}
    for preemptive, path in ((True, "ft_preempt"), (False, "ft_no_preempt")):
        (eng, order), wall = sync_time(lambda: counted(path, lambda: run(preemptive),
                                                       paths)[0])
        runs[preemptive] = (eng, order, wall)
        check_launches(path, lambda: run(preemptive), path_keys(paths, path))
    (pe, po, pw), (ne, no, nw) = runs[True], runs[False]
    heavy_q, light_q = set(range(8)), set(range(8, 24))
    last_light = max(po.index(q) for q in light_q)
    if last_light > min(po.index(q) for q in heavy_q):
        fail(f"6c: a heavy retired before a light under preemption: {po}")
    if pe.stats.preemptions < 1 or pe.stats.max_inflight <= FT_C:
        fail(f"6c: preemptions {pe.stats.preemptions}, max_inflight {pe.stats.max_inflight}")
    if _result_map(pe) != _result_map(ne):
        fail("6c: preemptive and non-preemptive results, statuses or steps differ")
    rank = lambda order, qs: sorted(order.index(q) for q in qs)
    print(f"  6c preempt: terrain {side} x {side}, sjf, C={FT_C}, k={TERRAIN_K}; "
          f"preemptive: light ranks {rank(po, light_q)}, heavy ranks {rank(po, heavy_q)}, "
          f"{pe.stats.preemptions} preemptions, {pe.stats.resumes} resumes, max_inflight "
          f"{pe.stats.max_inflight}, {pe.stats.rounds} rounds, wall {pw:.3f} s; "
          f"without: light ranks {rank(no, light_q)}, heavy ranks {rank(no, heavy_q)}, "
          f"{ne.stats.rounds} rounds, wall {nw:.3f} s; results, statuses and steps "
          f"identical (heavy steps {[pe.runtime.steps[q] for q in sorted(heavy_q)]})",
          flush=True)


def ft_recover(tmp, store, pairs, main, paths) -> None:
    """6d: two injected crashes, recovered from the fsynced journal, each
    boot from 6a's store."""
    from repro_torch.launch.supervise import _result_map, run_with_recovery
    from repro_torch.train.fault import FailureInjector

    def supervised(jpath, boots, snaps):
        def boot():
            t0 = time.perf_counter()
            graph = store.get("graph", device="cuda")
            eng = bibfs_engine(graph, store.get("aux_graphs", device="cuda")["rev"],
                               store.get("tables", device="cuda"))
            torch.cuda.synchronize()
            boots.append(time.perf_counter() - t0)
            snapshot = eng.runtime.snapshot

            def timed_snapshot():
                torch.cuda.synchronize()
                t = time.perf_counter()
                n = snapshot()
                snaps.append(time.perf_counter() - t)
                return n

            eng.runtime.snapshot = timed_snapshot
            return eng

        return run_with_recovery(boot, jpath, list(pairs), snapshot_every=SNAPSHOT_EVERY,
                                 fsync=True, injector=FailureInjector(fail_at_steps={5, 17}))

    jpath, boots, snaps = os.path.join(tmp, "journal.wal"), [], []
    ((eng, info), wall) = sync_time(lambda: counted(
        "ft_recover", lambda: supervised(jpath, boots, snaps), paths)[0])
    if _result_map(eng) != main["bibfs_map"]:
        fail("6d: the recovered result map differs from phase 3's uninterrupted one")
    if info["restarts"] != 2 or info["resumed_from_snapshot"] < 1:
        fail(f"6d: {info}")
    size = os.path.getsize(jpath)
    with open(jpath, "rb") as f:
        records = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 24), b""))
    check_launches("ft_recover", lambda: supervised(os.path.join(tmp, "journal2.wal"), [], []),
                   path_keys(paths, "ft_recover"))
    print(f"  6d recover: restarts {info['restarts']}, journal {size} bytes, {records} "
          f"records, {len(snaps)} snapshots at {statistics.mean(snaps):.4f} s each "
          f"(max {max(snaps):.4f} s), boots {', '.join(f'{b:.3f}' for b in boots)} s, last "
          f"recovery replayed {info['replayed_done']}, resumed "
          f"{info['resumed_from_snapshot']} from a snapshot, resubmitted "
          f"{info['resubmitted']}; wall {wall:.3f} s; result map identical to phase 3's",
          flush=True)


def ft_poison(terrain, paths) -> None:
    """6e: qid 3's slot state poisoned with NaN at every round."""
    from repro_torch.apps.terrain import make_terrain_engine
    from repro_torch.core.runtime import DONE, POISONED
    from repro_torch.train.fault import FailureInjector

    eng = make_terrain_engine(terrain["g"], terrain["coords"], capacity=FT_C,
                              backend="cuda", steps_per_round=TERRAIN_K,
                              blocks=terrain["tables"]["default"])
    inj = FailureInjector(poison_qids={3})
    # not held against the plain version: the poisoned lanes are NaN, and
    # the kernel's and scatter_reduce's NaN outputs need not agree
    counted("ft_poison", lambda: drain(eng, terrain["pairs"][:8],
                                       lambda rt, r: inj.check(r, engine=eng)), paths)
    st = eng.runtime.status
    if st[3] != POISONED or any(st[q] != DONE for q in range(8) if q != 3):
        fail(f"6e: statuses {st}")
    for q in range(8):
        if q != 3 and not same_results({q: eng.runtime.results[q]},
                                       {q: terrain["results"][q]}):
            fail(f"6e: qid {q} differs from phase 5's answer")
    print(f"  6e poison: qid 3 POISONED after {eng.stats.poison_retries} retries "
          f"({len(inj.poison_events)} poisonings), the other 7 DONE and equal to phase "
          f"5's answers", flush=True)


def ft_sigkill(tmp) -> None:
    """6f: the supervisor CLI SIGKILLs its children on the card."""
    cmd = [sys.executable, "-m", "repro_torch.launch.supervise", "--crash-test",
           "--seeds", str(CRASH_SEEDS), "--queries", "6", "--snapshot-every", "2",
           "--out", os.path.join(tmp, "crash"), "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p, wall = sync_time(lambda: subprocess.run(cmd, capture_output=True, text=True,
                                               env=env, timeout=600))
    for line in p.stdout.strip().splitlines():
        print(f"    {line}", flush=True)
    if p.returncode != 0 or "recovered ≡ uninterrupted" not in p.stdout:
        fail(f"6f: crash-test rc={p.returncode}\n{p.stderr[-3000:]}")
    print(f"  6f SIGKILL: crash-test rc 0 on cuda, {CRASH_SEEDS} seed(s), {wall:.1f} s "
          "(the children's rc=-9 lines are the kills)", flush=True)


def phase_fault_tolerance(g, pairs, main, terrain, tmp):
    """Phase 6: store, suspend, preempt, recover, poison and SIGKILL on the
    card, reusing phase 3's graph, rev view, pairs, tables, Hub2 index and
    answers and phase 5's terrain data, in the temp dir ``tmp`` (which
    keeps 6a's store for phase 7).  Returns (launches, path rows, the
    store)."""
    t0 = time.perf_counter()
    main = dict(main, rev=main["rev"].to("cuda"), hub_index=main["hub_index"].to("cuda"),
                tables=tables_to(main["tables"], "cuda"))
    terrain = dict(terrain, g=terrain["g"].to("cuda"),
                   tables=tables_to(terrain["tables"], "cuda"))
    torch.cuda.synchronize()
    print(f"phase 6: phase 3's Hub2 index, rev view and tables and phase 5's terrain "
          f"graph and table moved back to the card in {time.perf_counter() - t0:.3f} s",
          flush=True)
    paths = []
    free = shutil.disk_usage(tmp).free
    print(f"phase 6: temp dir free space {free} bytes", flush=True)
    if free < MIN_FREE_DISK:
        fail(f"6a: {free} bytes free in {tmp}, under the {MIN_FREE_DISK:.0f} the "
             "store and journals need")
    store = ft_store(tmp, g, pairs, main, paths)
    ft_suspend(g, pairs, main, paths)
    ft_preempt(terrain, paths)
    ft_recover(tmp, store, pairs, main, paths)
    ft_poison(terrain, paths)
    ft_sigkill(tmp)
    launches = sum(r["launches"] for r in paths)
    print(f"phase 6: {launches} kernel launches in the cuda runs; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, paths, store


# ------------------------------------------------------------ phase 7
MUT_DELTAS = 6         # in-capacity deltas of 7a and 7b (depth cut to fit phase 9)
MUT_PAIRS = 64         # added and deleted undirected pairs per delta (x2 directions)
MUT_HEADROOM = 4096    # 7a's edge capacity over |E|, per view
MUT_OVERFLOW = 2500    # undirected pairs of 7a's overflowing delta (5,000 edges)
MUT_REBUILD = 8192     # undirected pairs of 7b's delta past the 1 % threshold
MUT_FRESH = 32         # fresh pairs answered after each delta
MUT_BFS = 4            # of them checked against a host BFS
GATHER_EDGES = 65536   # the gated COO chunk of phases 4 and 7d


def undirected_delta(g, rng, n_add: int, n_del: int):
    """A validated delta on the undirected graph ``g``: ``n_add`` absent
    pairs added and ``n_del`` present ones deleted, each in both
    directions."""
    s, d, _ = g._edges_np()
    n = g.n
    keys = np.sort(s.astype(np.int64) * n + d)
    adds = set()
    while len(adds) < n_add:
        u, v = (int(x) for x in rng.integers(0, g.n_real, 2))
        a, b = min(u, v), max(u, v)
        k = np.searchsorted(keys, a * n + b)
        if a != b and (a, b) not in adds and not (k < len(keys) and keys[k] == a * n + b):
            adds.add((a, b))
    dels = set()
    while len(dels) < n_del:
        i = int(rng.integers(len(s)))
        a, b = int(s[i]), int(d[i])
        if a < b:
            dels.add((a, b))
    both = lambda pairs: (np.concatenate([pairs, pairs[:, ::-1]]) if len(pairs)
                          else np.zeros((0, 2), np.int32))
    a_ = np.asarray(sorted(adds), np.int32).reshape(-1, 2)
    d_ = np.asarray(sorted(dels), np.int32).reshape(-1, 2)
    return g.make_delta(both(a_), both(d_))


def same_packed(a, b) -> bool:
    return all((getattr(a, f) is None) == (getattr(b, f) is None)
               and (getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f)))
               for f in ("src_ids", "nslots", "row_ptr", "entries", "w"))


def new_rows(paths: list, before: int) -> set:
    """The (semiring, dtype, Q) keys of the path rows added since ``before``."""
    return {(r["semiring"], r["dtype"], r["q"]) for r in paths[before:]}


def mut_bibfs(g, pairs, main, paths) -> dict:
    """7a: BiBFS on cuda with arg-carried editions under 6 deltas, 8
    queries in flight at the first; then one overflowing delta."""
    from repro_torch.apps.ppsp import BiBFSProgram, make_bibfs_engine
    from repro_torch.core.engine import QuegelEngine
    from repro_torch.core.semiring import MIN_RIGHT

    E = g.num_edges
    eng = QuegelEngine(g, BiBFSProgram(), FT_C, backend="cuda", blocks=main["tables"]["default"],
                       aux_graphs={"rev": (main["rev"], main["tables"]["rev"])},
                       example_query=np.zeros(2, np.int32), arg_carried=True,
                       edge_capacity=E + MUT_HEADROOM, result_cache=4096)
    rng = np.random.default_rng(7)
    inflight = [eng.submit(p) for p in pairs[:FT_C]]
    counted("mut_bibfs", lambda: eng.run_round(), paths)
    live0 = int(eng.runtime.live.sum())
    deltas, fresh_log = [], []

    def step(delta, i, label):
        info = eng.apply_delta(delta)
        fresh = rng.integers(0, g.n_real, (MUT_FRESH, 2)).astype(np.int32)
        qids = [eng.submit(p) for p in fresh]
        before = len(paths)
        counted("mut_bibfs", lambda: drain_submitted(eng), paths)
        check_launches("mut_bibfs", lambda: drain(eng, [p[::-1].copy() for p in fresh]),
                       new_rows(paths, before))
        got = {j: eng.runtime.results[q] for j, q in enumerate(qids)}
        ref_eng = make_bibfs_engine(eng.graph, capacity=FT_C, backend="coo")
        for p in fresh:
            ref_eng.submit(p)
        if not same_results(got, ref_eng.run_until_drained()):
            fail(f"7a {label}: the cuda answers differ from a fresh coo engine's")
        for j, (s, t) in enumerate(fresh[:MUT_BFS]):
            d = host_bfs(eng.graph, int(s))[int(t)]
            if int(got[j]["dist"]) != (d if d >= 0 else 2**30):
                fail(f"7a {label}: d({s},{t}) = {int(got[j]['dist'])}, host BFS says {d}")
        full_s = []
        for view, gv in (("default", eng.graph), ("rev", eng.aux_graphs["rev"])):
            (want, dt) = sync_time(lambda: gv.to_packed_blocks(128, MIN_RIGHT))
            full_s.append(dt)
            if not same_packed(eng._backends[view].tables["min_right"], want):
                fail(f"7a {label}: the spliced {view} table differs from to_packed_blocks")
        ms = info["ms"]
        print(f"  7a {label}: {delta.size} edges (both views), version {info['version']}; "
              f"host splice {ms['splice']:.3f} ms, upload {ms['upload']:.3f} ms, table "
              f"splice {ms['tables']:.3f} ms (2 views) against full to_packed_blocks "
              f"{1e3 * sum(full_s):.3f} ms, finish (padding, table upload, work items) "
              f"{ms['finish']:.3f} ms, content_hash {ms['hash']:.3f} ms, cache invalidation "
              f"{ms['invalidate']:.4f} ms ({info['cache_invalidated']} dropped); "
              f"shape_changes {eng.stats.shape_changes}", flush=True)
        fresh_log.append((fresh, got))
        return info

    for i in range(MUT_DELTAS):
        delta = undirected_delta(eng.graph, rng, MUT_PAIRS, MUT_PAIRS)
        deltas.append(delta)
        step(delta, i, f"delta {i + 1}")
        if i == 0:
            for j, q in enumerate(inflight):
                if not same_results({0: eng.runtime.results[q]}, {0: main["bibfs"][j]}):
                    fail(f"7a: in-flight query {q} did not answer on version 0")
    if eng.stats.shape_changes or eng.shape_counts != {0: 1}:
        fail(f"7a: in-capacity deltas changed shapes: {eng.shape_counts}")
    big = undirected_delta(eng.graph, rng, MUT_OVERFLOW, 0)
    step(big, MUT_DELTAS, "overflow")
    if eng.stats.shape_changes != 1:
        fail(f"7a: the overflowing delta changed shapes {eng.stats.shape_changes} times")
    print(f"  7a: {live0} of {FT_C} queries in flight at delta 1 answered on version 0 "
          f"as phase 3; after every delta {MUT_FRESH} fresh answers == a fresh coo engine "
          f"({MUT_BFS} == host BFS), both spliced tables == to_packed_blocks; "
          f"shape_changes 0 over {MUT_DELTAS} deltas, 1 at the overflow (capacity "
          f"{eng._view_caps['default']} edges)", flush=True)
    return dict(deltas=deltas, fresh=fresh_log[:MUT_DELTAS], graph=eng.graph)


def subset_delete(graph, hub_dist):
    """A delete of one undirected edge of ``graph`` (both directions),
    chosen on the host from the current (k, V) ``hub_dist``, that
    ``affected_hubs`` names for some hub rows but not all: the first of
    1,024 sampled edges (default_rng(11)) whose endpoints' labels differ
    by exactly one in between 1 and k - 1 rows (a deleted (u, v) affects
    hub h iff d_h[u] + 1 == d_h[v], in either direction).  Returns (the
    delta, (u, v), the number of rows it names)."""
    s, d, _ = graph._edges_np()
    pick = np.random.default_rng(11).choice(len(s), min(1024, len(s)), replace=False)
    pick = pick[s[pick] < d[pick]]
    u, v = s[pick], d[pick]
    col = lambda a: hub_dist[:, torch.as_tensor(a, device=hub_dist.device).long()]
    named = (np.abs(col(u).cpu().numpy().astype(np.int64)
                    - col(v).cpu().numpy().astype(np.int64)) == 1).sum(0)
    ok = np.nonzero((named > 0) & (named < hub_dist.shape[0]))[0]
    if not len(ok):
        fail(f"7b: none of {len(pick)} sampled edges names a strict subset of the hubs")
    j = ok[0]
    a, b = int(u[j]), int(v[j])
    return (graph.make_delta(np.zeros((0, 2), np.int32), np.asarray([[a, b], [b, a]], np.int32)),
            (a, b), int(named[j]))


def mut_hub2(g, main, mut, paths) -> None:
    """7b: the Hub2 engine through the same deltas, its index maintained on
    the card; then a delta past the 1 % threshold.  Each maintained index
    is held against every row re-labeled through the coo plan and, on
    MUT_BFS sampled affected rows, against a host loop that shares no code
    with the port; and at every delta against the engine's pinned build (a
    Quegel job of k queries, ~3-5 s each: through cuda at the first and
    last delta, through coo between them)."""
    from repro_torch.apps.hub2 import (HubIndex, Hub2PPSP, _relabel_hubs, affected_hubs,
                                       build_hub_index, hub_index_updater,
                                       maintain_hub_index)
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.core.engine import QuegelEngine
    from repro_torch.core.semiring import INF
    from repro_torch.kernels import ops

    upd = hub_index_updater(backend="cuda")
    eng = QuegelEngine(g, Hub2PPSP(), FT_C, index=main["hub_index"], index_fn=upd,
                       backend="cuda", blocks=main["tables"]["default"],
                       aux_graphs={"rev": (main["rev"], main["tables"]["rev"])},
                       example_query=np.zeros(2, np.int32))
    hubs = main["hub_index"].hub_ids.cpu().numpy()
    is_hub_np = main["hub_index"].is_hub.cpu().numpy()
    k = len(hubs)
    rng = np.random.default_rng(9)

    def same_index(a, b) -> bool:
        return all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("hub_ids", "is_hub", "hub_dist", "core"))

    def pinned(graph):
        """The index rebuilt on ``graph`` with the hub set pinned: every
        row re-labeled through the coo plan (no table, no kernel)."""
        plan = ops.make_backend("coo", graph)
        idx0 = eng.index
        dist, pre = _relabel_hubs(plan, idx0.is_hub, idx0.hub_ids, np.arange(k))
        return HubIndex(idx0.hub_ids, idx0.is_hub, dist,
                        (dist < INF) & (~pre | idx0.is_hub[None, :]))

    def absorb(label, delta, fresh, want):
        """Apply ``delta`` through the engine (its index maintained on the
        card) and check the indexed answers of ``fresh`` against ``want``,
        the relabel's launches against the plain version, the index against
        a pinned rebuild and sampled rows against the host loop.  Returns
        (info, wall s, the affected rows, the sampled rows)."""
        old = eng.index
        rows = affected_hubs(old, delta)
        before = len(paths)
        info, wall = sync_time(lambda: counted("mut_hub2", lambda: eng.apply_delta(delta),
                                               paths)[0])
        qids = [eng.submit(p) for p in fresh]
        counted("mut_hub2", lambda: drain_submitted(eng), paths)
        got = {j: eng.runtime.results[q] for j, q in enumerate(qids)}
        if any(int(got[j]["dist"]) != int(want[j]["dist"]) for j in got):
            fail(f"7b {label}: indexed answers differ from BiBFS answers")
        plan = upd.state["plan"]

        def recheck():
            dist, pre = _relabel_hubs(plan, old.is_hub, old.hub_ids, rows)
            r = torch.as_tensor(rows, device=dist.device).long()
            if not torch.equal(dist, eng.index.hub_dist[r]):
                fail(f"7b {label}: a second relabel differs")
            drain(eng, [p[::-1].copy() for p in fresh])

        check_launches("mut_hub2", recheck, new_rows(paths, before))
        if not same_index(eng.index, pinned(eng.graph)):
            fail(f"7b {label}: the maintained index differs from a pinned rebuild")
        sample = rng.choice(rows, min(MUT_BFS, len(rows)), replace=False)
        for row in sample:
            dist, pre = host_hub_labels(eng.graph, is_hub_np, int(hubs[row]))
            core = (dist < 2**30) & (~pre | is_hub_np)
            if not (np.array_equal(eng.index.hub_dist[row].cpu().numpy(), dist)
                    and np.array_equal(eng.index.core[row].cpu().numpy(), core)):
                fail(f"7b {label}: hub row {row} differs from the host loop")
        return info, wall, rows, sample

    for i, (delta, (fresh, want)) in enumerate(zip(mut["deltas"], mut["fresh"])):
        info, wall, rows, sample = absorb(f"delta {i + 1}", delta, fresh, want)
        # the engine's own pinned build, independent of the relabel under
        # test, at every delta: through cuda (kernel checked) at the first
        # and last, through coo between them
        built, t = [None], time.perf_counter()
        if i in (0, len(mut["deltas"]) - 1):
            how = "cuda, kernel checked"
            check_launches("mut_hub2_pinned", lambda: built.__setitem__(0, build_hub_index(
                eng.graph, k, capacity=64, backend="cuda", hubs=hubs)), set())
        else:
            how = "coo"
            built[0] = no_launch("7b", lambda: build_hub_index(
                eng.graph, k, capacity=64, backend="coo", hubs=hubs))
        bs = time.perf_counter() - t
        if not same_index(eng.index, built[0]):
            fail(f"7b delta {i + 1}: the maintained index differs from the engine's "
                 "pinned rebuild")
        extra = f"; == the engine's pinned rebuild (C=64, {how}, {bs:.3f} s)"
        print(f"  7b delta {i + 1}: {info['index']['mode']}, {len(rows)} of {k} hubs "
              f"affected, maintenance {info['ms']['index'] / 1e3:.3f} s (apply_delta "
              f"{wall:.3f} s) against phase 3's cuda build {main['build_s']:.3f} s; index "
              f"== all {k} rows re-labeled through coo, rows {sorted(sample.tolist())} == "
              f"the host loop; {MUT_FRESH} indexed answers == 7a's BiBFS"
              f"{extra}", flush=True)
    # one edge whose deletion re-labels some hubs but not all: the subset
    # path of affected_hubs, which the deltas above (every hub) never take
    old = eng.index
    delta, (u, v), named = subset_delete(eng.graph, old.hub_dist)
    rows = affected_hubs(old, delta)
    if not 0 < len(rows) < k or len(rows) != named:
        fail(f"7b subset delta: affected_hubs names {len(rows)} of {k} rows (the host "
             f"predicted {named}); it must name a strict, nonempty subset")
    fresh = np.concatenate([[[u, v], [v, u]], np.random.default_rng(10).integers(
        0, g.n_real, (MUT_FRESH - 2, 2))]).astype(np.int32)
    ref = make_bibfs_engine(eng.graph.apply_delta(delta), capacity=FT_C, backend="coo")
    for p in fresh:
        ref.submit(p)
    want = ref.run_until_drained()
    del ref
    info, wall, rows, sample = absorb("subset delta", delta, fresh, want)
    if info["index"]["mode"] != "incremental" or info["index"]["affected_hubs"] != len(rows):
        fail(f"7b subset delta: {info['index']}")
    print(f"  7b subset delta: edge ({u}, {v}) deleted (both directions), chosen on the host "
          f"from hub_dist; affected_hubs names {len(rows)} of {k} rows (the host predicted "
          f"{named}); maintenance {info['ms']['index']:.3f} ms (apply_delta {wall:.3f} s); "
          f"index == all {k} rows re-labeled through coo, rows {sorted(sample.tolist())} == "
          f"the host loop; {MUT_FRESH} indexed answers ({u}, {v} and back among them, d = "
          f"{int(want[0]['dist'])} after the delete) == a BiBFS drain", flush=True)
    rng = np.random.default_rng(8)
    big = undirected_delta(eng.graph, rng, MUT_REBUILD, 0)
    old = eng.index
    before = len(paths)
    info, wall = sync_time(lambda: counted("mut_hub2_rebuild", lambda: eng.apply_delta(big),
                                           paths)[0])
    if info["index"]["mode"] != "rebuild":
        fail(f"7b: a delta of {big.size} edges took the {info['index']['mode']} path")
    plan = upd.state["plan"]

    def rerun():
        again, _ = maintain_hub_index(eng.graph, old, big, plan=plan)
        if not same_index(eng.index, again):
            fail("7b: a second rebuild differs")

    check_launches("mut_hub2_rebuild", rerun, new_rows(paths, before))
    built, t = [None], time.perf_counter()
    check_launches("mut_hub2_pinned", lambda: built.__setitem__(0, build_hub_index(
        eng.graph, k, capacity=64, backend="cuda")), set())
    bs = time.perf_counter() - t
    if not same_index(eng.index, built[0]):
        fail("7b: the rebuilt index differs from the engine's build")
    print(f"  7b rebuild: {big.size} edges ({100 * info['index']['frac']:.3f} % of |E|) took "
          f"the rebuild path (hubs re-picked, all {k} rows re-labeled) in "
          f"{info['ms']['index'] / 1e3:.3f} s; equal to a second rebuild and to the "
          f"engine's build (C=64, kernel checked, {bs:.3f} s)", flush=True)


MUT_WAVES = (16, 32)   # 7c: the qids at which waves 2 and 3 are submitted


def mut_recover(tmp, store, pairs, mut, paths) -> None:
    """7c: run_with_recovery of the 256 pairs from 6a's store, in three
    waves with a delta before each later wave, crashes at rounds 5 and 17,
    against the same run uninterrupted; then a store saved at version 2.

    A delta lands at the round boundary where the queue has just emptied
    (every query of the current wave admitted, some still in flight) and
    the next wave is submitted right after it: each query's version is
    then its wave's whatever the schedule, which recovery changes, and
    the in-flight ones are pinned by the snapshot the mutation writes
    first.  (A delta at a fixed round would pin the queries admitted
    around it to versions that depend on the schedule.)"""
    from repro_torch.core.store import Store, load_engine_store, save_engine_store
    from repro_torch.launch.supervise import _result_map, run_with_recovery
    from repro_torch.train.fault import FailureInjector

    starts = (0,) + MUT_WAVES + (len(pairs),)
    waves = [pairs[a:b] for a, b in zip(starts, starts[1:])]
    at = []

    def boot():
        return bibfs_engine(store.get("graph", device="cuda"),
                            store.get("aux_graphs", device="cuda")["rev"],
                            store.get("tables", device="cuda"))

    def on_round(eng, rounds):
        rt, v = eng.runtime, eng.graph.version
        if v < len(MUT_WAVES) and rt.pending() == 0 and rt._next_qid == starts[v + 1]:
            live = int(rt.live.sum())  # the mutation's snapshot suspends them
            eng.apply_delta(mut["deltas"][v])
            for j, p in enumerate(waves[v + 1]):
                eng.submit(p, qid=starts[v + 1] + j)
            at.append((v + 1, rounds, live))

    def run(jname, crashes):
        inj = FailureInjector(fail_at_steps=crashes) if crashes else None
        return run_with_recovery(boot, os.path.join(tmp, jname), list(waves[0]),
                                 snapshot_every=SNAPSHOT_EVERY, fsync=True, injector=inj,
                                 on_round=on_round)

    ((eng, info), wall) = sync_time(lambda: counted(
        "mut_recover", lambda: run("mut.wal", {5, 17}), paths)[0])
    crashed_at = list(at)
    if info["restarts"] != 2 or info["mutations_replayed"] < 1:
        fail(f"7c: {info}")
    base, t0 = [None], time.perf_counter()
    at.clear()
    check_launches("mut_recover", lambda: base.__setitem__(0, run("mut_base.wal", set())),
                   path_keys(paths, "mut_recover"))
    base_s = time.perf_counter() - t0
    beng = base[0][0]
    if _result_map(eng) != _result_map(beng) or len(_result_map(eng)) != len(pairs):
        fail("7c: the recovered result map differs from the uninterrupted run with deltas")
    if eng.graph.content_hash() != beng.graph.content_hash() or eng.graph.version != 2:
        fail("7c: the recovered graph is not the uninterrupted run's version 2")
    s2 = Store(os.path.join(tmp, "store_v2"))
    save_engine_store(s2, beng.graph, aux_graphs={"rev": beng.aux_graphs["rev"]})
    got = load_engine_store(s2, device="cuda")["graph"]
    meta = s2.manifest("graph")["meta"]
    if (got.version, got.parent_hash, meta["graph_version"], meta["parent_hash"]) != (
            2, beng.graph.parent_hash, 2, beng.graph.parent_hash) or \
            got.content_hash() != beng.graph.content_hash():
        fail("7c: a store saved at version 2 lost its lineage")
    size = os.path.getsize(os.path.join(tmp, "mut.wal"))
    print(f"  7c recover: deltas (version, round of its boot, queries in flight) "
          f"{crashed_at} with crashes, {at} without; restarts {info['restarts']}, last "
          f"recovery replayed {info['mutations_replayed']} mutation(s) through the hash "
          f"chain and resumed {info['resumed_from_snapshot']} from a snapshot; journal "
          f"{size} bytes, wall {wall:.3f} s (uninterrupted {base_s:.3f} s, kernel "
          f"checked); result map == the uninterrupted run's; a store saved at version 2 "
          f"boots with graph_version 2 and its parent_hash", flush=True)


def mut_gated(g, pairs, main) -> None:
    """7d: the 256 BiBFS pairs through the gated COO gather, timed against
    the same pairs through ungated COO (exact graph, no padding) in the
    order ungated, gated, gated, ungated."""
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.launch.supervise import _result_map

    walls = {None: [], GATHER_EDGES: []}
    for ge in (None, GATHER_EDGES, GATHER_EDGES, None):
        eng = make_bibfs_engine(g, capacity=FT_C, backend="coo", gather_edges=ge)
        _, wall = no_launch("7d", lambda: sync_time(lambda: drain(eng, pairs)))
        if _result_map(eng) != main["bibfs_map"]:
            fail(f"7d: coo (gather_edges={ge}) answers, statuses or steps differ from "
                 "phase 3's")
        walls[ge].append(wall)
    print(f"  7d gated coo: {len(pairs)} BiBFS pairs, gather_edges={GATHER_EDGES}, "
          f"{eng.stats.rounds} rounds, wall {walls[GATHER_EDGES]} s against ungated coo "
          f"{walls[None]} s; both result maps == phase 3's", flush=True)


def phase_mutation(g, pairs, main, tmp, store):
    """Phase 7: mutable graphs and the gated COO plan on the card, reusing
    phase 3's graph, rev view, pairs, tables, Hub2 index and answers and
    6a's store.  Returns (launches, path rows, 7a's first deltas, which
    phase 9 replays under a mesh)."""
    t0 = time.perf_counter()
    main = dict(main, rev=main["rev"].to("cuda"), hub_index=main["hub_index"].to("cuda"),
                tables=tables_to(main["tables"], "cuda"))
    paths, mut = [], {}
    parts = (("7a", lambda: mut.update(mut_bibfs(g, pairs, main, paths))),
             ("7b", lambda: mut_hub2(g, main, mut, paths)),
             ("7c", lambda: mut_recover(tmp, store, pairs, mut, paths)),
             ("7d", lambda: mut_gated(g, pairs, main)))
    for name, part in parts:
        t = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    launches = sum(r["launches"] for r in paths)
    print(f"phase 7: {launches} kernel launches in the cuda runs; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, paths, mut["deltas"][:MESH_DELTAS]


# ------------------------------------------------------------ phase 8
SERVE_C = 8                                    # the JAX A/B cell's C (benchmarks/run.py)
AB_REPS = 3                                    # interleaved reps of each round per plan
VCLOCK_RATES = (0.5, 1.0, 2.0, 4.0)            # Poisson arrivals per tick
# of phase 3's closed-loop BiBFS q/s; 2 and 3 find the knee where the open
# loop outruns the closed-loop drain (no tail of half-empty rounds)
WALL_FRACTIONS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0)
WALL_REPS = 3          # passes of the wall-clock sweep: one pass is ~0.2 s a rate
ZIPF_KEYS, ZIPF_QUERIES, ZIPF_S = 64, 512, 1.1
REPLICAS, REPLICA_CACHE = 2, 16


def merge_rows(rows: list) -> list:
    """Path rows of repeated runs of a path, launches summed per key."""
    total = collections.Counter()
    for r in rows:
        total[(r["path"], r["semiring"], r["dtype"], r["q"])] += r["launches"]
    return [dict(path=p, semiring=sr, dtype=dt, q=q, launches=n)
            for (p, sr, dt, q), n in total.items()]


def same_as_main(results: dict, qids, main, picks=None, dist_only=False) -> bool:
    """Each qid's answer equals phase 3's batch BiBFS answer of its pair
    (the i-th qid asks pair ``picks[i]``, or pair i)."""
    for i, q in enumerate(qids):
        want = main["bibfs"][int(picks[i]) if picks is not None else i]
        got = results[q]
        keys = ("dist",) if dist_only else tuple(want)
        if not all(np.array_equal(np.asarray(got[k]), np.asarray(want[k])) for k in keys):
            return False
    return True


def ms_pct(xs, q) -> float:
    return 1e3 * float(np.percentile(xs, q)) if len(xs) else float("nan")


class TimedPumps:
    """A load-generator target that times each pump.  The load generator's
    busy_qps counts completions per pump under either clock; under the
    wall clock the seconds spent pumping give the delivered q/s."""

    def __init__(self, target):
        self.target, self.busy_s = target, 0.0

    def __getattr__(self, name):
        return getattr(self.target, name)

    def pump(self):
        t0 = time.perf_counter()
        out = self.target.pump()
        self.busy_s += time.perf_counter() - t0
        return out


def serve_ab(g, pairs, main, tables, paths) -> dict:
    """8a: the legacy round against the fused one, BFS C=8 k=1, on cuda and
    on coo, 3 interleaved reps of each.  Returns the cuda plan's medians in
    BENCH_quegel.json's ``ab`` schema."""
    from repro_torch.apps.ppsp import make_bfs_engine
    from repro_torch.core.engine import EngineStats

    first = None
    for plan in ("cuda", "coo"):
        kw = dict(blocks=tables["default"]) if plan == "cuda" else {}
        engines = {mode: make_bfs_engine(g, capacity=SERVE_C, backend=plan,
                                         legacy=mode == "legacy", **kw)
                   for mode in ("legacy", "fused")}
        for eng in engines.values():  # first-use work off the clock
            drain(eng, pairs[:10])
        cells = {mode: [] for mode in engines}
        for _ in range(AB_REPS):
            for mode, eng in engines.items():
                eng.runtime.stats = EngineStats()
                qids = [eng.submit(p) for p in pairs]
                run = lambda: sync_time(eng.run_until_drained)[1]
                wall = (counted(f"serve_ab_{mode}", run, paths)[0] if plan == "cuda"
                        else no_launch(f"8a {mode}", run))
                got = {i: eng.runtime.results[q] for i, q in enumerate(qids)}
                if not same_as_main(got, range(len(pairs)), main, dist_only=True):
                    fail(f"8a: {plan} {mode} distances differ from phase 3's")
                first = first or got
                if not same_results(got, first):
                    fail(f"8a: {plan} {mode} answers differ from cuda legacy's")
                cells[mode].append((eng.stats.rounds / wall, len(pairs) / wall,
                                    eng.stats.rounds, eng.stats.supersteps_total))
        if {c[2:] for m in cells for c in cells[m]} != {cells["fused"][0][2:]}:
            fail(f"8a: {plan} rounds or supersteps differ between the modes or reps")
        if plan == "cuda":
            for mode, eng in engines.items():
                check_launches(f"serve_ab_{mode}", lambda: drain(eng, pairs),
                               path_keys(paths, f"serve_ab_{mode}"))
        med = {m: (statistics.median(c[0] for c in cs), statistics.median(c[1] for c in cs))
               for m, cs in cells.items()}
        if plan == "cuda":
            ab = dict(workload=f"ppsp_bfs_cuda_C{SERVE_C}",
                      **{m: dict(super_rounds_per_sec=r, queries_per_sec=q)
                         for m, (r, q) in med.items()},
                      speedup_super_rounds_per_sec=med["fused"][0] / med["legacy"][0],
                      speedup_queries_per_sec=med["fused"][1] / med["legacy"][1])
        print(f"  8a [{plan}] BFS C={SERVE_C} k=1, {len(pairs)} pairs, {AB_REPS} interleaved "
              f"reps: legacy {med['legacy'][0]:.3f} rounds/s, {med['legacy'][1]:.3f} q/s; "
              f"fused {med['fused'][0]:.3f} rounds/s, {med['fused'][1]:.3f} q/s; "
              f"{cells['fused'][0][2]} rounds, {cells['fused'][0][3]} supersteps in both; "
              f"fused/legacy {med['fused'][0] / med['legacy'][0]:.4f} (rounds/s), "
              f"{med['fused'][1] / med['legacy'][1]:.4f} (q/s); per-rep q/s legacy "
              f"{[round(c[1], 3) for c in cells['legacy']]}, fused "
              f"{[round(c[1], 3) for c in cells['fused']]}; answers == cuda legacy, "
              "distances == phase 3's", flush=True)
        del engines
        gc.collect()
    return ab


def serve_vclock(g, pairs, main, tables, rev, paths):
    """8b: BiBFS C=8 under Poisson arrivals on the virtual clock, on cuda and
    on coo: ticks, latencies, backlog and answers must be identical.
    Returns the cuda engine (warm) for 8c."""
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.launch.loadgen import make_arrivals, run_open_loop
    from repro_torch.launch.supervise import _result_map

    runs, maps, walls, engines = {}, {}, {}, {}
    for plan in ("cuda", "coo"):
        eng = (bibfs_engine(g, rev, tables) if plan == "cuda"
               else make_bibfs_engine(g, capacity=SERVE_C, backend="coo"))
        engines[plan] = eng
        t0 = time.perf_counter()
        for r in VCLOCK_RATES:
            arr = make_arrivals("poisson", r, len(pairs), seed=2)
            go = lambda: run_open_loop(eng, list(pairs), arr, offered_qps=r)
            runs[plan, r] = (counted("serve_vclock", go, paths)[0] if plan == "cuda"
                             else no_launch("8b", go))
            qids = sorted(runs[plan, r].statuses)
            if not same_as_main(eng.runtime.results, qids, main):
                fail(f"8b: {plan} answers at {r} per tick differ from phase 3's")
        walls[plan] = time.perf_counter() - t0
        maps[plan] = _result_map(eng)
    if maps["cuda"] != maps["coo"]:
        fail("8b: the result maps (answers, statuses, steps) differ between cuda and coo")
    r = VCLOCK_RATES[-1]
    check_launches("serve_vclock", lambda: run_open_loop(
        engines["cuda"], list(pairs), make_arrivals("poisson", r, len(pairs), seed=2),
        offered_qps=r), path_keys(paths, "serve_vclock"))
    for r in VCLOCK_RATES:
        a, b = runs["cuda", r], runs["coo", r]
        if (a.latencies, a.ticks, a.max_backlog, a.statuses) != (
                b.latencies, b.ticks, b.max_backlog, b.statuses):
            fail(f"8b: the virtual clock differs between cuda and coo at {r} per tick")
        s = a.summary()
        print(f"  8b r={r}/tick Poisson(seed=2), {len(pairs)} BiBFS pairs, C={SERVE_C}: "
              f"{a.ticks} ticks, latency p50 {s['lat_p50']} p99 {a.latency_percentile(99)} "
              f"ticks, max_backlog {a.max_backlog}, busy {s['busy_qps']:.4f} q/tick, "
              f"achieved {s['achieved_qps']:.4f} q/tick; ticks, latencies, backlog and "
              "map identical on cuda and coo, answers == phase 3's", flush=True)
    print(f"  8b wall of the 4 runs: cuda {walls['cuda']:.3f} s, coo {walls['coo']:.3f} s",
          flush=True)
    del engines["coo"]
    return engines["cuda"]


def wall_line(tag: str, res, busy_s: float, rate: float) -> str:
    return (f"{tag}: offered {rate:.3f} q/s, achieved {res.achieved_qps:.3f} q/s, busy "
            f"{res.n / busy_s:.3f} q/s ({busy_s:.4f} s pumping of {res.makespan:.4f} s), "
            f"{res.ticks} pumps; latency p50 {ms_pct(res.latencies, 50):.3f} p99 "
            f"{ms_pct(res.latencies, 99):.3f} ms; queue wait p50 "
            f"{ms_pct(res.queue_waits, 50):.3f} p99 {ms_pct(res.queue_waits, 99):.3f} ms; "
            f"service p50 {ms_pct(res.service_times, 50):.3f} p99 "
            f"{ms_pct(res.service_times, 99):.3f} ms; max_backlog {res.max_backlog}")


def serve_wall(eng, pairs, main, q_max, paths) -> None:
    """8c: the wall-clock sweep on cuda at fractions of phase 3's closed-loop
    q/s, WALL_REPS interleaved passes, each rate's median pass printed and
    read for the knee; then one bursty (MMPP) run."""
    from repro_torch.core.engine import EngineStats
    from repro_torch.launch.loadgen import make_arrivals, run_open_loop, saturation_knee

    def one(tag, arr, rate):
        eng.runtime.stats = EngineStats()
        tgt = TimedPumps(eng)
        res = counted("serve_wall", lambda: run_open_loop(
            tgt, list(pairs), arr, clock="wall", offered_qps=rate), paths)[0]
        if not same_as_main(eng.runtime.results, sorted(res.statuses), main):
            fail(f"8c: answers of the {tag} run differ from phase 3's")
        return res, tgt.busy_s

    arrivals = {f: make_arrivals("poisson", f * q_max, len(pairs), seed=2)
                for f in WALL_FRACTIONS}
    runs = {f: [] for f in WALL_FRACTIONS}
    for _ in range(WALL_REPS):  # a pass over every rate, so drift hits each alike
        for f in WALL_FRACTIONS:
            res, busy_s = one(f"{f} x q_max", arrivals[f], f * q_max)
            runs[f].append((res.n / busy_s, res, busy_s))
    curve = {}
    for f in WALL_FRACTIONS:
        busy, res, busy_s = sorted(runs[f], key=lambda r: r[0])[len(runs[f]) // 2]
        curve[f * q_max] = {"busy_qps": busy}
        print(f"  8c {wall_line(f'{f} x q_max Poisson, median of {WALL_REPS}', res, busy_s, f * q_max)}"
              f"; busy q/s of the passes {[r[0] for r in runs[f]]}; answers == phase 3's",
              flush=True)
    print(f"  8c knee (saturation_knee, tol 0.9, median busy q/s): "
          f"{saturation_knee(curve, tol=0.9)!r} q/s; q_max (phase 3's closed-loop cuda "
          f"batch BiBFS) {q_max!r} q/s", flush=True)
    rate = 0.5 * q_max
    res, busy_s = one("MMPP", make_arrivals("mmpp", rate, len(pairs), seed=2, burst=4.0,
                                            dwell=32.0 / rate), rate)
    print(f"  8c {wall_line('0.5 x q_max MMPP(burst=4, dwell=32/rate)', res, busy_s, rate)}; "
          "answers == phase 3's", flush=True)
    makespan = statistics.median(r[1].makespan for r in runs[1.0])
    check_launches("serve_wall", lambda: run_open_loop(
        eng, list(pairs), arrivals[1.0], clock="wall", offered_qps=q_max),
        path_keys(paths, "serve_wall"))
    device_breakdown(lambda: run_open_loop(eng, list(pairs), arrivals[1.0], clock="wall",
                                           offered_qps=q_max), makespan,
                     "8c [cuda] open loop at q_max")


def serve_pool(g, pairs, main, store, q_max, paths) -> None:
    """8d: two BiBFS replicas booted from 6a's store (one read), pumped one
    after another on the one card, under a Zipf mix for each policy."""
    from repro_torch.core import store as tstore
    from repro_torch.launch.loadgen import make_arrivals, run_open_loop
    from repro_torch.launch.router import POLICIES, ReplicaPool, boot_replicas_from_store

    reads, orig = [0], tstore.load_engine_store

    def counting(*a, **kw):
        reads[0] += 1
        return orig(*a, **kw)

    # fresh replicas for each policy, the wall run and the kernel checks
    n_reps = REPLICAS * (len(POLICIES) + 3)
    tstore.load_engine_store = counting
    try:
        reps, boot_s = sync_time(lambda: boot_replicas_from_store(
            store, lambda i, parts: bibfs_engine(
                parts["graph"], parts["aux_graphs"]["rev"], parts["tables"],
                result_cache=REPLICA_CACHE), n_reps, device="cuda"))
    finally:
        tstore.load_engine_store = orig
    ptr = reps[0].graph.src.data_ptr()
    if reads[0] != 1 or any(r.graph.content_hash() != g.content_hash() or r.graph.version != 0
                            or r.graph.src.data_ptr() != ptr for r in reps):
        fail(f"8d: {reads[0]} store reads, or a replica's graph is not phase 3's version 0 "
             "or not the shared tensors")
    print(f"  8d boot: {n_reps} BiBFS replicas (C={SERVE_C}, result_cache={REPLICA_CACHE}) "
          f"from 6a's store in {boot_s:.3f} s, {reads[0]} load_engine_store call; every "
          "graph phase 3's content_hash at version 0, one set of tensors", flush=True)

    rng = np.random.default_rng(3)
    p = 1.0 / np.arange(1, ZIPF_KEYS + 1) ** ZIPF_S
    picks = rng.choice(ZIPF_KEYS, ZIPF_QUERIES, p=p / p.sum())
    items = [pairs[k] for k in picks]
    arr = make_arrivals("constant", 2.0, len(items))
    pools = iter(reps[i:i + REPLICAS] for i in range(0, n_reps, REPLICAS))

    def check(pool, what):
        if sorted(pool.results) != list(range(len(items))) or any(
                s != "DONE" for s in pool.status.values()):
            fail(f"8d: {what}: not every query is DONE")
        if not same_as_main(pool.results, range(len(items)), main, picks):
            fail(f"8d: {what}: the merged map differs from a single engine's (phase 3's)")

    hits = {}
    for policy in POLICIES:
        pool = ReplicaPool(next(pools), policy=policy)
        res = counted("serve_pool", lambda: run_open_loop(pool, items, arr, offered_qps=2.0),
                      paths)[0]
        check(pool, policy)
        s = pool.stats_summary()
        hits[policy] = pool.cache_hits
        print(f"  8d {policy}: {REPLICAS} replicas pumped one after another on the one card "
              f"(no NCCL, no second card), Zipf({ZIPF_S}) over {ZIPF_KEYS} of phase 3's "
              f"pairs, {len(items)} queries at 2 per tick: hit rate "
              f"{pool.cache_hits / len(items):.4f} ({pool.cache_hits}), balance "
              f"{s['balance']:.4f}, submits {s['submits']}, spills {s['spills']}, rounds "
              f"{s['rounds']}, {res.ticks} ticks, latency p50 {res.latency_percentile(50)} "
              f"p99 {res.latency_percentile(99)} ticks; merged map == a single engine's "
              "(phase 3's)", flush=True)
    if not hits["affine"] > hits["rr"]:
        fail(f"8d: affine hits {hits['affine']} do not exceed rr hits {hits['rr']}")
    checked = ReplicaPool(next(pools), policy="affine")
    check_launches("serve_pool", lambda: run_open_loop(checked, items, arr, offered_qps=2.0),
                   path_keys(paths, "serve_pool"))
    check(checked, "the checked affine run")
    pool, rate = ReplicaPool(next(pools), policy="affine"), 0.5 * q_max
    tgt, warr = TimedPumps(pool), make_arrivals("poisson", rate, len(items), seed=4)
    res = counted("serve_pool_wall", lambda: run_open_loop(
        tgt, items, warr, clock="wall", offered_qps=rate), paths)[0]
    check(pool, "the wall-clock affine run")
    check_launches("serve_pool_wall", lambda: run_open_loop(
        ReplicaPool(next(pools), policy="affine"), items, warr, clock="wall",
        offered_qps=rate), path_keys(paths, "serve_pool_wall"))
    print(f"  8d {wall_line('affine, wall clock, 0.5 x q_max Poisson', res, tgt.busy_s, rate)}"
          f"; hit rate {pool.cache_hits / len(items):.4f}; {REPLICAS} replicas pumped one "
          "after another on the one card; merged map == phase 3's", flush=True)


def phase_serving(g, pairs, main, store):
    """Phase 8: open-loop serving and the legacy round on the card, reusing
    phase 3's graph, rev view, pairs, tables and answers and 6a's store.
    Returns (launches, path rows, 8a's A/B of the cuda plan)."""
    from repro_torch.launch import env

    t0 = time.perf_counter()
    print(f"phase 8: host tunings {env.describe()}", flush=True)
    tables, rev = tables_to(main["tables"], "cuda"), main["rev"].to("cuda")
    q_max, paths, warm = main["bibfs_qps"], [], {}
    parts = (("8a", lambda: warm.update(ab=serve_ab(g, pairs, main, tables, paths))),
             ("8b", lambda: warm.update(eng=serve_vclock(g, pairs, main, tables, rev, paths))),
             ("8c", lambda: serve_wall(warm.pop("eng"), pairs, main, q_max, paths)),
             ("8d", lambda: serve_pool(g, pairs, main, store, q_max, paths)))
    for name, part in parts:
        t = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    paths = merge_rows(paths)
    launches = sum(r["launches"] for r in paths)
    print(f"phase 8: {launches} kernel launches in the cuda runs; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, paths, warm["ab"]

# ------------------------------------------------------------ phase 9
MESH_DELTAS = 3        # 9c: the first deltas of 7a, replayed under a mesh
MESH_WIDTHS = (2, 4, 8)  # axis sizes 9a models the collective bytes at
GLOO_RANKS = 4         # 9d: gloo ranks sharing the one card


def mesh_line(tag: str, n: int, eng, dt: float) -> str:
    st = eng.stats
    return (f"{tag}: {n} queries, {st.rounds} rounds, {st.supersteps_total} supersteps, "
            f"wall {dt:.4f} s, {st.rounds / dt:.3f} rounds/s, {n / dt:.3f} q/s")


def mesh_bibfs(g, pairs, main, mesh) -> None:
    """9a: batch BiBFS through mesh= on one NCCL rank, dst and src x k in
    {1, 4}, two interleaved passes (the second printed as the time),
    against phase 3's answers and a single-device coo drain."""
    from repro_torch.apps.ppsp import make_bibfs_engine

    make_bibfs_engine(g, capacity=FT_C, mesh=mesh).query(pairs[0])  # NCCL's first use
    cells = [(part, k) for part in ("dst", "src") for k in (1, 4)]
    walls = {}
    for rep in range(2):
        coo = make_bibfs_engine(g, capacity=FT_C, backend="coo")
        for p in pairs:
            coo.submit(p)
        res, walls["coo", rep] = sync_time(coo.run_until_drained)
        if not same_results(res, main["bibfs"]):
            fail("9a: the single-device coo answers differ from phase 3's")
        for part, k in cells:
            eng = make_bibfs_engine(g, capacity=FT_C, mesh=mesh, partition=part,
                                    steps_per_round=k)
            for p in pairs:
                eng.submit(p)
            res, walls[part, k, rep] = no_launch(
                f"9a {part} k={k}", lambda: sync_time(eng.run_until_drained))
            if not same_results(res, main["bibfs"]):
                fail(f"9a {part} k={k}: the mesh answers differ from phase 3's")
            if rep == 0:
                continue
            dt, coo_s = walls[part, k, 1], walls["coo", 1]
            print(f"  9a mesh {part} k={k} {mesh_line('BiBFS', len(pairs), eng, dt)} (first "
                  f"pass {walls[part, k, 0]:.4f} s); {coo_s / dt:.3f} x the single-device "
                  f"coo drain's q/s", flush=True)
            busy, nccl = device_breakdown(redrain(eng, pairs), dt,
                                          f"9a mesh {part} k={k}", kernel="nccl")
            if busy:
                print(f"  9a mesh {part} k={k}: NCCL kernels {nccl:.6f} s, "
                      f"{100 * nccl / busy:.2f} % of device time", flush=True)
            print(f"  9a mesh {part} k={k}: collective_bytes_per_round (w=1, this run) "
                  f"{eng.collective_bytes_per_round()}", flush=True)
            for w in MESH_WIDTHS:
                m = eng.collective_bytes_per_round(n_parts=w)
                print(f"  9a mesh {part} k={k}: modeled at w={w} (not measured): "
                      f"state gather {m['state_gather_bytes']:.0f} B, "
                      f"{m['propagate_bytes_per_superstep']:.0f} B per superstep, "
                      f"{m['round_total_bytes']:.0f} B per round", flush=True)
            del eng
            gc.collect()
        if rep == 1:
            print(f"  9a {mesh_line('single-device coo', len(pairs), coo, walls['coo', 1])} "
                  f"(first pass {walls['coo', 0]:.4f} s); answers == phase 3's and the "
                  "mesh's", flush=True)


def mesh_reach(reach, mesh) -> None:
    """9b: reach with its label index through mesh= on one NCCL rank."""
    from repro_torch.apps.reach import make_reach_engine

    dag, idx = reach["dag"].to("cuda"), reach["index"].to("cuda")
    for part in ("dst", "src"):
        eng = make_reach_engine(dag, idx, capacity=APPS_C, mesh=mesh, partition=part)
        for p in reach["pairs"]:
            eng.submit(p)
        res, dt = no_launch(f"9b {part}", lambda: sync_time(eng.run_until_drained))
        if not same_results(res, reach["results"]):
            fail(f"9b {part}: the mesh reach answers differ from phase 5's")
        print(f"  9b mesh {part} {mesh_line('reach', len(reach['pairs']), eng, dt)}; "
              f"== phase 5's answers", flush=True)


def mesh_mutation(g, pairs, deltas, mesh) -> None:
    """9c: BiBFS with arg_carried=True under the mesh through 7a's first
    deltas, a wave of queries admitted before each (the slots fit every
    wave, so each is admitted on the version it was submitted at) and in
    flight across it: spliced partitions == a full re-partition of each
    new view, Emax held, every answer == a fresh single-device engine's
    on its admission version."""
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.core.distributed import ShardedGraph

    eng = make_bibfs_engine(g, capacity=FT_C, mesh=mesh, arg_carried=True)
    emax = {v: int(be.sg.srcp.shape[1]) for v, be in eng._backends.items()}
    versions, waves, size = [g], [], FT_C // (len(deltas) + 1)
    for i, delta in enumerate(deltas + [None]):
        wave = pairs[size * i:size * (i + 1)]
        waves.append((i, [eng.submit(p) for p in wave], wave))
        if delta is None:
            break
        no_launch("9c", eng.run_round)
        for q in waves[-1][1]:
            slot = eng.runtime.slot_of(q)
            if slot is not None and int(eng._slot_version[slot]) != i:
                fail(f"9c: query {q} was admitted on version {eng._slot_version[slot]}, not {i}")
        live = int(eng.runtime.live.sum())
        info = eng.apply_delta(delta)
        versions.append(eng.graph)
        views = {"default": eng.graph, "rev": eng.aux_graphs["rev"]}
        for v, be in eng._backends.items():
            sg = be.sg
            full = ShardedGraph(views[v], sg.n_parts, partition=sg.partition)
            if int(sg.srcp.shape[1]) != emax[v]:
                fail(f"9c delta {i + 1}: the {v} partitions' Emax moved")
            for r in range(sg.n_parts):
                for a, b in ((sg.srcp, full.srcp), (sg.dstp, full.dstp), (sg.wp, full.wp)):
                    if not torch.equal(a[r][sg.valid[r]], b[r][full.valid[r]]):
                        fail(f"9c delta {i + 1}: spliced {v} row {r} != a full re-partition")
        ms = info["ms"]
        print(f"  9c delta {i + 1}: {delta.size} edges, version {info['version']}, {live} "
              f"queries in flight; host splice {ms['splice']:.3f} ms, partition splice "
              f"{ms['tables']:.3f} ms (2 views), finish {ms['finish']:.3f} ms; spliced "
              f"partitions == a full re-partition, Emax {emax} held", flush=True)
    res = no_launch("9c", eng.run_until_drained)
    if eng.stats.shape_changes:
        fail(f"9c: in-capacity deltas changed shapes {eng.stats.shape_changes} times")
    for i, qids, wave in waves:
        ref = make_bibfs_engine(versions[i], capacity=FT_C, backend="coo")
        for p in wave:
            ref.submit(p)
        want = ref.run_until_drained()
        if not same_results({j: res[q] for j, q in enumerate(qids)}, want):
            fail(f"9c: the queries admitted on version {i} differ from a fresh engine's")
    print(f"  9c: {len(waves)} waves of {size} answered on their admission versions "
          f"== fresh single-device coo engines; shape_changes 0", flush=True)


def gloo_rank(out_path: str) -> None:
    """One of 9d's ranks (``chip_smoke.py --gloo-rank OUT``, started with
    torchrun's environment): batch BiBFS on the main graph through a
    (GLOO_RANKS,) mesh over gloo, with CUDA tensors on the one card."""
    import pickle

    import torch.distributed as dist

    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.core.graph import barabasi_albert
    from repro_torch.kernels import frontier
    from repro_torch.launch.mesh import host_device_mesh

    dist.init_process_group("gloo")
    mesh = host_device_mesh()
    g = barabasi_albert(MAIN_N, MAIN_M, seed=0)
    pairs = np.random.default_rng(1).integers(0, g.n_real, (MAIN_PAIRS, 2)).astype(np.int32)
    out = {}
    make_bibfs_engine(g, capacity=FT_C, mesh=mesh).query(pairs[0])
    for part in ("dst", "src"):
        eng = make_bibfs_engine(g, capacity=FT_C, mesh=mesh, partition=part)
        for p in pairs:
            eng.submit(p)
        dist.barrier()
        res, dt = sync_time(eng.run_until_drained)
        out[part] = dict(results=res, wall=dt, rounds=eng.stats.rounds,
                         supersteps=eng.stats.supersteps_total)
    out["launches"] = frontier.launches()
    with open(f"{out_path}.{dist.get_rank()}", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def mesh_gloo(main, tmp) -> None:
    """9d: GLOO_RANKS gloo ranks on the one card, each a process of this
    script, batch BiBFS dst and src; every rank's answers == phase 3's."""
    import pickle

    from repro_torch.launch.supervise import free_port

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(GLOO_RANKS),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    out = os.path.join(tmp, "gloo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-rank", out],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(GLOO_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"9d: gloo ranks exited {[p.returncode for p in procs]}\n"
             + "\n".join(text[-2000:] for text in logs))
    for r in range(GLOO_RANKS):
        with open(f"{out}.{r}", "rb") as f:
            got = pickle.load(f)
        if got["launches"]:
            fail(f"9d rank {r}: the frontier kernel launched {got['launches']} times")
        for part in ("dst", "src"):
            run = got[part]
            if not same_results(run["results"], main["bibfs"]):
                fail(f"9d rank {r} {part}: the answers differ from phase 3's")
            if r == 0:
                print(f"  9d {GLOO_RANKS} gloo ranks on one card, {part}: {MAIN_PAIRS} queries, "
                      f"{run['rounds']} rounds, {run['supersteps']} supersteps, wall "
                      f"{run['wall']:.4f} s, {run['rounds'] / run['wall']:.3f} rounds/s, "
                      f"{MAIN_PAIRS / run['wall']:.3f} q/s (host-staged gloo collectives, "
                      "not NCCL)", flush=True)
    print(f"  9d: every rank's answers == phase 3's on dst and src; "
          f"{time.perf_counter() - t0:.1f} s with start-up", flush=True)


def mesh_sigkill(tmp) -> None:
    """9e: the SIGKILL drill with the child as one NCCL rank under a mesh."""
    cmd = [sys.executable, "-m", "repro_torch.launch.supervise", "--crash-test",
           "--seeds", "1", "--queries", "6", "--snapshot-every", "2",
           "--out", os.path.join(tmp, "crash_mesh"), "--device", "cuda", "--ranks", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p, wall = sync_time(lambda: subprocess.run(cmd, capture_output=True, text=True,
                                               env=env, timeout=600))
    for line in p.stdout.strip().splitlines():
        print(f"    {line}", flush=True)
    if (p.returncode != 0 or "recovered ≡ uninterrupted" not in p.stdout
            or "ranks=1" not in p.stdout):
        fail(f"9e: crash-test under a mesh rc={p.returncode}\n{p.stderr[-3000:]}")
    print(f"  9e SIGKILL under a one-rank NCCL mesh: rc 0, 1 seed, {wall:.1f} s", flush=True)


def phase_mesh(g, pairs, main, reach, deltas, tmp) -> None:
    """Phase 9: mesh mode on the card, reusing phase 3's graph, pairs and
    answers, phase 5's reach data and 7a's first deltas.  No frontier
    kernel launches here: the mesh combines over edge partitions."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.supervise import free_port

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1,), ("w",))
        print(f"phase 9: one NCCL rank, mesh (1,) axis 'w' on "
              f"cuda:{torch.cuda.current_device()}", flush=True)
        parts = (("9a", lambda: mesh_bibfs(g, pairs, main, mesh)),
                 ("9b", lambda: mesh_reach(reach, mesh)),
                 ("9c", lambda: mesh_mutation(g, pairs, deltas, mesh)),
                 ("9d", lambda: mesh_gloo(main, tmp)),
                 ("9e", lambda: mesh_sigkill(tmp)))
        for name, part in parts:
            t = time.perf_counter()
            part()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"phase 9: no frontier kernel launch in 9a-9d (9e's children build none); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 10
LM_C, LM_MAX_LEN, LM_REQUESTS = 8, 512, 32   # 10b's slot table and load
LM_PROMPT, LM_NEW = (16, 128), (16, 64)      # drawn from default_rng(0), both ends in
LM_REF = 4             # 10b requests held against a no-cache greedy forward
LM_PAIR = 8            # 10b requests served at C=1 and at C=8
LM_TIE = 1e-3          # near-tie rule: a stream may differ only where the
                       # reference's top-2 gap is within this share of max |logit|
GEMMA_LAYERS = 8       # 10c: 4 local/global super-blocks of gemma2-9b's 42 layers
GEMMA_C, GEMMA_MAX_LEN, GEMMA_REQUESTS = 4, 256, 8


class LMCheck:
    """The near-tie rule of phase 10.  ``gap`` returns the reference's
    top-2 logit gap, over its max |logit|, at the step after ``tokens``
    (through the full-context forward on the card); ``same`` holds two
    token streams of one prompt to it and records the smallest gap it
    saw where streams differ."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params
        self.diverged = []

    def logits(self, tokens) -> torch.Tensor:
        from repro_torch.models import transformer as T

        with torch.no_grad():
            seq = torch.as_tensor(np.asarray(tokens, np.int32)[None], device="cuda")
            return T.forward(self.params, self.cfg, {"tokens": seq})[0]

    @staticmethod
    def rel_gap(row: torch.Tensor) -> float:
        top = torch.topk(row, 2).values
        return float((top[0] - top[1]) / row.abs().max())

    def same(self, what: str, prompt, a, b) -> bool:
        return near_tie(what, a, b, lambda i: self.rel_gap(
            self.logits(list(map(int, prompt)) + list(map(int, a[:i])))[-1]), self.diverged)

    def greedy(self, what: str, prompt, got) -> float:
        """Hold ``got`` against a no-cache greedy decode through forward;
        returns the smallest top-2 gap (relative) along the reference."""
        toks, smallest = list(map(int, prompt)), math.inf
        for i, tok in enumerate(map(int, got)):
            row = self.logits(toks)[-1]
            ref = int(torch.argmax(row))
            smallest = min(smallest, self.rel_gap(row))
            if ref != tok:
                self.same(what, prompt, list(got[:i]) + [ref], got[: i + 1])
                return smallest
            toks.append(tok)
        return smallest


def lm_requests(rng, n: int, vocab: int, plens, news) -> list:
    from repro_torch.launch.serve import Request

    lens = rng.integers(plens[0], plens[1] + 1, n)
    new = rng.integers(news[0], news[1] + 1, n)
    return [Request(rid, rng.integers(0, vocab, int(lens[rid]), dtype=np.int32),
                    max_new_tokens=int(new[rid]), budget=int(new[rid]))
            for rid in range(n)]


def lm_serve(cfg, params, reqs, device="cuda", gaps=None, **kw):
    """Drain ``reqs`` through a fresh SlotServer with the prefill calls
    timed apart (a synchronize around each); returns the server and a
    dict of wall s, prefill s and prefill tokens.  ``device="cpu"`` is
    for an explicit host reference only.  With a dict ``gaps``, the
    server's own logits are read at every decode step: ``gaps[rid][i]``
    is the top-2 gap over max |logit| of request rid's step i."""
    from repro_torch.launch.serve import Request, SlotServer

    srv = SlotServer(cfg, params, device=device, **kw)
    t = dict(prefill_s=0.0, prefill_tokens=0)
    if gaps is not None:
        capture_gaps(srv, gaps)
    orig = srv._prefill_slot

    def timed(slot, prompt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(slot, prompt)
        torch.cuda.synchronize()
        t["prefill_s"] += time.perf_counter() - t0
        t["prefill_tokens"] += len(prompt)

    srv._prefill_slot = timed
    for r in reqs:
        srv.submit(Request(r.rid, r.prompt, r.max_new_tokens, budget=r.budget))
    _, t["wall_s"] = sync_time(srv.run_until_drained)
    return srv, t


def near_tie(what: str, a, b, gap_at, seen: list) -> bool:
    """Hold two token streams of one request to the near-tie rule: they may
    differ only where ``gap_at(i)``, the reference's top-2 logit gap over
    its max |logit| at the first differing step i (``a`` is the
    reference's stream), is within LM_TIE.  Appends that gap to ``seen``."""
    a, b = list(map(int, a)), list(map(int, b))
    if len(a) != len(b):
        fail(f"{what}: {len(a)} tokens against {len(b)}")
    if a == b:
        return True
    i = next(j for j in range(len(a)) if a[j] != b[j])
    gap = gap_at(i)
    if gap > LM_TIE:
        fail(f"{what}: streams differ at step {i} ({a[i]} against {b[i]}) where the "
             f"reference's top-2 gap is {gap:.3e} of max |logit| (> {LM_TIE})")
    seen.append(gap)
    print(f"  {what}: streams differ at step {i} of {len(a)}, a near tie "
          f"(top-2 gap {gap:.3e} of max |logit|)", flush=True)
    return False


def capture_gaps(srv, gaps: dict) -> None:
    """Wrap ``srv``'s step and round so that each decode step's logits (the
    last step of a round) leave, per live slot, the relative top-2 gap of
    that slot's row in ``gaps[rid]``: the reference for the near-tie rule
    where a greedy forward cannot reproduce the server's own state."""
    from repro_torch.core.runtime import to_numpy

    step, round_ = srv._step, srv.slot_round
    last = {}

    def logged_step(tokens, pos):
        last["logits"] = step(tokens, pos)
        return last["logits"]

    def logged_round(admitted):
        out = round_(admitted)
        top = torch.topk(last["logits"], 2, dim=-1).values
        rel = to_numpy((top[:, 0] - top[:, 1]) / last["logits"].abs().amax(-1))
        for slot in np.flatnonzero(srv.runtime.live):
            gaps.setdefault(srv._slot_req[slot].rid, []).append(float(rel[slot]))
        return out

    srv._step, srv.slot_round = logged_step, logged_round


def lm_line(tag: str, srv, t: dict) -> str:
    st = srv.stats
    decode_s = t["wall_s"] - t["prefill_s"]
    return (f"{tag}: {st.requests_done} requests, {st.rounds} rounds, "
            f"{st.tokens_generated} tokens generated, {t['prefill_tokens']} prefill tokens, "
            f"wall {t['wall_s']:.4f} s, {st.tokens_generated / t['wall_s']:.2f} tok/s "
            f"(decode only {st.tokens_generated / decode_s:.2f} tok/s), "
            f"{1e3 * decode_s / st.rounds:.3f} ms per decode round, "
            f"{1e3 * t['prefill_s'] / max(t['prefill_tokens'], 1):.3f} ms per prefill token")


def lm_forward_checks(tag: str, cfg, params, host=None, length: int = 32):
    """The card's forward against the host's (when given), and teacher-forced
    serve_step against the card's forward, on one ``length``-token prompt.
    Audio also encodes 1 x ``encoder_seq`` seeded frames (card against
    host), forwards with them and decodes against their encoding."""
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, length), dtype=np.int32))
    batch = {"tokens": prompt}
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        (full,), dt = sync_time(lambda: T.forward(params, cfg, on_card))
        scale = float(full.abs().max())
        enc = None
        if cfg.family == "audio":
            enc = T.encode(params, cfg, on_card["frames"])
        if host is not None:
            held = [("forward", full, lambda: T.forward(host, cfg, batch)[0])]
            if enc is not None:
                held.append(("encode", enc, lambda: T.encode(host, cfg, batch["frames"])))
            for what, got, ref in held:
                t0 = time.perf_counter()
                want = ref()
                err = float((got.cpu() - want).abs().max())
                big = float(want.abs().max())
                print(f"  {tag}: {what} on the card against the host (float32, CPU, "
                      f"{time.perf_counter() - t0:.1f} s): max |d| {err:.3e}, "
                      f"largest magnitude {big:.4f}", flush=True)
                if not err <= LM_TIE * big:
                    fail(f"{tag}: the card's {what} is {err:.3e} from the host's")
        cache = T.init_cache(cfg, 1, length, dtype=torch.float32, device="cuda")
        if enc is not None:
            cache["enc_out"].copy_(enc)
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(length):
            logits, cache = T.serve_step(params, cfg, cache, on_card["tokens"][:, i:i + 1],
                                         torch.full((1,), i, dtype=torch.int32, device="cuda"))
            steps.append(logits[0])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / length
        err = float((torch.stack(steps) - full).abs().max())
    print(f"  {tag}: teacher-forced serve_step against forward: max |d| {err:.3e}, "
          f"max |logit| {scale:.4f}; forward of {length} tokens {1e3 * dt:.2f} ms, "
          f"a C=1 step {step_ms:.3f} ms", flush=True)
    if not err <= LM_TIE * scale:
        fail(f"{tag}: teacher-forced decode is {err:.3e} from forward")


def lm_tinyllama():
    """10a and 10b on TinyLlama-1.1B at full width and depth, float32."""
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import REJECTED, tree_leaves, tree_map
    from repro_torch.launch.serve import Request, SlotServer
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), dtype="float32")
    t0 = time.perf_counter()
    host = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    init_s = time.perf_counter() - t0
    params, copy_s = sync_time(lambda: tree_map(lambda x: x.cuda(), host))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  10a: {cfg.name} float32, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{n:,} parameters ({4 * n / 1e9:.2f} GB) drawn on the host in {init_s:.1f} s, "
          f"copied in {copy_s:.1f} s; TF32 {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    lm_forward_checks("10a", cfg, params, host)
    del host
    gc.collect()

    chk = LMCheck(cfg, params)
    rng = np.random.default_rng(0)
    reqs = lm_requests(rng, LM_REQUESTS, cfg.vocab, LM_PROMPT, LM_NEW)
    over = Request(LM_REQUESTS, rng.integers(0, cfg.vocab, LM_MAX_LEN - 8, dtype=np.int32),
                   max_new_tokens=16, budget=16)
    torch.cuda.reset_peak_memory_stats()
    srv, t = lm_serve(cfg, params, reqs + [over], capacity=LM_C, max_len=LM_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    print(f"  10b {lm_line(f'C={LM_C} fifo', srv, t)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if srv.statuses[over.rid] != REJECTED or srv.stats.rejected != 1 or len(srv.results[over.rid]):
        fail(f"10b: a {len(over.prompt)}+{over.max_new_tokens}-token request was not REJECTED")
    if srv.stats.requests_done != LM_REQUESTS or any(
            len(srv.results[r.rid]) != r.max_new_tokens for r in reqs):
        fail("10b: a request did not finish with its max_new_tokens")
    main = {r.rid: srv.results[r.rid] for r in reqs}

    smallest = min(chk.greedy(f"10b request {r.rid} against greedy forward", r.prompt,
                              main[r.rid]) for r in reqs[:LM_REF])
    print(f"  10b: {LM_REF} requests against a no-cache greedy forward on the card: "
          f"smallest top-2 gap along the references {smallest:.3e} of max |logit|", flush=True)

    pair = reqs[:LM_PAIR]
    s1, t1 = lm_serve(cfg, params, pair, capacity=1, max_len=LM_MAX_LEN)
    s8, t8 = lm_serve(cfg, params, pair, capacity=LM_C, max_len=LM_MAX_LEN)
    print(f"  10b {lm_line('C=1', s1, t1)}", flush=True)
    print(f"  10b {lm_line(f'C={LM_C}', s8, t8)}", flush=True)
    same = sum(chk.same(f"10b request {r.rid}, C=1 against C={LM_C}", r.prompt,
                        s1.results[r.rid], s8.results[r.rid])
               & chk.same(f"10b request {r.rid}, C={LM_C} of {LM_PAIR} against of "
                          f"{LM_REQUESTS}", r.prompt, s8.results[r.rid], main[r.rid])
               for r in pair)
    # superstep sharing shows in the decode-only rate; the end-to-end rate
    # also holds the same table-wide prefill steps at either C
    decode = (t1["wall_s"] - t1["prefill_s"]) / (t8["wall_s"] - t8["prefill_s"])
    ratio = t1["wall_s"] / t8["wall_s"]
    print(f"  10b: {same} of {LM_PAIR} requests identical at C=1, at C={LM_C} and in the "
          f"{LM_REQUESTS}-request run; C={LM_C} / C=1 decode-only tok/s {decode:.3f} "
          f"(end to end, with the table-wide prefill, {ratio:.3f})", flush=True)
    # the profiler's cost grows with the kernels traced (146 s for the
    # 487 steps above), so the busy share is read on a short mix: 8
    # requests of 4 + 4 tokens, 36 table-wide steps
    short = lm_requests(np.random.default_rng(3), LM_C, cfg.vocab, (4, 4), (4, 4))
    _, ts = lm_serve(cfg, params, short, capacity=LM_C, max_len=LM_MAX_LEN)
    busy, gemm = device_breakdown(lambda: lm_serve(cfg, params, short, capacity=LM_C,
                                                   max_len=LM_MAX_LEN),
                                  ts["wall_s"], f"10b C={LM_C}, {LM_C} requests of 4 + 4 "
                                  "tokens", kernel="gemm")
    if busy:
        print(f"  10b: {100 * gemm / busy:.1f} % of the device time in GEMM kernels "
              f"(names holding 'gemm')", flush=True)

    # preemptive sjf at C=2: two long requests hold both slots, six short
    # ones arrive after the first round
    longs = lm_requests(np.random.default_rng(1), 2, cfg.vocab, (64, 64), (64, 64))
    shorts = [dataclasses.replace(r, rid=r.rid + 2) for r in
              lm_requests(np.random.default_rng(2), 6, cfg.vocab, (16, 16), (4, 4))]
    runs = {}
    for preemptive in (True, False):
        srv = SlotServer(cfg, params, capacity=2, max_len=LM_MAX_LEN, scheduler="sjf",
                         preemptive=preemptive, device="cuda")
        for r in longs:
            srv.submit(r)
        srv.run_round()
        for r in shorts:
            srv.submit(r)
        order = []
        t0 = time.perf_counter()
        while srv.runtime.pending() or srv.runtime.live.any():
            before = set(srv.results)
            srv.run_round()
            order += sorted(set(srv.results) - before)
        runs[preemptive] = (srv, order, time.perf_counter() - t0)
    srv, order, dt = runs[True]
    if max(order.index(r.rid) for r in shorts) > min(order.index(r.rid) for r in longs):
        fail(f"10b preemptive sjf: retirement order {order}")
    if not srv.stats.preemptions:
        fail("10b preemptive sjf: no request was suspended")
    for r in longs + shorts:
        chk.same(f"10b preemptive sjf request {r.rid} against uninterrupted", r.prompt,
                 srv.results[r.rid], runs[False][0].results[r.rid])
    print(f"  10b preemptive sjf, C=2: retirement order {order} ({srv.stats.preemptions} "
          f"suspensions, {srv.stats.resumes} resumes, {dt:.2f} s; without preemption "
          f"{runs[False][1]}, {runs[False][2]:.2f} s)", flush=True)
    return chk


def lm_gemma():
    """10c: gemma2-9b at full width, depth cut to GEMMA_LAYERS, float32, its
    weights drawn on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import tree_leaves
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch("gemma2-9b"), dtype="float32", n_layers=GEMMA_LAYERS)
    params, init_s = sync_time(lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda"))
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  10c: {cfg.name} float32, {cfg.n_layers} layers "
          f"({T.n_stacked(cfg)} stacked {'/'.join(cfg.attn_pattern)} super-blocks), "
          f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, softcaps {cfg.attn_softcap}/"
          f"{cfg.final_softcap}: {n:,} parameters ({4 * n / 1e9:.2f} GB) drawn on the "
          f"card in {init_s:.1f} s", flush=True)
    lm_forward_checks("10c", cfg, params)
    chk = LMCheck(cfg, params)
    reqs = lm_requests(np.random.default_rng(1), GEMMA_REQUESTS, cfg.vocab, (8, 32), (8, 24))
    torch.cuda.reset_peak_memory_stats()
    s4, t4 = lm_serve(cfg, params, reqs, capacity=GEMMA_C, max_len=GEMMA_MAX_LEN)
    peak = torch.cuda.max_memory_allocated()
    s1, t1 = lm_serve(cfg, params, reqs, capacity=1, max_len=GEMMA_MAX_LEN)
    print(f"  10c {lm_line(f'C={GEMMA_C}', s4, t4)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  10c {lm_line('C=1', s1, t1)}", flush=True)
    same = sum(chk.same(f"10c request {r.rid}, C=1 against C={GEMMA_C}", r.prompt,
                        s1.results[r.rid], s4.results[r.rid]) for r in reqs)
    print(f"  10c: {same} of {len(reqs)} requests identical at C=1 and C={GEMMA_C}",
          flush=True)
    return chk


def phase_lm() -> None:
    """Phase 10: LM serving on the card (10a forward and decode checks, 10b
    serving, on TinyLlama-1.1B; 10c gemma2-9b cut to 8 layers).  No
    frontier kernel launches here."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default, held
    take_counts()
    print("phase 10: LM serving (models/*, launch/serve.py), float32", flush=True)
    gaps = []
    for name, part in (("10a-10b", lm_tinyllama), ("10c", lm_gemma)):
        t = time.perf_counter()
        gaps += part().diverged
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if take_counts()[0]:
        fail("phase 10 launched the frontier kernel")
    where = (f"{len(gaps)} near-tie divergences, smallest gap {min(gaps):.3e}"
             if gaps else "no stream diverged")
    print(f"phase 10: {where}; no frontier kernel launch; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 11
FAM_C, FAM_MAX_LEN, FAM_REQUESTS = 4, 64, 8  # 11a, 11b, 11d: slot table and load
FAM_PROMPT, FAM_NEW = (8, 32), (8, 24)       # drawn from default_rng(1), as 10c
MAMBA_PROMPT = 320     # 11a: two SSD chunks of 256, so the inter-chunk recurrence runs
REC_PROMPT = 64        # 11b's teacher-forced prompt
DEEPSEEK_LAYERS = 2    # 11c: deepseek-v2-236b's depth, cut from 60 (stacked)
DEEPSEEK_C = 8
DEEPSEEK_REF = 4       # 11c requests held against a no-cache greedy forward


def fam_model(tag: str, cfg, on: str):
    """Draw ``cfg``'s float32 parameters from a seeded generator, on the
    host (``on="host"``: returned too, as the reference's copy) or on the
    card; print their count, GB and weight-read bound per step."""
    from repro_torch.core.runtime import tree_leaves, tree_map
    from repro_torch.models import transformer as T

    host = None
    if on == "host":
        t0 = time.perf_counter()
        host = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        init_s = time.perf_counter() - t0
        params, copy_s = sync_time(lambda: tree_map(lambda x: x.cuda(), host))
        where = f"drawn on the host in {init_s:.1f} s, copied in {copy_s:.1f} s"
    else:
        params, init_s = sync_time(lambda: T.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), device="cuda"))
        where = f"drawn on the card in {init_s:.1f} s"
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  {tag}: {cfg.name} float32, {cfg.n_layers} layers ({T.n_stacked(cfg)} "
          f"stacked super-blocks), d {cfg.d_model}, vocab {cfg.vocab}: {n:,} parameters "
          f"({4 * n / 1e9:.2f} GB) {where}; weight-read bound per step "
          f"{1e3 * 4 * n / HBM_BYTES_PER_S:.3f} ms (float32 bytes over 3.35 TB/s)",
          flush=True)
    return params, host


def fam_run(tag: str, cfg, params, reqs, capacity: int, gaps=None, **kw):
    """Serve ``reqs`` on the card at ``capacity`` and print its line with
    the peak memory; every request must finish with its max_new_tokens."""
    torch.cuda.reset_peak_memory_stats()
    srv, t = lm_serve(cfg, params, reqs, capacity=capacity, gaps=gaps, **kw)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {tag} {lm_line(f'C={capacity}', srv, t)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if srv.stats.requests_done != len(reqs) or any(
            len(srv.results[r.rid]) != r.max_new_tokens for r in reqs):
        fail(f"{tag} C={capacity}: a request did not finish with its max_new_tokens")
    return srv


def identical(tag: str, a, b, reqs) -> None:
    """Two runs of one server configuration must give the same tokens."""
    bad = [r.rid for r in reqs if a.results[r.rid].tolist() != b.results[r.rid].tolist()]
    if bad:
        fail(f"{tag}: a repeated run changed the tokens of requests {bad}")
    print(f"  {tag}: the repeated run gave identical tokens on all {len(reqs)} requests",
          flush=True)


def differing(a, b, reqs) -> int:
    return sum(a.results[r.rid].tolist() != b.results[r.rid].tolist() for r in reqs)


def fam_busy(tag: str, cfg, params) -> None:
    """Device busy share on a short C=4 mix: 4 requests of 2 + 4 tokens, 12
    table-wide steps (the profiler took 24 s over 21 of mamba2's steps)."""
    short = lm_requests(np.random.default_rng(3), FAM_C, cfg.vocab, (2, 2), (4, 4))
    _, ts = lm_serve(cfg, params, short, capacity=FAM_C, max_len=FAM_MAX_LEN)
    device_breakdown(lambda: lm_serve(cfg, params, short, capacity=FAM_C,
                                      max_len=FAM_MAX_LEN),
                     ts["wall_s"], f"{tag} C={FAM_C}, {FAM_C} requests of 2 + 4 tokens",
                     kernel="gemm")


def fam_mamba2() -> list:
    """11a: mamba2-780m at full width and depth (48 stacked SSD layers)."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("mamba2-780m"), dtype="float32")
    params, host = fam_model("11a", cfg, "host")
    lm_forward_checks("11a", cfg, params, host, length=MAMBA_PROMPT)
    reqs = lm_requests(np.random.default_rng(1), FAM_REQUESTS, cfg.vocab, FAM_PROMPT, FAM_NEW)
    s4 = fam_run("11a", cfg, params, reqs, FAM_C, max_len=FAM_MAX_LEN)
    identical("11a C=4", s4, fam_run("11a", cfg, params, reqs, FAM_C, max_len=FAM_MAX_LEN),
              reqs)
    s1 = fam_run("11a", cfg, params, reqs, 1, max_len=FAM_MAX_LEN)
    print(f"  11a: {differing(s1, s4, reqs)} of {len(reqs)} requests differ between C=1 and "
          f"C={FAM_C} (the reference server's recurrent state takes in other slots' "
          "prefill steps; ROADMAP.md §3)", flush=True)
    fam_busy("11a", cfg, params)
    # the only independent check of the card's server: the two shortest
    # requests at C=2 through a SlotServer on the host, from the host copy
    pair = sorted(reqs, key=lambda r: len(r.prompt) + r.max_new_tokens)[:2]
    card2 = fam_run("11a", cfg, params, pair, 2, max_len=FAM_MAX_LEN)
    gaps, seen = {}, []
    t0 = time.perf_counter()
    host2, _ = lm_serve(cfg, host, pair, device="cpu", gaps=gaps, capacity=2,
                        max_len=FAM_MAX_LEN)
    same = sum(near_tie(f"11a request {r.rid}, the card's C=2 against the host's",
                        host2.results[r.rid], card2.results[r.rid],
                        gaps[r.rid].__getitem__, seen) for r in pair)
    print(f"  11a: requests {[r.rid for r in pair]} at C=2 on the host ({host2.stats.rounds} "
          f"rounds, {time.perf_counter() - t0:.1f} s): {same} of 2 identical to the card's",
          flush=True)
    return seen


def fam_recurrentgemma() -> list:
    """11b: recurrentgemma-2b at full width and depth (26 unrolled layers,
    rec/rec/attn), drawn on the card."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b"), dtype="float32")
    params, _ = fam_model("11b", cfg, "card")
    lm_forward_checks("11b", cfg, params, length=REC_PROMPT)
    reqs = lm_requests(np.random.default_rng(1), FAM_REQUESTS, cfg.vocab, FAM_PROMPT, FAM_NEW)
    s4 = fam_run("11b", cfg, params, reqs, FAM_C, max_len=FAM_MAX_LEN)
    identical("11b C=4", s4, fam_run("11b", cfg, params, reqs, FAM_C, max_len=FAM_MAX_LEN),
              reqs)
    s1 = fam_run("11b", cfg, params, reqs, 1, max_len=FAM_MAX_LEN)
    print(f"  11b: {differing(s1, s4, reqs)} of {len(reqs)} requests differ between C=1 and "
          f"C={FAM_C} (the reference server's recurrent state; ROADMAP.md §3)", flush=True)
    fam_busy("11b", cfg, params)
    return []


def fam_deepseek() -> list:
    """11c: deepseek-v2-236b at full width (MLA, 160 routed experts top-6 +
    2 shared), depth cut to DEEPSEEK_LAYERS, drawn on the card."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"), dtype="float32",
                              n_layers=DEEPSEEK_LAYERS)
    params, _ = fam_model("11c", cfg, "card")
    # the checks run where no assignment is dropped, as JAX's decode ==
    # prefill test does: a request's tokens then depend on nothing else
    every = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    print(f"  11c: checks at capacity_factor {every.capacity_factor} (n_experts); the "
          f"config's own is {cfg.capacity_factor}", flush=True)
    lm_forward_checks("11c", every, params)
    reqs = lm_requests(np.random.default_rng(1), FAM_REQUESTS, cfg.vocab, FAM_PROMPT, FAM_NEW)
    gaps, seen = {}, []
    s1 = fam_run("11c every", every, params, reqs, 1, gaps=gaps, max_len=FAM_MAX_LEN)
    s8 = fam_run("11c every", every, params, reqs, DEEPSEEK_C, max_len=FAM_MAX_LEN)
    same = sum(near_tie(f"11c request {r.rid}, C=1 against C={DEEPSEEK_C}",
                        s1.results[r.rid], s8.results[r.rid],
                        gaps[r.rid].__getitem__, seen) for r in reqs)
    print(f"  11c: {same} of {len(reqs)} requests identical at C=1 and C={DEEPSEEK_C}",
          flush=True)
    chk = LMCheck(every, params)
    smallest = min(chk.greedy(f"11c request {r.rid} against greedy forward", r.prompt,
                              s8.results[r.rid]) for r in reqs[:DEEPSEEK_REF])
    print(f"  11c: {DEEPSEEK_REF} requests against a no-cache greedy forward on the card: "
          f"smallest top-2 gap along the references {smallest:.3e} of max |logit|", flush=True)
    own = fam_run("11c own", cfg, params, reqs, DEEPSEEK_C, max_len=FAM_MAX_LEN)
    print(f"  11c: at capacity_factor {cfg.capacity_factor}, {differing(own, s8, reqs)} of "
          f"{len(reqs)} requests differ from the n_experts run (capacity "
          f"ceil({DEEPSEEK_C} x {cfg.experts_per_token} / {cfg.n_experts} x "
          f"{cfg.capacity_factor}) = "
          f"{math.ceil(DEEPSEEK_C * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)}"
          " per expert per step, shared by the slots; ROADMAP.md §3)", flush=True)
    fam_busy("11c own", cfg, params)
    return seen + chk.diverged


def fam_whisper() -> list:
    """11d: whisper-base at full width and depth (6 + 6 layers, 1,500
    frames), drawn on the host."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("whisper-base"), dtype="float32")
    params, host = fam_model("11d", cfg, "host")
    lm_forward_checks("11d", cfg, params, host)
    reqs = lm_requests(np.random.default_rng(1), FAM_REQUESTS, cfg.vocab, FAM_PROMPT, FAM_NEW)
    gaps, seen = {}, []
    s1 = fam_run("11d", cfg, params, reqs, 1, gaps=gaps, max_len=FAM_MAX_LEN)
    s4 = fam_run("11d", cfg, params, reqs, FAM_C, max_len=FAM_MAX_LEN)
    same = sum(near_tie(f"11d request {r.rid}, C=1 against C={FAM_C}", s1.results[r.rid],
                        s4.results[r.rid], gaps[r.rid].__getitem__, seen) for r in reqs)
    print(f"  11d: {same} of {len(reqs)} requests identical at C=1 and C={FAM_C} (the "
          "server's enc_out is zero, as in the reference)", flush=True)
    fam_busy("11d", cfg, params)
    return seen


def phase_families() -> None:
    """Phase 11: the other LM families on the card (11a mamba2, 11b
    recurrentgemma, 11c deepseek-v2 cut to 2 layers, 11d whisper), in
    float32 with TF32 off.  No frontier kernel launches here."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default, held
    take_counts()
    print("phase 11: the SSD, RG-LRU, MoE + MLA and encoder-decoder families "
          "(models/{ssm,rglru,mlp,transformer}.py, launch/serve.py), float32", flush=True)
    gaps = []
    for name, part in (("11a", fam_mamba2), ("11b", fam_recurrentgemma),
                       ("11c", fam_deepseek), ("11d", fam_whisper)):
        t = time.perf_counter()
        gaps += part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if take_counts()[0]:
        fail("phase 11 launched the frontier kernel")
    where = (f"{len(gaps)} near-tie divergences, smallest gap {min(gaps):.3e}"
             if gaps else "no held stream diverged")
    print(f"phase 11: {where}; no frontier kernel launch; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 12
TRAIN_BATCH, TRAIN_SEQ = 8, 2048  # 12a: 16,384 tokens a step, TinyLlama's pretraining context
TRAIN_MICRO = 2                   # 12a-12c: microbatches a step
TRAIN_WARM, TRAIN_TIMED = 2, 10   # 12a: warm-up and timed steps
TRAIN_PROFILED = 2                # 12a: steps under the profiler
BF16_PEAK = 989.4e12              # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA datasheet)
HOST_LAYERS = 2                   # 12b: TinyLlama's width, depth cut from 22
HOST_BATCH, HOST_SEQ = 2, 256     # 12b: the batch stepped on the card and on the host
FAMILY_SEQ = 64                   # 12c: past the reduced configs' 16-token chunks
DRILL_STEPS, DRILL_FAIL, DRILL_EVERY = 8, 5, 2  # 12d: tests/test_train.py's drill
TRAIN_CLI = ["--arch", "gemma2-9b", "--steps", "30", "--batch", "8", "--seq", "64",
             "--n-micro", "2", "--ckpt-every", "10", "--fail-at", "17"]  # examples/train_lm.py


def same_step(tag: str, got, want, device: str = "cpu") -> str:
    """Hold the card's step ``got`` against the host's ``want`` (both
    (params, opt_state, metrics)) by the rule of
    tests/_torch_train.py::assert_step_matches: loss and gradient norm
    within 1e-4 relative.  g is the gradient the host's AdamW received,
    read back from its first moment (step 1 from zero moments: mu =
    (1 - b1) * clip * g).  Moments within one bf16 ulp plus what a
    gradient difference of 1e-4 * |g| + 1e-6 moves them; under int8
    compression an element at a rounding tie may land one level apart
    (moments and residual one level of its tensor's scale apart), at most
    0.1 % of them.  Parameters within 1e-4 of their value or of lr (a new
    parameter near 0 is the difference of p and lr * delta) where
    |g| > 1e-5, both first moments have one nonzero sign and no level
    differs, or where both first moments are exactly 0 (the update is the
    weight decay alone); else within 2 * lr (step 1's update is ~ lr *
    g / |g|), and the count of those is printed.  The rule's float32
    arithmetic runs on ``device``.  Returns a summary for the part's
    line."""
    from repro_torch.core.runtime import tree_leaves
    from repro_torch.train.optimizer import OptConfig

    b1, b2 = OptConfig().betas
    (params, opt, m), (wp, wo, wm) = got, want
    loss, wloss = float(m["loss"]), float(wm["loss"])
    gn, wgn = float(m["grad_norm"]), float(wm["grad_norm"])
    if not (abs(loss - wloss) <= 1e-4 * abs(wloss) and abs(gn - wgn) <= 1e-4 * abs(wgn)):
        fail(f"{tag}: loss {loss} / {wloss}, grad norm {gn} / {wgn} (card / host)")
    if int(opt["step"]) != int(wo["step"]) or sorted(opt) != sorted(wo):
        fail(f"{tag}: optimizer state {sorted(opt)} step {int(opt['step'])}")
    lr = float(wm["lr"])
    clip = min(1.0, OptConfig().grad_clip / (wgn + 1e-9))

    def ulp(x):
        return torch.where(x != 0, torch.abs(x) * 2.0 ** -7, 2.0 ** -133)

    f = lambda t: t.detach().float().to(device)
    errs = zip(tree_leaves(opt["err"]), tree_leaves(wo["err"])) if "err" in wo else None
    worst = 0.0
    n_level = n_ulp = n_steady = n_all = 0
    for i, (p, q, mu, wmu, nu, wnu) in enumerate(zip(
            tree_leaves(params), tree_leaves(wp), tree_leaves(opt["mu"]),
            tree_leaves(wo["mu"]), tree_leaves(opt["nu"]), tree_leaves(wo["nu"]))):
        p, q, mu, wmu, nu, wnu = map(f, (p, q, mu, wmu, nu, wnu))
        g = wmu / ((1 - b1) * clip)
        dg = 1e-4 * g.abs() + 1e-6
        dm, dv = (mu - wmu).abs(), (nu - wnu).abs()

        def lims(d):
            return (ulp(wmu) + (1 - b1) * clip * d,
                    ulp(wnu) + (1 - b2) * clip ** 2 * d * (2 * g.abs() + d))

        m_lim, v_lim = lims(dg)
        off = torch.zeros_like(g, dtype=torch.bool)
        if errs is not None:
            e, we = map(f, next(errs))
            level = float(g.abs().max()) / 127 * (1 + 2.0 ** -7)
            off = (dm > m_lim) | (dv > v_lim)
            m_lim, v_lim = lims(dg + off * level)
            if bool(((e - we).abs() > dg + 1e-4 * 127 * level + off * level).any()):
                fail(f"{tag}: leaf {i}: error-feedback residuals apart")
        if bool((dm > m_lim).any()) or bool((dv > v_lim).any()):
            fail(f"{tag}: leaf {i}: moments {float(dm.max()):.3e} / {float(dv.max()):.3e} apart")
        # both first moments exactly 0 (no gradient on either side, as the
        # unseen tokens' embedding rows): the update is the same decay
        steady = (((g.abs() > 1e-5) & (torch.sign(mu) == torch.sign(wmu)) & ~off)
                  | ((mu == 0) & (wmu == 0)))
        dp = (p - q).abs()
        bound = torch.where(steady, 1e-4 * (q.abs() + lr), torch.full_like(q, 2 * lr))
        if bool((dp > bound).any()):
            j = int(torch.argmax(dp - bound))
            fail(f"{tag}: leaf {i} {tuple(q.shape)}: {int((dp > bound).sum())} parameters "
                 f"over; worst at {j}: card {float(p.flatten()[j])!r}, host "
                 f"{float(q.flatten()[j])!r}, host g {float(g.flatten()[j])!r}, first "
                 f"moments {float(mu.flatten()[j])!r} / {float(wmu.flatten()[j])!r}, "
                 f"clip {clip!r}, lr {lr!r}")
        if bool(steady.any()):
            worst = max(worst, float((dp / (q.abs() + lr))[steady].max()))
        n_level += int(off.sum())
        n_ulp += int((dm > ulp(wmu)).sum())
        n_steady += int(steady.sum())
        n_all += g.numel()
    if n_level > 1e-3 * n_all:
        fail(f"{tag}: {n_level} of {n_all} elements one int8 level apart")
    return (f"loss {loss:.6f} (host {wloss:.6f}), grad norm {gn:.6f} (host {wgn:.6f}); "
            f"{n_steady:,} of {n_all:,} parameters held to 1e-4 (max |d| / (|p| + lr) "
            f"{worst:.2e}), {n_all - n_steady:,} to 2 lr; {n_ulp:,} first moments over one "
            "bf16 ulp"
            + (f"; {n_level} elements one int8 level apart" if errs is not None else ""))


def card_and_host(tag: str, cfg, compression: bool, seq: int = HOST_SEQ) -> str:
    """One microbatched train step from the same host-drawn state on the
    card and on the host; returns ``same_step``'s summary."""
    from repro_torch.core.runtime import tree_map
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    opt_cfg = OptConfig(warmup_steps=1)
    host = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(0),
                            use_compression=compression, device="cpu")
    card = tree_map(lambda t: t.cuda(), host)
    batch = synthetic_batch(cfg, HOST_BATCH, seq, 0, 0)
    step = make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO, use_compression=compression,
                           donate=False)
    got, card_s = sync_time(lambda: step(*card, batch))
    t0 = time.perf_counter()
    want = step(*host, batch)
    host_s = time.perf_counter() - t0
    return (f"{same_step(tag, got, want)}; step {1e3 * card_s:.1f} ms on the card, "
            f"{host_s:.2f} s on the host")


def train_full() -> None:
    """12a: TinyLlama-1.1B at full width and depth in its own bfloat16."""
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import tree_leaves
    from repro_torch.train.data import Prefetcher, synthetic_stream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_arch("tinyllama-1.1b")
    steps = TRAIN_WARM + TRAIN_TIMED
    opt_cfg = OptConfig(warmup_steps=TRAIN_WARM, total_steps=steps)
    (params, opt), init_s = sync_time(lambda: init_train_state(
        cfg, opt_cfg, torch.Generator("cuda").manual_seed(0), device="cuda"))
    n = sum(x.numel() for x in tree_leaves(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * n + 12 * cfg.n_layers * TRAIN_SEQ * cfg.d_model) * tokens
    print(f"  12a: {cfg.name} {cfg.dtype}, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{n:,} parameters drawn on the card in {init_s:.1f} s; {opt_cfg.moment_dtype} "
          f"moments; batch {TRAIN_BATCH} x {TRAIN_SEQ} ({tokens:,} tokens a step), "
          f"n_micro {TRAIN_MICRO}, remat; TF32 {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    step = make_train_step(cfg, opt_cfg, n_micro=TRAIN_MICRO)
    probe = [params["embed_embed"][:8].clone(), params["blocks"][0]["wq_colp"][0, :8].clone()]
    stream = Prefetcher(synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0))
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        batch = next(stream)
        (params, opt, m), dt = sync_time(lambda: step(params, opt, batch))
        loss, gn, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        losses.append(loss)
        times.append(dt)
        print(f"    step {s}: loss {loss:.4f}, grad norm {gn:.4f}, lr {lr:.3e}, "
              f"{1e3 * dt:.1f} ms{' (warm-up)' if s < TRAIN_WARM else ''}", flush=True)
        if not (math.isfinite(loss) and math.isfinite(gn)):
            fail(f"12a: step {s}: loss {loss}, grad norm {gn}")
    peak = torch.cuda.max_memory_allocated()
    if torch.equal(probe[0], params["embed_embed"][:8]) or \
            torch.equal(probe[1], params["blocks"][0]["wq_colp"][0, :8]):
        fail("12a: the parameters did not move")
    step_s = statistics.mean(times[TRAIN_WARM:])
    a, b = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"  12a: {1e3 * step_s:.1f} ms per step (mean of {TRAIN_TIMED}; "
          f"{1e3 * min(times[TRAIN_WARM:]):.1f}-{1e3 * max(times[TRAIN_WARM:]):.1f}), "
          f"{tokens / step_s:.1f} tokens/s; mfu {100 * flops / (step_s * BF16_PEAK):.2f} % "
          f"({flops:.4e} model FLOPs a step: 6 N + 12 L S d per token, remat's recompute "
          f"not counted, over {BF16_PEAK / 1e12:.1f} TFLOP/s bf16 dense); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; loss {a:.4f} -> {b:.4f} "
          f"({'DOWN' if b < a else 'flat'})", flush=True)
    prof = [next(stream) for _ in range(TRAIN_PROFILED)]

    def run_profiled():
        nonlocal params, opt
        for batch in prof:
            params, opt, _ = step(params, opt, batch)

    busy, gemm = device_breakdown(run_profiled, TRAIN_PROFILED * step_s,
                                  f"12a {TRAIN_PROFILED} steps", kernel="gemm")
    if busy:
        print(f"  12a: {100 * gemm / busy:.1f} % of the device time in GEMM kernels "
              f"(names holding 'gemm')", flush=True)


def train_card_host() -> None:
    """12b: TinyLlama at full width cut to HOST_LAYERS, float32, one step on
    the card against the host, plain and with int8 compression."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), dtype="float32",
                              n_layers=HOST_LAYERS)
    print(f"  12b: {cfg.name} float32 at full width, {HOST_LAYERS} layers, batch "
          f"{HOST_BATCH} x {HOST_SEQ}, n_micro {TRAIN_MICRO}, drawn on the host", flush=True)
    for compression in (False, True):
        what = "int8 compression" if compression else "plain"
        print(f"  12b {what}: {card_and_host(f'12b {what}', cfg, compression)}", flush=True)


def train_families() -> None:
    """12c: every arch at reduced size, one step of HOST_BATCH x FAMILY_SEQ
    tokens on the card against the host."""
    from repro_torch.configs import get_arch, list_archs, reduced

    for arch in list_archs():
        got = card_and_host(f"12c {arch}", reduced(get_arch(arch)), False, FAMILY_SEQ)
        print(f"  12c {arch}: {got}", flush=True)


def train_drill(out_path: str) -> None:
    """12d's child (``chip_smoke.py --train-drill OUT``): tests/test_train.py's
    restart drill on the card under deterministic algorithms: a clean run
    of DRILL_STEPS steps, and one that fails at DRILL_FAIL and restarts from
    its checkpoint every DRILL_EVERY steps; writes whether their final
    parameters are bit-identical."""
    torch.use_deterministic_algorithms(True)  # before the first CUDA call
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.runtime import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.fault import FailureInjector, run_with_restarts
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = reduced(get_arch("tinyllama-1.1b"))
    opt_cfg = OptConfig(warmup_steps=2, total_steps=50)
    t0 = time.perf_counter()

    def train(ckpt_dir=None, injector=None):
        params, opt = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(0),
                                       device="cuda")
        start = 0
        if ckpt_dir:
            state, got = ckpt.restore(ckpt_dir, {"params": params, "opt": opt})
            if state is not None:
                params, opt, start = state["params"], state["opt"], got
        step = make_train_step(cfg, opt_cfg, donate=False)
        for s in range(start, DRILL_STEPS):
            if injector:
                injector.check(s)
            params, opt, _ = step(params, opt, synthetic_batch(cfg, 4, 16, 7, s))
            if ckpt_dir and (s + 1) % DRILL_EVERY == 0:
                ckpt.save(ckpt_dir, s + 1, {"params": params, "opt": opt})
        return params

    clean = train()
    d = tempfile.mkdtemp()
    try:
        inj = FailureInjector({DRILL_FAIL})
        final, restarts = run_with_restarts(lambda start: (train(d, inj), DRILL_STEPS)[1],
                                            lambda: ckpt.latest_step(d))
        got = train(d)  # restores the last checkpoint, at DRILL_STEPS
    finally:
        shutil.rmtree(d, ignore_errors=True)
    pairs = list(zip(tree_leaves(got), tree_leaves(clean)))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    with open(out_path, "w") as f:
        json.dump(dict(identical=all(torch.equal(a, b) for a, b in pairs), max_abs_diff=diff,
                       final=final, restarts=restarts, leaves=len(pairs),
                       deterministic=torch.are_deterministic_algorithms_enabled(),
                       seconds=time.perf_counter() - t0), f)


def train_restarts() -> None:
    """12d: the training CLI on the card with a failure and a restart, then
    the deterministic restart drill in a child process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tempfile.mkdtemp()
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda",
               *TRAIN_CLI, "--ckpt-dir", d]
        p, wall = sync_time(lambda: subprocess.run(cmd, capture_output=True, text=True,
                                                   env=env, timeout=600))
        for line in p.stdout.strip().splitlines():
            print(f"    {line}", flush=True)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        if p.returncode != 0 or last != "[train] finished at step 30 with 1 restart(s)":
            fail(f"12d: train CLI rc={p.returncode}\n{p.stderr[-3000:]}")
        print(f"  12d CLI ({' '.join(TRAIN_CLI)}) on cuda: rc 0, {wall:.1f} s with "
              "start-up", flush=True)
        out = os.path.join(d, "drill.json")
        # cuBLAS needs its workspace fixed before its first handle for
        # deterministic results; this process made its handles long ago
        p, wall = sync_time(lambda: subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--train-drill", out],
            capture_output=True, text=True, timeout=600,
            env=dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8")))
        if p.returncode != 0 or not os.path.exists(out):
            fail(f"12d: drill rc={p.returncode}\n{p.stderr[-3000:]}")
        with open(out) as f:
            r = json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"  12d drill (tinyllama reduced, {DRILL_STEPS} steps, a failure at step "
          f"{DRILL_FAIL}, checkpoints every {DRILL_EVERY}, deterministic algorithms "
          f"{r['deterministic']}): finished at step {r['final']} with {r['restarts']} "
          f"restart(s); final parameters of the restarted run "
          f"{'bit-identical to' if r['identical'] else 'DIFFER from'} the clean run's "
          f"({r['leaves']} leaves, max |d| {r['max_abs_diff']:.3e}); {r['seconds']:.1f} s "
          f"in the child, {wall:.1f} s with start-up", flush=True)
    if not (r["identical"] and r["deterministic"] and r["restarts"] == 1
            and r["final"] == DRILL_STEPS):
        fail("12d: the restarted run is not bit-identical to the clean run")


def phase_train() -> None:
    """Phase 12: LM training on the card (12a TinyLlama-1.1B in bf16 at full
    width and depth; 12b and 12c card against host; 12d the CLI's restart
    and the deterministic drill).  No frontier kernel launches here."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # torch's default, held
    take_counts()
    print("phase 12: LM training (train/*, models/* backward, launch/train.py)", flush=True)
    for name, part in (("12a", train_full), ("12b", train_card_host),
                       ("12c", train_families), ("12d", train_restarts)):
        t = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if take_counts()[0]:
        fail("phase 12 launched the frontier kernel")
    print(f"phase 12: no frontier kernel launch; {time.perf_counter() - t0:.1f} s",
          flush=True)


# ------------------------------------------------------------ phase 13
KV_SHAPE = dict(H=56, KV=8, D=128, S=4096)  # 13a: llava-next-34b's heads, 56 on 8-way TP
KV_ROW = 1500          # 13a: the query row held against the host (in its 2nd chunk)
DIST_BATCH, DIST_SEQ = 4, 64    # 13c: tokens of the four-rank step
DIST_OVER = dict(n_layers=2, dtype="float32")  # 13c: TinyLlama's width, depth cut from 22
QUEGEL_LOG_V = 26      # 13d: |V| = 2^26
QUEGEL_LOG_E = 28      # 13d: 2^31 edges over the (32, 8) mesh's 8-way 'model': 2^28 a device
QUEGEL_C = 8
QUEGEL_REPS = 3


def kv_attention() -> None:
    """13a: kv_shard attention at llava-next-34b's head shape on the card,
    float32, TF32 off: against kv_shard=False on the card and one row
    against the host's kv_shard=True."""
    from repro_torch.models.attention import causal_attention

    H, KV, D, S = (KV_SHAPE[k] for k in ("H", "KV", "D", "S"))
    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((1, S, h, D), generator=g) for h in (H, KV, KV))
    qc, kc, vc = q.cuda(), k.cuda(), v.cuda()
    out = {}
    for kv in (True, False):
        f = lambda: causal_attention(qc, kc, vc, kv_shard=kv)
        out[kv] = f()
        out[kv, "ms"] = event_ms(f, 3)
    scale = float(out[False].abs().max())
    err = float((out[True] - out[False]).abs().max())
    if err > 1e-5 * scale:
        fail(f"13a: kv_shard=True differs from kv_shard=False by {err} (max |out| {scale})")
    n = KV_ROW + 1  # causal: row KV_ROW sees keys 0..KV_ROW only
    host = causal_attention(q[:, :n], k[:, :n], v[:, :n], kv_shard=True)[:, -1]
    herr = float((out[True][:, KV_ROW].cpu() - host).abs().max())
    if herr > 1e-5 * scale:
        fail(f"13a: row {KV_ROW} differs from the host's kv_shard=True by {herr}")
    print(f"  13a kv_shard attention, H {H} over {KV} KV heads of {D}, S {S}, B 1, float32: "
          f"kv_shard=True {out[True, 'ms']:.3f} ms, kv_shard=False (chunked online softmax) "
          f"{out[False, 'ms']:.3f} ms on the card; max |d| {err:.3e} of max |out| "
          f"{scale:.3f} (bound 1e-5 x); row {KV_ROW} against the host's kv_shard=True: "
          f"{herr:.3e}", flush=True)


def fake_cell(world: int, shape: tuple, device: str, arch: str, over: dict, seq: int,
              batch: int, n_micro: int, tp=None):
    """Start the dry run of one train cell on a fake group of ``world``
    ranks over a ``device``-typed mesh of ``shape`` ("data", "model"), the
    type of the real run it is held against, in a child process (a
    process holds one default group); ``fake_counts`` reads its counts.
    ``tp``: the policy's TP switch (None: the dry run's own, by size)."""
    code = f"""
import dataclasses as dc, json, torch
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common as MC
DR.fake_group({world})
mesh = make_mesh({shape!r}, ("data", "model"), device_type={device!r})
MC.set_mesh(mesh)
cfg = dc.replace(get_arch({arch!r}), **{over!r})
sc = dc.replace(SHAPES["train_4k"], seq_len={seq}, global_batch={batch})
axes, _ = DR.parallelism(cfg, sc, mesh, False)
if {tp!r} is not None:
    MC.set_tp({tp!r}); MC.set_fsdp(True); axes = ("data",)
c = DR._lower_one(cfg, sc, mesh, axes, {n_micro})
print(json.dumps(dict(c, axes=list(axes), tp=MC._TP_ENABLED, fsdp=MC._FSDP_PARAMS)))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def fake_counts(p) -> dict:
    """The counts a ``fake_cell`` child printed."""
    try:
        out, err = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    if p.returncode != 0:
        fail(f"fake dry run: rc {p.returncode}\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def dist_one_rank(mesh, fake) -> None:
    """13b: TinyLlama-1.1B in bf16 on the (1, 1) NCCL mesh: one step on
    DTensors placed by param_spec against the plain step from the same
    state and batch; its local FLOPs against the dry run of the same cell
    on a one-rank fake mesh (``fake``, a ``fake_cell`` child); DTensor
    dispatch's cost at one rank."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.runtime import tree_leaves, tree_map
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import common as MC
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_arch("tinyllama-1.1b")
    sc = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    MC.set_mesh(mesh)
    try:
        axes, _ = DR.parallelism(cfg, sc, mesh, False)
        params, opt = init_train_state(cfg, OptConfig(), torch.Generator("cuda").manual_seed(0),
                                       device="cuda")
        twin = tree_map(lambda t: t.clone(), params)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, 0).items()}
        step = make_train_step(cfg, OptConfig(), n_micro=TRAIN_MICRO)
        want = tree_map(lambda t: t.cpu(), step(params, opt, batch))
        # timed warm: run alone, the step above is the process's first
        plain_s = sync_time(lambda: step(params, opt, batch))[1]
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        dstep, args = DR.place_step_inputs(cfg, sc, mesh, axes, TRAIN_MICRO, params=twin,
                                           batch=batch)
        del twin
        torch.cuda.reset_peak_memory_stats()
        (got, counts), first_s = sync_time(lambda: DR.run_counted(dstep, args, mesh))
        peak = torch.cuda.max_memory_allocated()
        got = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, got)
        summary = same_step("13b", got, want, device="cuda")
        del got
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            _, dt_s = sync_time(lambda: dstep(*args))
        tp = MC._TP_ENABLED
    finally:
        MC.set_mesh(None)
        MC.set_tp(True)
        MC.set_fsdp(True)
        fake = fake_counts(fake)
    if counts["flops"] != fake["flops"]:
        fail(f"13b: the step's local FLOPs {counts['flops']:.6e} != the one-rank fake dry "
             f"run's {fake['flops']:.6e}")
    print(f"  13b {cfg.name} {cfg.dtype} on the (1, 1) NCCL mesh, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, n_micro {TRAIN_MICRO}, remat, batch axes {axes}, TP {tp}: "
          f"DTensor step == plain step ({summary})", flush=True)
    print(f"  13b ms per step: plain tensors {1e3 * plain_s:.1f}, DTensors "
          f"{1e3 * dt_s:.1f} ({dt_s / plain_s:.3f}x: DTensor dispatch at one rank); the "
          f"counted first DTensor step {1e3 * first_s:.1f} ms", flush=True)
    print(f"  13b local FLOPs {counts['flops']:.6e} == the one-rank fake dry run's "
          f"{fake['flops']:.6e}; bytes {counts['bytes']:.6e} (fake {fake['bytes']:.6e}), "
          f"collective bytes {counts['coll']:.0f} (fake {fake['coll']:.0f}); "
          f"max_memory_allocated {peak / 2**30:.3f} GiB against MemTracker's peak "
          f"{counts['peak_bytes'] / 2**30:.3f} GiB on the card and "
          f"{fake['peak_bytes'] / 2**30:.3f} GiB fake-traced (ratio "
          f"{peak / max(fake['peak_bytes'], 1):.3f}, reported, not gated)", flush=True)


def dist_rank(out_path: str) -> None:
    """One of 13c's ranks (``chip_smoke.py --dist-rank OUT``, torchrun's
    environment, a file:// rendezvous at OUT.rdv): the four-rank train
    step of TinyLlama's width cut to 2 layers (DIST_OVER) on a (2, 2) mesh over
    gloo, with CPU tensors: DTensor's functional collectives on gloo with
    CUDA tensors end in a segmentation fault under torch 2.11 (cu128)."""
    import pickle

    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.runtime import tree_map
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as MC
    from repro_torch.train.data import synthetic_batch
    from repro_torch.models import transformer as T

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{out_path}.rdv", world_size=world,
                            rank=rank)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    MC.set_mesh(mesh)
    MC.set_tp(True)
    MC.set_fsdp(True)
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), **DIST_OVER)
    sc = dataclasses.replace(SHAPES["train_4k"], seq_len=DIST_SEQ, global_batch=DIST_BATCH)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in synthetic_batch(cfg, DIST_BATCH, DIST_SEQ, 0, 0).items()}
    step, args = DR.place_step_inputs(cfg, sc, mesh, ("data",), TRAIN_MICRO, params=params,
                                      batch=batch)
    dist.barrier()
    t0 = time.perf_counter()
    got, counts = DR.run_counted(step, args, mesh)
    dt = time.perf_counter() - t0
    got = tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu(), got)
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(dict(step=got, coll=counts["coll_detail"], s=dt), f)
    dist.destroy_process_group()


def dist_ranks_start(tmp):
    """Start 13c's four gloo ranks (host work only), so that they run
    beside 13a and 13b; ``dist_four_ranks`` reads them."""
    out = os.path.join(tmp, "dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-rank", out],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    return procs, out, time.perf_counter()


def dist_four_ranks(ranks, fake) -> None:
    """13c: four gloo ranks on the host on a (2, 2) mesh (``ranks``, from
    ``dist_ranks_start``): the sharded step against the single-process
    step on the card, and its collective bytes against the fake-mode dry
    run of the same shapes on a CPU-typed mesh (``fake``, a ``fake_cell``
    child)."""
    import pickle

    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import tree_leaves, tree_map
    from repro_torch.launch import roofline as RL
    from repro_torch.models import transformer as T
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    procs, out, t0 = ranks
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b"), **DIST_OVER)
    logs = []
    try:
        try:
            params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
            batch = synthetic_batch(cfg, DIST_BATCH, DIST_SEQ, 0, 0)
            want = make_train_step(cfg, OptConfig(), n_micro=TRAIN_MICRO)(
                params, adamw_init(params, OptConfig()), batch)
            want = tree_map(lambda t: t.cpu(), want)
        finally:
            fake = fake_counts(fake)
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"13c: ranks exited {[p.returncode for p in procs]}\n"
             + "\n".join(text[-3000:] for text in logs))
    for r in range(4):
        with open(f"{out}.{r}", "rb") as f:
            got = pickle.load(f)
        if r == 0:
            summary, first = same_step("13c rank 0", got["step"], want), got["step"]
        elif not all(torch.equal(a, b) for a, b in zip(tree_leaves(got["step"]),
                                                       tree_leaves(first))):
            fail(f"13c rank {r}: its full state differs from rank 0's")
        if got["coll"] != fake["coll_detail"]:
            fail(f"13c rank {r}: collectives {got['coll']} != the fake dry run's "
                 f"{fake['coll_detail']}")
        if r == 0:
            c = got["coll"]
            print(f"  13c 4 gloo ranks on the host (CPU tensors), (2, 2) mesh, {cfg.name} "
                  f"width, {cfg.n_layers} layers, {cfg.dtype}, batch {DIST_BATCH} x {DIST_SEQ}, "
                  f"n_micro {TRAIN_MICRO}, TP on 'model' + FSDP on 'data': == the "
                  f"single-process step on the card ({summary})", flush=True)
            print(f"  13c collective bytes a rank {c['total']:,} in {c['count']} "
                  f"collectives ({', '.join(f'{k} {c[k]:,}' for k in RL.KINDS if c[k])}; "
                  f"by mesh dim {c['by_dim']}) == the fake-mode dry run's; the counted step "
                  f"{got['s']:.3f} s on the host (gloo collectives, not NCCL; one thread a "
                  f"rank, beside 13a-13b)", flush=True)
    print(f"  13c: rank 0 == the single-process step, every rank == rank 0 bit for bit; "
          f"{time.perf_counter() - t0:.1f} s since the ranks started", flush=True)


def quegel_round(mesh) -> None:
    """13d: the Quegel super-round for real on one rank, at |V| = 2^26, C = 8
    and the (32, 8) mesh's per-device edge shard; a reduced round bit-equal
    on the card and on the host."""
    from repro_torch.launch import dryrun_quegel as DQ
    from repro_torch.launch import roofline as RL
    from repro_torch.core.semiring import INF

    small = DQ.round_inputs(16, 20, QUEGEL_C, 1, seed=3)
    host = DQ.super_round(*[torch.as_tensor(a) for a in small])
    card = DQ.super_round(*[torch.as_tensor(a).cuda() for a in small])
    if not all(torch.equal(a, b.cpu()) for a, b in zip(host, card)):
        fail("13d: the reduced super-round differs between the card and the host")
    if not bool(host[2].any()):
        fail("13d: the reduced super-round grew no frontier")
    V, E, C = 2 ** QUEGEL_LOG_V, 2 ** QUEGEL_LOG_E, QUEGEL_C
    est = dict(dist=2 * C * V * 4, frontiers=2 * C * V, edges=3 * E * 4 + E,
               gather=2 * C * E * 4, index=2 * E * 8)
    print(f"  13d reduced round (|V| 2^16, |E| 2^20, C {C}, int32): card == host, bit for "
          f"bit; full round reckoned at {sum(est.values()) / 1e9:.2f} GB ("
          + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in est.items()) + ")", flush=True)
    g = torch.Generator("cuda").manual_seed(4)
    src = torch.randint(0, V, (1, E), generator=g, device="cuda", dtype=torch.int32)
    dst = torch.randint(0, V, (1, E), generator=g, device="cuda", dtype=torch.int32)
    rows = torch.arange(C, device="cuda")
    st = torch.randint(0, V, (C, 2), generator=g, device="cuda")
    dist_s = torch.full((C, V), INF, dtype=torch.int32, device="cuda")
    dist_t = torch.full((C, V), INF, dtype=torch.int32, device="cuda")
    dist_s[rows, st[:, 0]] = 0
    dist_t[rows, st[:, 1]] = 0
    ins = DQ.distribute_inputs([src, dst, torch.ones_like(src),
                                torch.ones(src.shape, dtype=torch.bool, device="cuda"),
                                dist_s, dist_t, dist_s < INF, dist_t < INF,
                                torch.ones(C, dtype=torch.bool, device="cuda")],
                               mesh)
    del src, dst, dist_s, dist_t
    torch.cuda.reset_peak_memory_stats()
    run = lambda: DQ.super_round(*ins, mesh=mesh)
    with RL.CostMode(mesh) as cm:
        out = run()
    torch.cuda.synchronize()
    grown = int(out[2].to_local().sum())
    del out
    ms = event_ms(run, QUEGEL_REPS)
    peak = torch.cuda.max_memory_allocated()
    t_mem = cm.local_bytes / RL.HBM_BW
    print(f"  13d super-round at |V| 2^{QUEGEL_LOG_V}, |E| 2^{QUEGEL_LOG_E} (a device's "
          f"shard of 2^31 on 8-way 'model'), C {C}, one rank: {ms:.3f} ms per round (median "
          f"of {QUEGEL_REPS}); the port's unfused byte count {cm.local_bytes / 1e9:.3f} GB "
          f"over {RL.HBM_BW / 1e12:.2f} TB/s = {1e3 * t_mem:.3f} ms ({t_mem * 1e3 / ms:.3f} "
          f"of the round); {grown} frontier entries grew; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    del ins


def dryruns_start(tmp) -> list:
    """13e's fake dry runs, started as children (CPU only): the Quegel round
    at |V| 2^26, |E| 2^31 on both production meshes; tinyllama train_4k and
    decode_32k on (32, 8)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    out = os.path.join(tmp, "dryrun")
    cmds = [["-m", "repro_torch.launch.dryrun_quegel", "--out", out],
            ["-m", "repro_torch.launch.dryrun_quegel", "--multi-pod", "--out", out],
            ["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape",
             "train_4k", "--out", out],
            ["-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape",
             "decode_32k", "--out", out]]
    return [(c, subprocess.Popen([sys.executable, *c], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)) for c in cmds], out


def dryruns_finish(started) -> None:
    """13e: read the fake dry runs' JSON and print their numbers."""
    from repro_torch.launch import roofline as RL

    procs, out = started
    for cmd, p in procs:
        log = p.communicate(timeout=600)[0]
        if p.returncode != 0:
            fail(f"13e: {' '.join(cmd)} rc {p.returncode}\n{log[-3000:]}")
    for name in ("quegel-bibfs_sp", "quegel-bibfs_mp", "tinyllama-1.1b_train_4k_sp",
                 "tinyllama-1.1b_decode_32k_sp"):
        with open(os.path.join(out, name + ".json")) as f:
            r = json.load(f)
        if r["status"] != "compiled":
            fail(f"13e: {name}: {r['status']}")
        mem = r["memory"]
        if "roofline" in r:
            rl = r["roofline"]
            flops, byts, coll, detail = (rl["flops"], rl["bytes_accessed"], rl["coll_bytes"],
                                         rl["coll_detail"])
        else:
            flops, byts, coll, detail = r["flops"], r["bytes"], r["coll_bytes"], r["coll_detail"]
        t = RL.Roofline(r["arch"], r["shape"], r["mesh"], flops, byts, coll, detail, 0.0, 0.0)
        on = r["traced_on"]
        print(f"  13e {r['arch']} {r['shape']} on {r['mesh']} ({on['counts']}; a "
              f"{on['mesh_device_type']} mesh of {on['world']} fake ranks, Shard-to-Shard "
              f"counted as all-to-all): "
              f"per device {(mem['arg_bytes'] + mem['temp_bytes']) / 1e9:.3f} GB (args "
              f"{mem['arg_bytes'] / 1e9:.3f} + temp {mem['temp_bytes'] / 1e9:.3f}), FLOPs "
              f"{flops:.4e}, bytes {byts:.4e}, collective bytes {coll:.4e} "
              f"{detail.get('by_dim', {})}; roofline compute {1e3 * t.t_compute:.3f} ms, "
              f"memory {1e3 * t.t_memory:.3f} ms, collective {1e3 * t.t_collective:.3f} ms "
              f"-> {t.bottleneck}"
              + (f"; open: {on['open']}" if "open" in on else ""), flush=True)


def dist_children(tmp):
    """Phase 13's CPU children: the fake dry runs 13b and 13c compare with,
    and 13e's.  ``main`` starts them before phase 12 (13b's is the longest,
    ~1 min, and phase 12 leaves the host mostly idle)."""
    fakes = [fake_cell(1, (1, 1), "cuda", "tinyllama-1.1b", {}, TRAIN_SEQ, TRAIN_BATCH,
                       TRAIN_MICRO),
             fake_cell(4, (2, 2), "cpu", "tinyllama-1.1b", DIST_OVER, DIST_SEQ, DIST_BATCH,
                       TRAIN_MICRO, tp=True)]
    return fakes, dryruns_start(tmp)


def phase_dist(children=None, tmp=None) -> None:
    """Phase 13: the sharding layer and the dry runs (13a kv_shard attention,
    13b one NCCL rank, 13c four gloo ranks, 13d the Quegel super-round,
    13e the fake dry runs).  ``children``: ``dist_children(tmp)``, started
    by the caller (else here).  No frontier kernel launches here."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    take_counts()
    print("phase 13: the sharding layer, attention's kv_shard path and the dry runs",
          flush=True)
    own = tmp is None  # a caller's tmp (and 13e's JSON in it) outlives the phase
    tmp = tmp or tempfile.mkdtemp()
    fakes, started = children or dist_children(tmp)
    ranks = dist_ranks_start(tmp)
    try:
        t = time.perf_counter()
        kv_attention()
        print(f"  13a: {time.perf_counter() - t:.1f} s", flush=True)
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv13b')}",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            t = time.perf_counter()
            dist_one_rank(mesh, fakes[0])
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  13b: {time.perf_counter() - t:.1f} s", flush=True)
            t = time.perf_counter()
            dist_four_ranks(ranks, fakes[1])
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  13c: {time.perf_counter() - t:.1f} s", flush=True)
            t = time.perf_counter()
            quegel_round(mesh)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  13d: {time.perf_counter() - t:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
        t = time.perf_counter()
        dryruns_finish(started)
        print(f"  13e: {time.perf_counter() - t:.1f} s waiting", flush=True)
    finally:
        for p in fakes + ranks[0] + [p for _, p in started[0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    if take_counts()[0]:
        fail("phase 13 launched the frontier kernel")
    print(f"phase 13: no frontier kernel launch; {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phase 14
def rendered(argv: list) -> str:
    """What the port's report prints for ``argv``, run in this process."""
    import contextlib
    import io

    from repro_torch.launch import report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main(argv)
    if rc != 0:
        fail(f"14: report.main({argv}) returned {rc}")
    return buf.getvalue()


def report_child(argv: list):
    """``python -m repro_torch.launch.report`` as a CPU child, from the root."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.report", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def child_out(what: str, p) -> str:
    out, err = p.communicate(timeout=300)
    if p.returncode != 0:
        fail(f"{what}: the report CLI exited {p.returncode}\n{err[-3000:]}")
    return out


def report_dryruns(d: str, child) -> None:
    """14a: 13e's four JSONs through the report, in a child and in-process."""
    from repro_torch.launch import report
    from repro_torch.launch.mesh import MESH_NAMES

    text = rendered(["--dir", d])
    if child_out("14a", child) != text:
        fail("14a: the CLI child's dry-run tables differ from report.main in-process")
    want = "## Dry-run matrix (4 compiled, 0 skipped-by-design, 0 failed, 4 cells)"
    matrix, _, roof = text.partition("\n## Roofline (single-pod 32x8, per device)\n")
    if text.splitlines()[0] != want or not roof:
        fail(f"14a: the header or the roofline heading is wrong:\n{text}")
    body = lambda t: [ln for ln in t.splitlines() if ln.startswith("| ")][1:]
    shapes = ("train_4k", "decode_32k")
    rows = body(matrix)
    if len(rows) != 2 or any(not r.startswith(f"| tinyllama-1.1b | {s} | compiled | — | ")
                             for r, s in zip(rows, shapes)):
        fail(f"14a: the dry-run matrix is not the two tinyllama rows:\n{matrix}")
    rows = {r.split(" | ")[1]: r for r in body(roof)}  # in the JSON files' order
    if len(body(roof)) != 2 or sorted(rows) != sorted(shapes):
        fail(f"14a: the roofline table is not the two tinyllama rows:\n{roof}")
    for s in shapes:
        r = rows[s]
        with open(os.path.join(d, f"tinyllama-1.1b_{s}_sp.json")) as f:
            c = json.load(f)
        rl = c["roofline"]
        if c["mesh"] != MESH_NAMES[False] or not r.startswith(
                f"| tinyllama-1.1b | {s} | {report.fmt_s(rl['t_compute'])} | "
                f"{report.fmt_s(rl['t_memory'])} | {report.fmt_s(rl['t_collective'])} | "
                f"{rl['bottleneck']} | ") or \
                f" | {c['memory']['temp_bytes'] / 2**30:.1f}GiB | " not in r:
            fail(f"14a: the {s} roofline row does not carry its JSON's numbers: {r}")
    print("  14a: report --dir over 13e's four JSONs (fake-traced, not measured); the CLI "
          "child == report.main in-process:", flush=True)
    for ln in text.splitlines():
        print(f"    {ln}", flush=True)


def report_hot_path(card_line: str, hot: dict, ab: dict, tmp: str) -> None:
    """14b: phase 3's and 8a's own numbers as a JSON in BENCH_quegel.json's
    schema, through ``--bench``."""
    from repro_torch.launch import report

    bench = dict(meta=dict(backend="cuda", torch=torch.__version__, cuda=torch.version.cuda,
                           platform=card_line, quick=False),
                 workloads=hot, ab=ab)
    path = os.path.join(tmp, "hot_path.json")
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    text = rendered(["--bench", path])
    lines = text.splitlines()
    missing = [f"_{card_line}_"] if f"_{card_line}_" not in lines else []
    cells = lambda ln: ln.split(" | ")
    for wl, plans in hot.items():
        for be, cs in plans.items():
            for cname, m in cs.items():
                row = [ln for ln in lines
                       if ln.startswith(f"| {wl} | {be} | {cname.removeprefix('C')} | ")]
                figs = [f"{m['super_rounds_per_sec']:.1f}", f"{m['queries_per_sec']:.1f}",
                        report.fmt_s(m["p50_query_latency_s"]),
                        report.fmt_s(m["p95_query_latency_s"])]
                if len(row) != 1 or any(x not in cells(row[0]) for x in figs):
                    missing.append(f"{wl}/{be}/{cname}: {figs}")
    ab_line = [ln for ln in lines if ln.startswith(f"**A/B ({ab['workload']}):**")]
    figs = [f"{ab['fused']['super_rounds_per_sec']:.1f}",
            f"{ab['legacy']['super_rounds_per_sec']:.1f}",
            f"{ab['speedup_super_rounds_per_sec']:.2f}x"]
    if len(ab_line) != 1 or any(x not in ab_line[0] for x in figs):
        missing.append(f"A/B: {figs}")
    if missing:
        fail(f"14b: figures missing from the hot-path tables: {missing}\n{text}")
    print(f"  14b: the hot-path JSON of phases 3 and 8a: {json.dumps(bench)}", flush=True)
    print("  14b: report --bench over it (every q/s, rounds/s and latency as phases 3 and 8a "
          "measured them):", flush=True)
    for ln in lines:
        print(f"    {ln}", flush=True)


def phase_report(card_line: str, dryrun_dir: str, hot: dict, ab: dict, tmp: str) -> None:
    """Phase 14: the port's report (launch/report.py, host only) over JSON
    written on this machine.  No frontier kernel launches here."""
    import re

    t0 = time.perf_counter()
    take_counts()
    print("phase 14: the report over this run's JSON", flush=True)
    children = [report_child(["--dir", dryrun_dir]),
                report_child(["--bench", "BENCH_quegel.json"])]
    try:
        t = time.perf_counter()
        report_dryruns(dryrun_dir, children[0])
        print(f"  14a: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        report_hot_path(card_line, hot, ab, tmp)
        print(f"  14b: {time.perf_counter() - t:.1f} s", flush=True)
        t = time.perf_counter()
        pin = re.search(r"^BENCH_QUEGEL_LINES = (\d+)$",
                        (ROOT / "tests" / "test_torch_report.py").read_text(), re.M)
        if pin is None:
            fail("14c: tests/test_torch_report.py pins no BENCH_QUEGEL_LINES")
        n = len(child_out("14c", children[1]).splitlines())
        if n != int(pin.group(1)):
            fail(f"14c: --bench BENCH_quegel.json printed {n} lines, the test pins "
                 f"{pin.group(1)}")
        print(f"  14c: report --bench BENCH_quegel.json (the JAX package's CPU run, committed) "
              f"exits 0 and prints {n} lines, as tests/test_torch_report.py pins; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    if take_counts()[0]:
        fail("phase 14 launched the frontier kernel")
    print(f"phase 14: no frontier kernel launch; {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.kernels import frontier

    t_start = time.perf_counter()
    line = card()
    print(f"phase 0: {line}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    lib, build_s = sync_time(frontier.build)
    frontier.load()
    print(f"phase 1: built {frontier.SOURCE.name} in {build_s:.2f} s; ptxas:", flush=True)
    for text in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in text or "Used" in text or "spill" in text:
            print(f"  {text.strip()}", flush=True)
    max_err = phase_kernel_parity()
    phase_kernel_parity_apps()
    gate_timing = phase_gate_timing()
    g, pairs, launches, main_run = phase_main_path()
    timing = dict(phase_timing(g), gate=gate_timing)
    gc.collect()
    torch.cuda.empty_cache()
    app_launches, app_paths, terrain, reach = phase_apps(g)
    tmp = tempfile.mkdtemp()
    try:
        ft_launches, ft_paths, store = phase_fault_tolerance(g, pairs, main_run, terrain, tmp)
        del terrain
        gc.collect()
        torch.cuda.empty_cache()
        mut_launches, mut_paths, deltas = phase_mutation(g, pairs, main_run, tmp, store)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches, serve_paths, ab = phase_serving(g, pairs, main_run, store)
        gc.collect()
        torch.cuda.empty_cache()
        phase_mesh(g, pairs, main_run, reach, deltas, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = dict(name="propagate_blocks", route="cuda", layout="packed",
               source="src/repro_torch/csrc/frontier.cu",
               replaces="src/repro/kernels/frontier.py:138",
               launches=launches + app_launches + ft_launches + mut_launches + serve_launches,
               max_abs_err=max_err, **timing,
               paths=main_run["paths"] + app_paths + ft_paths + mut_paths + serve_paths,
               gate_paths={p: dict(c) for p, c in GATE_PATHS.items()})
    hot = main_run["hot"]  # phase 14 renders it with 8a's A/B
    # phase 10 needs none of the graph phases' state: free it on the card
    del g, pairs, main_run, reach, deltas, store
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm()
    phase_families()
    tmp = tempfile.mkdtemp()
    children = dist_children(tmp)  # CPU work of phase 13, beside phase 12's
    try:
        phase_train()
        phase_dist(children, tmp)
        phase_report(line, children[1][1], hot, ab, tmp)
    finally:
        for p in children[0] + [p for _, p in children[1][0]]:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--train-drill"]:
        train_drill(sys.argv[2])
    elif sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2])
    else:
        main()
