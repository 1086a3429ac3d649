#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernel
against the plain PyTorch version.

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
     passes add_id), B in {16, 128}, Q in {1, 5, 8}, gated and dense, with
     and without a mask, V not a multiple of B, and an all-dead bitmap.
     Exact equality, except float sum_times (atomic order) to 1e-4, and
     the same outputs at add_id in every case;
  3. the main path — BiBFS (interactive C=1 and batch C=8), the Hub² index
     build (k=1000, C=8) and Hub² batch queries on
     barabasi_albert(262144, 3) through backend="cuda", then the same work
     through backend="coo": identical answers and index, answers checked
     against a host BFS, and a kernel launch counter showing the cuda runs
     went through the kernel;
  4. one propagate at two shapes, Q=8 and a BFS frontier two hops out on
     barabasi_albert(n, 3) for n = 32768 (where the dense-tile kernel was
     timed) and n = 262144 (the main path's): kernel, plain version and COO
     scatter_reduce times, and the bound (the bytes the inputs need over
     3.35 TB/s: per lit edge its position, x, mask and y once, the bitmap
     of the slots that hold entries and the source block of the lit ones);
     at n = 32768 the kernel is also held against the dense
     tile loop over the dense table.
The last lines are the card, one JSON object describing the kernel, and
{"ok": true, "device": {...}}.
"""
import gc
import json
import statistics
import subprocess
import sys
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


def phase_kernel_parity() -> float:
    """Every case of the kernel against its plain version; returns the
    largest absolute difference seen (0 on every integer case)."""
    from repro_torch.core.graph import pack_blocks
    from repro_torch.core.semiring import BY_NAME
    from repro_torch.kernels import frontier, ops

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
                    dead = torch.zeros((pb.num_dst_blocks, pb.max_bpr),
                                       dtype=torch.bool, device="cuda")
                    variants = [
                        (None, ops.block_activity(pb, None)),  # gated, no mask
                        (m, ops.block_activity(pb, m)),        # gated, mask
                        (None, None),                          # dense
                        (m, None),                             # dense, mask
                        (m, dead),                             # all dead
                    ]
                    for mask, active in variants:
                        got = frontier.propagate_blocks(pb, sr, x, mask, active)
                        want = frontier.propagate_blocks_plain(pb, sr, x, mask, active)
                        torch.cuda.synchronize()
                        n_cases += 1
                        where = f"{sr_name}/{dtype} n={n} {kind} B={block} " \
                                f"Q={q} mask={mask is not None} active={active is not None}"
                        if got.shape != want.shape or got.dtype != want.dtype:
                            fail(f"kernel shape/dtype differs: {where}")
                        add_id = sr.identity(dtype)
                        if not torch.equal(got == add_id, want == add_id):
                            fail(f"kernel and plain differ on which outputs are "
                                 f"add_id: {where}")
                        if dtype == torch.float32 and sr.name == "sum_times":
                            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                                fail(f"kernel disagrees beyond 1e-4: {where}")
                            worst = max(worst, float((got - want).abs().max()))
                        elif not torch.equal(got, want):
                            fail(f"kernel differs from plain version: {where}")
                        if active is dead and not (got == add_id).all():
                            fail(f"all-dead bitmap left a non-identity output: {where}")
    print(f"phase 2: packed kernel == plain on {n_cases} cases (exact, float "
          f"sum_times to rtol=atol=1e-4); max_abs_err={worst!r}", flush=True)
    return worst


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


def device_breakdown(run, wall_s: float, what: str) -> None:
    """Run the same work again under torch.profiler and split the device
    time by kernel; the busy share is over the unprofiled wall time of the
    same work (the profiler's own overhead would inflate it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import frontier

    launches = frontier.propagate_blocks.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    frontier.propagate_blocks.launches = launches  # a measurement, not the path
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
        return
    busy = sum(dev.values()) / 1e6
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:4]
    names = "; ".join(f"{k[:60]} {v / 1e6:.4f} s" for k, v in top)
    print(f"  {what}: device busy {busy:.4f} s of {wall_s:.4f} s wall "
          f"({100 * busy / wall_s:.1f} %); top kernels: {names}", flush=True)


def redrain(eng, pairs):
    """Queue the same queries again; returns the drain to profile."""
    for p in pairs:
        eng.submit(p)
    return eng.run_until_drained


def run_main_path(g, pairs, backend: str) -> dict:
    from repro_torch.apps.hub2 import build_hub_index, make_hub2_engine
    from repro_torch.apps.ppsp import make_bibfs_engine
    from repro_torch.configs.quegel import QuegelConfig
    from repro_torch.kernels import frontier

    cfg = QuegelConfig()
    kw = dict(backend=backend, block=cfg.block_size)
    out, rounds = {}, 0
    torch.cuda.reset_peak_memory_stats()
    mark = [frontier.propagate_blocks.launches]

    def launched() -> int:
        n = frontier.propagate_blocks.launches - mark[0]
        mark[0] = frontier.propagate_blocks.launches
        return n

    eng = make_bibfs_engine(g, capacity=1, **kw)
    launched()
    res, dt = sync_time(lambda: [eng.query(p) for p in pairs[:8]])
    out["interactive"] = dict(enumerate(res))
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] interactive BiBFS C=1: 8 queries, {st.rounds} rounds, "
          f"{st.supersteps_total} supersteps, {8 / dt:.3f} q/s, "
          f"{dt / max(st.rounds, 1):.6f} s/round, {launched()} kernel launches",
          flush=True)
    del eng
    gc.collect()

    eng = make_bibfs_engine(g, capacity=cfg.capacity, **kw)
    table_bytes = eng.table_bytes()
    for p in pairs:
        eng.submit(p)
    launched()
    res, dt = sync_time(eng.run_until_drained)
    out["bibfs"] = res
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] batch BiBFS C={cfg.capacity}: {len(pairs)} queries, "
          f"{st.rounds} rounds, {st.supersteps_total} supersteps, "
          f"{len(pairs) / dt:.3f} q/s, {dt / st.rounds:.6f} s/round, "
          f"table bytes {table_bytes}, {launched()} kernel launches", flush=True)
    device_breakdown(redrain(eng, pairs), dt, f"[{backend}] batch BiBFS")
    del eng
    gc.collect()

    launched()
    build = lambda: build_hub_index(g, cfg.hub_k, capacity=cfg.capacity, **kw)
    idx, build_s = sync_time(build)
    out["index"] = {k: getattr(idx, k).cpu().numpy()
                    for k in ("hub_ids", "is_hub", "hub_dist", "core")}
    print(f"  [{backend}] Hub2 index build k={cfg.hub_k} C={cfg.capacity}: "
          f"{build_s:.3f} s wall (table build included), {launched()} kernel launches",
          flush=True)
    gc.collect()

    eng = make_hub2_engine(g, idx, capacity=cfg.capacity, **kw)
    hub2_table_bytes = eng.table_bytes()
    for p in pairs:
        eng.submit(p)
    launched()
    res, dt = sync_time(eng.run_until_drained)
    out["hub2"] = res
    st = eng.stats
    rounds += st.rounds
    print(f"  [{backend}] Hub2 batch C={cfg.capacity}: {len(pairs)} queries, "
          f"{st.rounds} rounds, {st.supersteps_total} supersteps, "
          f"{len(pairs) / dt:.3f} q/s, {dt / st.rounds:.6f} s/round, "
          f"table bytes {hub2_table_bytes}, {launched()} kernel launches", flush=True)
    device_breakdown(redrain(eng, pairs), dt, f"[{backend}] Hub2 batch")
    del eng, idx
    gc.collect()
    torch.cuda.empty_cache()
    out["engine_rounds"] = rounds
    print(f"  [{backend}] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    def rebuild():  # after the peak is read: a second index holds 1.3 GB
        build()

    device_breakdown(rebuild, build_s, f"[{backend}] Hub2 index build")
    return out


def same_results(a: dict, b: dict) -> bool:
    if sorted(a) != sorted(b):
        return False
    for q in a:
        for k in a[q]:
            if not np.array_equal(np.asarray(a[q][k]), np.asarray(b[q][k])):
                return False
    return True


def phase_main_path():
    from repro_torch.core.graph import barabasi_albert
    from repro_torch.kernels import frontier

    (g, dt) = sync_time(lambda: barabasi_albert(MAIN_N, MAIN_M, seed=0))
    print(f"phase 3: barabasi_albert({MAIN_N}, {MAIN_M}): {g.num_edges} edges "
          f"in {dt:.2f} s", flush=True)
    pairs = np.random.default_rng(1).integers(0, g.n_real, (MAIN_PAIRS, 2)).astype(np.int32)

    frontier.propagate_blocks.launches = 0
    cuda = run_main_path(g, pairs, "cuda")
    launches = frontier.propagate_blocks.launches
    rounds = cuda["engine_rounds"]
    print(f"  kernel launches in the cuda runs: {launches} over {rounds} "
          "engine rounds (hub build rounds not counted)", flush=True)
    if launches < rounds or launches == 0:
        fail(f"kernel launched {launches} times over {rounds} rounds")

    coo = run_main_path(g, pairs, "coo")
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
    return g, pairs, launches


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
    """One propagate at the main path's shapes on ``g``: kernel, plain
    version and COO scatter_reduce times, and the bound from the bytes
    these inputs need."""
    from repro_torch.core.graph import pack_blocks
    from repro_torch.core.semiring import MIN_RIGHT
    from repro_torch.kernels import frontier, ops, ref

    q, sr = 8, MIN_RIGHT
    dist, front = bfs_frontier(g, q)
    (pb, dt) = sync_time(lambda: g.to_packed_blocks(128, sr))
    active = ops.block_activity(pb, front)
    k, _, _ = pb.decode()
    i = torch.repeat_interleave(torch.arange(pb.num_dst_blocks, device="cuda"),
                                pb.row_ptr.diff().long())
    lit_edges = int(active[i, k].sum())
    lit_tiles = int(active.sum())
    # the slots that hold entries (no entry names the padding of the
    # (nb, max_bpr) grid), and of those the lit ones, whose source block
    # must be read
    held = torch.zeros(active.numel(), dtype=torch.bool, device="cuda")
    held[i * pb.max_bpr + k] = True
    held_slots = int(held.sum())
    lit_slots = int((held & active.reshape(-1)).sum())
    print(f"phase 4 n={g.n}: packed table {pb.nbytes} bytes ({pb.entries.numel()} "
          f"entries, slot grid {tuple(pb.src_ids.shape)}) built in {dt:.2f} s; "
          f"{int(front.sum())} frontier vertices light {lit_tiles} of "
          f"{int(pb.nslots.sum())} tiles ({held_slots} holding entries) and "
          f"{lit_edges} edges", flush=True)

    kern = lambda: frontier.propagate_blocks(pb, sr, dist, front, active)
    plain = lambda: frontier.propagate_blocks_plain(pb, sr, dist, front, active)
    coo = ops.CooBackend(g)
    lib = lambda: coo.propagate(sr, dist, front)
    before = frontier.propagate_blocks.launches
    y_k, y_p, y_c = kern(), plain(), lib()
    if not (torch.equal(y_k, y_p) and torch.equal(y_k, y_c)):
        fail(f"n={g.n} propagate: kernel, plain and coo disagree")
    if check_dense:
        (bs, dt) = sync_time(lambda: g.to_blocks(128, sr.add_id))
        y_d = ref.propagate_blocks_ref(bs, sr, dist, front, active)
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
    ms = event_ms(kern, 50)
    plain_ms = event_ms(plain, 10)
    library_ms = event_ms(lib, 50)
    frontier.propagate_blocks.launches = before  # timing launches are not the path's
    v = g.n
    per_edge = 4 + (4 if sr.reads_weight else 0)   # packed position (+ weight)
    nbytes = (lit_edges * per_edge
              + q * v * (4 + 1 + 4)                # x, mask, y
              + held_slots + lit_slots * 4)        # active, src_ids
    dense_bytes = (lit_tiles * pb.block ** 2 * 4 + q * v * (4 + 1 + 4)
                   + held_slots + lit_slots * 4)
    ops_ = lit_edges * q * 2                       # select + min per edge and lane
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"phase 4 n={g.n}: kernel {ms!r} ms, plain {plain_ms!r} ms, coo "
          f"scatter_reduce {library_ms!r} ms, bound {bound_ms!r} ms by {bound_by} "
          f"({nbytes} bytes, {ops_} ops); for information, the dense layout's "
          f"bytes {dense_bytes} ({dense_bytes / HBM_BYTES_PER_S * 1e3!r} ms)",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bound_bytes=nbytes, lit_edges=lit_edges,
                held_slots=held_slots, lit_slots=lit_slots)


def phase_timing(g_main) -> dict:
    from repro_torch.core.graph import barabasi_albert

    first = time_propagate(barabasi_albert(FIRST_N, MAIN_M, seed=0, device="cuda"),
                           check_dense=True)
    gc.collect()
    torch.cuda.empty_cache()
    main = time_propagate(g_main, check_dense=False)
    return dict(main, n=g_main.n, **{f"at_n_{FIRST_N}": first})


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
    g, pairs, launches = phase_main_path()
    row = dict(name="propagate_blocks", route="cuda", layout="packed",
               source="src/repro_torch/csrc/frontier.cu",
               replaces="src/repro/kernels/frontier.py:138",
               launches=launches, max_abs_err=max_err, **phase_timing(g))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
