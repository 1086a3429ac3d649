"""Crash-tolerant serving supervisor (``repro.launch.supervise``).

``run_with_recovery`` carries ``train/fault.py::run_with_restarts`` over
to the serving runtime: boot an engine (ideally from the durable store,
``core/store.py``), replay the query journal
(``core/runtime.py::QueryJournal``), and drain.  The recovery invariant
is

    recovered run ≡ uninterrupted run

in the observable map {qid -> (result, status, steps)}:

* **Retired** queries (a ``retire`` record) are installed from their
  journaled results — never re-run.
* **In-flight/queued** queries (a ``submit`` with no ``retire``) re-enter
  the scheduler under their original qid and attributes; when a later
  ``snapshot`` record exists they resume from it as a ``ResumeAdmission``
  (steps charged so far intact — the suspend/resume parity invariant),
  otherwise they re-run from scratch, which a deterministic vertex program
  answers identically.
* Workload items the journal never saw (crash mid-submission) are
  submitted fresh with their position-pinned qid.

Two crash models are covered: an in-process ``SimulatedFailure`` (the
injector raises; this module catches it and re-boots) and real process
death (``FailureInjector(kill_at_steps=...)`` SIGKILLs; only a parent
process can restart — the ``--crash-test`` CLI below is that parent).

Under a mesh (``--ranks N``) each attempt is a group of N rank
processes, started with torchrun's environment (``WORLD_SIZE``, ``RANK``)
and a ``file://`` rendezvous of its own under ``--out`` (a TCP port
picked free by the parent could be taken by another process before the
ranks bind it): every rank boots the same engine on a
``host_device_mesh`` over the graph padded to N, replays the journal
and drains; only rank 0 writes the journal and the result file, and the
injected SIGKILL takes down every rank at the same round.

CLI::

    # parent: N seeds x (baseline, kill, kill, finish)
    PYTHONPATH=src python -m repro_torch.launch.supervise --crash-test \\
        --seeds 3 --out runs/crash [--device cpu] [--ranks 2]

    # one supervised serving process (what the parent spawns; under
    # torchrun, one per rank)
    PYTHONPATH=src python -m repro_torch.launch.supervise --child --seed 0 \\
        --journal j.wal --result out.json [--kill-round 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.runtime import QueryJournal
from repro_torch.train.fault import FailureInjector, SimulatedFailure

SRC = Path(__file__).resolve().parents[2]  # the directory holding repro_torch


# ------------------------------------------------------------------ replay
def fold_journal(records: list[dict]) -> dict:
    """Collapse an append-ordered record list into recovery state:
    ``submits`` (first record per qid), ``done`` (last retire per qid —
    terminal), ``snaps`` (latest snapshot per still-running qid),
    ``mutations`` (every graph-delta record, in log order)."""
    submits: dict[int, dict] = {}
    done: dict[int, dict] = {}
    snaps: dict[int, dict] = {}
    mutations: list[dict] = []
    for r in records:
        t = r.get("type")
        if t == "submit":
            submits.setdefault(r["qid"], r)
        elif t == "retire":
            done[r["qid"]] = r
            snaps.pop(r["qid"], None)  # terminal: snapshot superseded
        elif t == "snapshot":
            snaps[r["qid"]] = r
        elif t == "mutation":
            mutations.append(r)
    return {"submits": submits, "done": done, "snaps": snaps,
            "mutations": mutations, "records": len(records)}


def recover(runtime, journal_path: str) -> dict:
    """Replay ``journal_path`` into a freshly booted runtime.  Returns an
    info dict (counts + the qids the journal knows) — the caller then
    submits only workload items the journal has never seen."""
    state = fold_journal(QueryJournal.replay(journal_path))
    submits, done, snaps = state["submits"], state["done"], state["snaps"]
    for qid, r in sorted(done.items()):
        runtime.restore_retired(qid, r["status"], r["result"], r["steps"])
    # Replay graph mutations BEFORE re-queueing in-flight queries: snapshot
    # payloads pin pre-mutation versions, so every edition of the chain
    # must exist when restore_pending re-registers them (apply_delta_record
    # keeps them, prune=False; the engine prunes at its next delta).  The
    # engine checks the parent/content hash chain of every record.
    if state["mutations"]:
        prog = runtime.program
        if not hasattr(prog, "apply_delta_record"):
            raise RuntimeError(
                "journal contains graph mutations but the booted program "
                f"({type(prog).__name__}) cannot replay them")
        for m in state["mutations"]:
            prog.apply_delta_record(m)
    pending = sorted((r for qid, r in submits.items() if qid not in done),
                     key=lambda r: r["seq"])
    resumed = 0
    for r in pending:
        snap = snaps.get(r["qid"])
        if snap is not None:
            runtime.restore_pending(
                r["qid"], r["query"], priority=r["priority"],
                deadline=r["deadline"], budget=r["budget"],
                seq=snap["seq"], payload=snap["payload"],
                steps_done=snap["steps"])
            resumed += 1
        else:
            runtime.restore_pending(
                r["qid"], r["query"], priority=r["priority"],
                deadline=r["deadline"], budget=r["budget"], seq=r["seq"])
    return {
        "journal_records": state["records"],
        "replayed_done": len(done),
        "resumed_from_snapshot": resumed,
        "resubmitted": len(pending) - resumed,
        "mutations_replayed": len(state["mutations"]),
        "known_qids": set(submits),
    }


# -------------------------------------------------------------- supervisor
def run_with_recovery(
    boot: Callable[[], Any],
    journal_path: str,
    submits: list = (),
    *,
    snapshot_every: int = 0,
    max_restarts: int = 3,
    fsync: bool = True,
    injector: Optional[FailureInjector] = None,
    max_rounds: int = 100_000,
    on_round: Optional[Callable[[Any, int], None]] = None,
    writer: bool = True,
    barrier: Optional[Callable[[], None]] = None,
):
    """Drain ``submits`` through a journaled engine, recovering from
    crashes.  Returns ``(engine, info)`` once drained.

    ``boot()`` returns a fresh engine (anything owning a ``SlotRuntime``)
    with its graph, index and tables reconstructed, ideally from the
    durable store.  ``submits`` is a list of ``(query, submit_kwargs)`` (or
    bare queries); item i is pinned to qid i so replay can tell which
    items the journal already recorded.  ``on_round(engine,
    executed_rounds)`` runs after every round.  In-process failures
    (``SimulatedFailure``) re-boot up to ``max_restarts`` times; a
    SIGKILL is recovered by running this function again in a new process
    against the same journal.

    Under a mesh every rank calls this with the same arguments: ``writer``
    is True on rank 0 only (the other ranks' journals record nothing),
    and ``barrier()`` (``torch.distributed.barrier``) holds rank 0's first
    write until every rank has replayed the journal.
    """
    restarts = 0
    while True:
        eng = boot()
        rt = eng.runtime
        rt.journal = QueryJournal(journal_path, fsync=fsync, write=writer)
        rt.snapshot_every = int(snapshot_every)
        info = recover(rt, journal_path)
        if barrier is not None:
            barrier()
        known = info.pop("known_qids")
        for i, item in enumerate(submits):
            if i in known:
                continue
            q, kw = item if isinstance(item, tuple) else (item, {})
            got = eng.submit(q, qid=i, **dict(kw or {}))
            if got != i:
                raise RuntimeError(f"qid pinning broke: wanted {i}, got {got}")
        try:
            rounds = 0
            while rt.pending() or rt.live.any():
                rt.run_round()
                rounds += 1
                if on_round is not None:
                    on_round(eng, rt.stats.rounds)
                if injector is not None:
                    injector.check(rt.stats.rounds, engine=eng)
                if rounds > max_rounds:
                    raise RuntimeError(
                        f"supervised drain exceeded {max_rounds} rounds")
            info["restarts"] = restarts
            return eng, info
        except SimulatedFailure:
            rt.journal.close()
            restarts += 1
            if restarts > max_restarts:
                raise


# ------------------------------------------------------------ crash-test CLI
def _result_map(eng) -> dict:
    """JSON-able {qid: {result leaves, status, steps}} fingerprint."""
    out = {}
    for qid in sorted(eng.runtime.results):
        res = eng.runtime.results[qid]
        leaves = ({k: np.asarray(v).tolist() for k, v in sorted(res.items())}
                  if isinstance(res, dict) else np.asarray(res).tolist())
        out[str(qid)] = {
            "result": leaves,
            "status": eng.runtime.status[qid],
            "steps": int(eng.runtime.steps[qid]),
        }
    return out


def _child(args) -> int:
    """One supervised serving process over a deterministic workload; the
    injected SIGKILL (if any) models a machine loss mid-drain.  Started
    with torchrun's environment, it is one rank of a mesh (module
    docstring)."""
    from repro_torch.apps.ppsp import make_bfs_engine
    from repro_torch.core.graph import random_graph

    mesh, rank, barrier = None, 0, None
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from repro_torch.launch.mesh import host_device_mesh

        rdv = dict(init_method=f"file://{args.rendezvous}",
                   world_size=int(os.environ["WORLD_SIZE"]),
                   rank=int(os.environ["RANK"])) if args.rendezvous else {}
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo", **rdv)
        mesh, rank, barrier = (host_device_mesh(device_type=args.device),
                               dist.get_rank(), dist.barrier)
    g = random_graph(64, 3.0, seed=args.seed, directed=True, device=args.device)
    if mesh is not None:
        g = g.padded(mesh.size())
    rng = np.random.default_rng(args.seed)
    pairs = rng.integers(0, g.n_real, (args.queries, 2))
    submits = [
        (np.asarray(p, np.int32), dict(budget=int(8 + 4 * (i % 3))))
        for i, p in enumerate(pairs)
    ]

    def boot():
        return make_bfs_engine(g, capacity=4, scheduler=args.scheduler,
                               mesh=mesh, device=None if mesh else args.device)

    injector = None
    if args.kill_round > 0:
        injector = FailureInjector(kill_at_steps={args.kill_round})
    eng, info = run_with_recovery(
        boot, args.journal, submits, snapshot_every=args.snapshot_every,
        injector=injector, writer=rank == 0, barrier=barrier)
    if rank == 0:
        with open(args.result, "w") as f:
            json.dump(_result_map(eng), f, indent=0, sort_keys=True)
        print(f"CHILD_DONE replayed={info['replayed_done']} "
              f"resumed={info['resumed_from_snapshot']} "
              f"resubmitted={info['resubmitted']}"
              + (f" ranks={mesh.size()}" if mesh is not None else ""))
    if mesh is not None:
        import torch.distributed as dist

        # the ranks leave together: rank 0 writes the result while the
        # others would already be tearing their gloo group down
        dist.barrier()
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    """A TCP port on localhost that no process listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(cmd: list, env: dict, ranks: int, timeout: float, rendezvous: str):
    """One attempt: the child alone, or ``ranks`` rank processes of it with
    torchrun's environment, meeting at the ``rendezvous`` file (a fresh
    path for every attempt).  Returns (rc, rank 0's stdout, stderrs): rc
    is 0 when every rank exited 0, else the first rank's nonzero code (-9
    for the injected SIGKILL); a group outliving ``timeout`` is killed."""
    if ranks == 0:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
        return p.returncode, p.stdout, p.stderr
    procs = [subprocess.Popen(
        cmd + ["--rendezvous", rendezvous], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, WORLD_SIZE=str(ranks), RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(ranks)]
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate())
    rcs = [p.returncode for p in procs]
    rc = next((c for c in rcs if c != 0), 0)
    return rc, outs[0][0], "".join(e for _, e in outs)


def _crash_test(args) -> int:
    """Parent orchestration: for each seed, run an uninterrupted baseline,
    then a supervised run SIGKILLed at random rounds until a final attempt
    completes, and diff the result maps.  Journals and result maps land in
    ``--out``."""
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    failures = 0
    for seed in range(args.seeds):
        d = os.path.join(args.out, f"seed_{seed}")
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(10_000 + seed)
        attempts = itertools.count()

        def spawn(journal, result, kill_round):
            cmd = [
                sys.executable, "-m", "repro_torch.launch.supervise", "--child",
                "--seed", str(seed), "--journal", journal,
                "--result", result, "--kill-round", str(kill_round),
                "--queries", str(args.queries),
                "--snapshot-every", str(args.snapshot_every),
                "--scheduler", args.scheduler, "--device", args.device,
            ]
            rdv = os.path.join(os.path.abspath(d), f"rendezvous_{next(attempts)}")
            return _run_group(cmd, env, args.ranks, 600, rdv)

        rc, out, err = spawn(os.path.join(d, "baseline.wal"),
                             os.path.join(d, "baseline.json"), 0)
        if rc != 0:
            print(f"seed {seed}: BASELINE FAILED\n{out}\n{err}")
            failures += 1
            continue
        wal = os.path.join(d, "crashed.wal")
        res = os.path.join(d, "crashed.json")
        kills = [int(rng.integers(1, 8)) for _ in range(args.kills)]
        rc = None
        for attempt, kr in enumerate(kills + [0]):
            t0 = time.perf_counter()
            rc, out, err = spawn(wal, res, kr)
            print(f"seed {seed} attempt {attempt} kill_round={kr} "
                  f"rc={rc} ({time.perf_counter() - t0:.1f}s) "
                  f"{out.strip().splitlines()[-1] if out.strip() else ''}")
            if kr == 0 and rc != 0:
                print(f"seed {seed}: FINAL ATTEMPT FAILED\n{err[-3000:]}")
                failures += 1
                break
            if rc == 0:
                break  # finished (possibly before the kill round was hit)
        if rc != 0:
            continue
        with open(os.path.join(d, "baseline.json")) as f:
            want = json.load(f)
        with open(res) as f:
            got = json.load(f)
        if want != got:
            diff = {q for q in set(want) | set(got) if want.get(q) != got.get(q)}
            print(f"seed {seed}: MISMATCH on qids {sorted(diff)}")
            failures += 1
        else:
            print(f"seed {seed}: OK — recovered map identical to baseline "
                  f"({len(want)} queries)")
    if failures:
        print(f"crash-test FAILED: {failures} seed(s) diverged")
        return 1
    print(f"crash-test OK: {args.seeds} seed(s), recovered ≡ uninterrupted")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--crash-test", action="store_true")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--kills", type=int, default=2,
                    help="SIGKILL attempts per seed before the finishing run")
    ap.add_argument("--out", default="runs/crash")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--journal", default="runs/crash/journal.wal")
    ap.add_argument("--result", default="runs/crash/result.json")
    ap.add_argument("--kill-round", type=int, default=0)
    ap.add_argument("--queries", type=int, default=6)
    ap.add_argument("--snapshot-every", type=int, default=2)
    ap.add_argument("--scheduler", default="sjf")
    ap.add_argument("--device", default="cuda",
                    help="where each child's engine runs (cpu only when asked)")
    ap.add_argument("--rendezvous", default="",
                    help="a rank's file:// rendezvous (set by --crash-test; "
                         "without it a rank reads torchrun's MASTER_ADDR/PORT)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run each child as this many mesh ranks (gloo on cpu, "
                         "nccl on cuda); 0: one process, no mesh")
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    if args.crash_test:
        return _crash_test(args)
    ap.error("pick one of --crash-test / --child")


if __name__ == "__main__":
    sys.exit(main())
