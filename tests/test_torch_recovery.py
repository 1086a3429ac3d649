"""Crash recovery in the port against the JAX package.

The recovery invariant: a serving run killed at any round boundary and
recovered from its journal (retired queries replayed, in-flight queries
resumed from their latest snapshot or re-run) is observationally
equivalent to an uninterrupted run — identical {qid -> result}, terminal
statuses and cumulative superstep counts — and equal to the JAX engine's
uninterrupted run on the same graph and queries.  Also here: the journal
(round trip, torn tail, corruption, byte compatibility with the JAX
package's), poison quarantine on terrain, exception safety of the drain
loop, the straggler wiring, and a real-SIGKILL run of the supervisor CLI
on the CPU."""
import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import ppsp as jppsp
from repro.apps import terrain as jterrain
from repro.core import runtime as jruntime
from repro.core.graph import Graph as JGraph
from repro.core.graph import grid_terrain, random_graph
from repro.launch import supervise as jsupervise

import repro_torch
from repro_torch.apps import ppsp, terrain
from repro_torch.core.runtime import (
    DONE, POISONED, TIMEOUT, QueryJournal, Ticket, result_hash)
from repro_torch.launch.supervise import fold_journal, run_with_recovery
from repro_torch.train.fault import FailureInjector, SimulatedFailure, StragglerMonitor

from _torch_common import port_graph

SRC = Path(repro_torch.__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _matrix_graph():
    """The JAX tests' 60-vertex graph: random core + path tail, so crashes
    land while heavy queries are mid-flight."""
    g = random_graph(48, 3.0, seed=1, directed=True)
    src = np.concatenate([np.asarray(g.src), np.arange(48, 59)])
    dst = np.concatenate([np.asarray(g.dst), np.arange(49, 60)])
    return JGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), 60)


@functools.lru_cache(maxsize=None)
def _port_matrix_graph():
    return port_graph(_matrix_graph())


def _submits(n=6, seed=3):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 48, (n, 2))
    subs = []
    for i, (a, b) in enumerate(pairs):
        kw = dict(priority=int(rng.integers(0, 3)))
        if i % 3 == 1:
            kw["budget"] = 2
        elif i % 3 == 2:
            kw["budget"] = 64
        subs.append((np.asarray([int(a), int(b)], np.int32), kw))
    subs.append((np.asarray([48, 59], np.int32), dict(budget=4)))
    subs.append((np.asarray([48, 57], np.int32), dict(budget=64)))
    return subs


def _fingerprint(eng):
    res = {q: {k: np.asarray(v).tolist() for k, v in r.items()}
           for q, r in eng.runtime.results.items()}
    return res, dict(eng.runtime.status), dict(eng.runtime.steps)


def _hash_map(journal_path):
    """{qid: (status, steps, result_hash)} of a journal's retirements."""
    return {r["qid"]: (r["status"], r["steps"], r["result_hash"])
            for r in QueryJournal.replay(journal_path) if r["type"] == "retire"}


# ------------------------------------------------------------ journal unit
def test_journal_roundtrip(tmp_path):
    p = str(tmp_path / "j.wal")
    j = QueryJournal(p)
    q = np.asarray([1, 2], np.int32)
    j.submit(0, q, priority=1, deadline=math.inf, budget=4, seq=0)
    res = {"dist": np.asarray(5, np.int32), "nested": [1.5, "x", None]}
    j.retire(0, DONE, 3, res)
    j.close()
    recs = QueryJournal.replay(p)
    assert [r["type"] for r in recs] == ["submit", "retire"]
    s, r = recs
    assert s["qid"] == 0 and s["priority"] == 1 and s["budget"] == 4
    assert s["deadline"] == math.inf
    assert np.array_equal(s["query"], q) and s["query"].dtype == np.int32
    assert int(np.asarray(r["result"]["dist"])) == 5
    assert r["result"]["nested"] == [1.5, "x", None]
    assert r["result_hash"] == result_hash(res)
    assert r["status"] == DONE and r["steps"] == 3
    with pytest.raises(TypeError, match="numpy"):
        result_hash({"dist": torch.tensor(5)})


def test_journal_is_byte_compatible_with_jax(tmp_path):
    """The same records written by each package are the same bytes, and
    each package replays the other's journal, a snapshot and a mutation
    record included."""
    payload = {"v": 0, "state": {"dist": np.arange(4, dtype=np.int32),
                                 "frontier": np.array([True, False, True, False])}}
    paths = {}
    for name, mod in (("port", None), ("jax", jruntime)):
        path = str(tmp_path / f"{name}.wal")
        J = QueryJournal if mod is None else mod.QueryJournal
        T = Ticket if mod is None else mod.Ticket
        j = J(path)
        j.submit(0, np.asarray([1, 2], np.int32), priority=0, deadline=2.5,
                 budget=4, seq=0)
        j.snapshot(T(0, None, 0, math.inf, 4, seq=0, steps_done=3, resume=payload))
        j.retire(0, TIMEOUT, 4, {"dist": np.float32(1.5), "t": (np.int32(1), "a")})
        j.mutation(version=1, parent_hash="p", content_hash="c", adds=[[0, 1]],
                   add_w=np.asarray([3], np.int32), dels=np.zeros((0, 2), np.int32))
        j.close()
        paths[name] = path
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    mine = QueryJournal.replay(paths["jax"])
    theirs = jruntime.QueryJournal.replay(paths["port"])
    assert [r["type"] for r in mine] == ["submit", "snapshot", "retire", "mutation"]
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
    np.testing.assert_array_equal(mine[1]["payload"]["state"]["dist"], np.arange(4))
    assert mine[2]["result_hash"] == jruntime.result_hash(theirs[2]["result"])


def test_journal_torn_tail_and_corruption(tmp_path):
    p = str(tmp_path / "j.wal")
    j = QueryJournal(p)
    for i in range(3):
        j.submit(i, np.asarray([i], np.int32), priority=0, deadline=math.inf,
                 budget=0, seq=i)
    j.close()
    with open(p, "ab") as f:
        f.write(b"deadbeef {\"type\": \"submit\", \"qid\"")
    assert [r["qid"] for r in QueryJournal.replay(p)] == [0, 1, 2]
    lines = open(p, "rb").read().splitlines(keepends=True)
    assert b'"qid":1' in lines[1]
    lines[1] = lines[1].replace(b'"qid":1', b'"qid":9')
    with open(p, "wb") as f:
        f.writelines(lines)
    assert [r["qid"] for r in QueryJournal.replay(p)] == [0]
    assert QueryJournal.replay(str(tmp_path / "nope.wal")) == []


def test_fold_journal_last_writer_wins():
    recs = [
        {"type": "submit", "qid": 0, "seq": 0},
        {"type": "snapshot", "qid": 0, "seq": 0, "steps": 2},
        {"type": "snapshot", "qid": 0, "seq": 0, "steps": 5},
        {"type": "submit", "qid": 1, "seq": 1},
        {"type": "retire", "qid": 1, "status": DONE, "steps": 1},
    ]
    st = fold_journal(recs)
    assert st["snaps"][0]["steps"] == 5
    assert 1 in st["done"] and 1 not in st["snaps"]
    assert set(st["submits"]) == {0, 1}
    assert st == jsupervise.fold_journal(recs)


# ------------------------------------------- differential crash matrix
def _jax_uninterrupted(scheduler, spr, jdir):
    eng, _ = jsupervise.run_with_recovery(
        lambda: jppsp.make_bfs_engine(_matrix_graph(), capacity=3, scheduler=scheduler,
                                      steps_per_round=spr),
        os.path.join(jdir, f"jax_{scheduler}_{spr}.wal"), _submits(), snapshot_every=2)
    return _fingerprint(eng)


@pytest.mark.parametrize("scheduler", ["fifo", "sjf"])
@pytest.mark.parametrize("spr", [1, 4])
def test_crash_recovery_parity_matrix(tmp_path, spr, scheduler):
    subs = _submits()

    def boot():
        return ppsp.make_bfs_engine(_port_matrix_graph(), capacity=3,
                                    scheduler=scheduler, steps_per_round=spr,
                                    device="cpu")

    eng0, _ = run_with_recovery(boot, str(tmp_path / "base.wal"), subs, snapshot_every=2)
    want = _fingerprint(eng0)
    assert want == _jax_uninterrupted(scheduler, spr, str(tmp_path))
    _, statuses, _ = want
    assert TIMEOUT in statuses.values() and DONE in statuses.values()
    rounds = eng0.runtime.stats.rounds
    for r in sorted({1, max(2, rounds // 2), max(1, rounds - 1)}):
        inj = FailureInjector(fail_at_steps={r})
        eng, info = run_with_recovery(boot, str(tmp_path / f"crash{r}.wal"), subs,
                                      snapshot_every=2, injector=inj)
        assert _fingerprint(eng) == want, r
        assert info["restarts"] == 1
        assert info["replayed_done"] + info["resumed_from_snapshot"] \
            + info["resubmitted"] > 0


def test_journal_hash_maps_match_jax(tmp_path):
    """One journaled workload through each package: the retirement records
    carry the same {qid: (status, steps, result_hash)}."""
    subs = _submits()
    jpath, path = str(tmp_path / "jax.wal"), str(tmp_path / "port.wal")
    jsupervise.run_with_recovery(
        lambda: jppsp.make_bibfs_engine(_matrix_graph(), capacity=3, scheduler="sjf"),
        jpath, subs, snapshot_every=2)
    run_with_recovery(
        lambda: ppsp.make_bibfs_engine(_port_matrix_graph(), capacity=3,
                                       scheduler="sjf", device="cpu"),
        path, subs, snapshot_every=2)
    want = _hash_map(jpath)
    assert len(want) == len(subs)
    assert _hash_map(path) == want


def test_snapshot_resume_actually_fires(tmp_path):
    subs = _submits()

    def boot():
        return ppsp.make_bfs_engine(_port_matrix_graph(), capacity=3, scheduler="fifo",
                                    device="cpu")

    eng0, _ = run_with_recovery(boot, str(tmp_path / "b.wal"), subs)
    want = _fingerprint(eng0)
    inj = FailureInjector(fail_at_steps={3})
    eng, info = run_with_recovery(boot, str(tmp_path / "c.wal"), subs,
                                  snapshot_every=1, injector=inj)
    assert info["resumed_from_snapshot"] > 0
    assert eng.runtime.stats.replayed == info["replayed_done"]
    assert eng.stats.snapshots > 0
    assert _fingerprint(eng) == want


def test_recovery_exhausts_restarts(tmp_path):
    def boot():
        return ppsp.make_bfs_engine(_port_matrix_graph(), capacity=2, device="cpu")

    inj = FailureInjector(fail_at_steps={1, 2, 3})
    with pytest.raises(SimulatedFailure):
        run_with_recovery(boot, str(tmp_path / "j.wal"), _submits(),
                          max_restarts=2, injector=inj)


def test_supervisor_cli_sigkill_roundtrip(tmp_path):
    """SIGKILLed child processes, recovered from their journal on the CPU,
    answer as the uninterrupted baseline."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervise", "--crash-test",
         "--seeds", "1", "--kills", "2", "--queries", "6",
         "--out", str(tmp_path / "crash"), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "recovered ≡ uninterrupted" in r.stdout
    assert "rc=-9" in r.stdout
    assert os.path.exists(tmp_path / "crash" / "seed_0" / "crashed.wal")


# --------------------------------------------------------- poison quarantine
@functools.lru_cache(maxsize=None)
def _terrain():
    return grid_terrain(8, 8, seed=1)


def _terrain_engines(**kw):
    g, coords = _terrain()
    return (jterrain.make_terrain_engine(g, coords, **kw),
            terrain.make_terrain_engine(port_graph(g), np.asarray(coords),
                                        device="cpu", **kw))


def _terrain_subs(n=3, seed=5):
    rng = np.random.default_rng(seed)
    subs = [np.asarray([int(a), int(b)], np.int32)
            for a, b in rng.integers(0, 64, (n, 2))]
    subs.append(np.asarray([0, 63], np.int32))  # corner to corner: long in flight
    return subs


def test_persistent_poison_quarantined():
    """Re-poisoned every round, the victim retries max_retries times and
    retires POISONED; every other query equals the clean JAX run."""
    subs = _terrain_subs()
    clean, eng = _terrain_engines(capacity=2, max_retries=2)
    for q in subs:
        clean.submit(jnp.asarray(q))
    clean.run_until_drained()
    qids = [eng.submit(q) for q in subs]
    victim = qids[-1]
    inj = FailureInjector(poison_qids={victim})
    r = 0
    while eng.runtime.pending() or eng.runtime.live.any():
        eng.runtime.run_round()
        inj.check(r, engine=eng)
        r += 1
        assert r < 500
    assert eng.runtime.status[victim] == POISONED
    assert not np.isfinite(np.asarray(eng.runtime.results[victim]["dist"])).all()
    assert eng.stats.poison_retries == 2 and eng.stats.poisoned == 1
    assert len(inj.poison_events) >= 3
    for qid in qids[:-1]:
        assert eng.runtime.status[qid] == DONE
        np.testing.assert_array_equal(eng.runtime.results[qid]["dist"],
                                      np.asarray(clean.runtime.results[qid]["dist"]))


def test_transient_poison_retries_to_done():
    q = np.asarray([0, 63], np.int32)
    clean, eng = _terrain_engines(capacity=1)
    want = clean.query(jnp.asarray(q))
    qid = eng.submit(q)
    eng.run_round()
    slot = eng.runtime.slot_of(qid)
    assert slot is not None
    floats = [t for t in eng._slots["state"].values() if t.dtype.is_floating_point]
    assert eng.poison_slot(slot) == len(floats) >= 1
    assert all(torch.isnan(t[slot]).all() for t in floats)
    eng.run_until_drained()
    assert eng.runtime.status[qid] == DONE
    assert eng.stats.poison_retries == 1 and eng.stats.poisoned == 0
    np.testing.assert_array_equal(eng.runtime.results[qid]["dist"], np.asarray(want["dist"]))


def test_poison_refused_on_int_state():
    eng = ppsp.make_bfs_engine(port_graph(random_graph(60, 3.0, seed=1)), capacity=1,
                               device="cpu")
    eng.submit(np.asarray([0, 50], np.int32))
    eng.run_round()
    with pytest.raises(ValueError, match="no float leaves"):
        eng.poison_slot(0)


# --------------------------------------------------------- exception safety
def test_exception_in_round_keeps_runtime_coherent():
    subs = _submits()
    jclean = jppsp.make_bfs_engine(_matrix_graph(), capacity=3)
    for q, kw in subs:
        jclean.submit(q, **kw)
    jclean.run_until_drained()
    want = _fingerprint(jclean)

    eng = ppsp.make_bfs_engine(_port_matrix_graph(), capacity=3, device="cpu")
    for q, kw in subs:
        eng.submit(q, **kw)
    eng.run_round()
    eng.run_round()
    inflight = int(eng.runtime.live.sum())
    assert inflight > 0
    pending_before = eng.runtime.pending()

    def boom(admitted):
        raise RuntimeError("injected mid-drain fault")

    eng.slot_round = boom
    with pytest.raises(RuntimeError, match="injected mid-drain"):
        eng.runtime.run_round()
    assert not eng.runtime.live.any()
    assert eng.runtime._slot_ticket == {}
    assert eng.runtime.pending() == pending_before + inflight
    assert eng.stats.round_failures == 1
    del eng.slot_round
    eng.run_until_drained()
    assert _fingerprint(eng) == want


def test_exception_in_collect_also_abandons():
    eng = ppsp.make_bfs_engine(_port_matrix_graph(), capacity=2, device="cpu")
    eng.submit(np.asarray([0, 5], np.int32))

    def boom(slots):
        raise RuntimeError("collect blew up")

    eng.slot_collect = boom
    with pytest.raises(RuntimeError, match="collect blew up"):
        for _ in range(200):
            eng.runtime.run_round()
    assert not eng.runtime.live.any()
    assert eng.stats.round_failures == 1
    del eng.slot_collect
    eng.run_until_drained()
    assert eng.runtime.status[0] == DONE


# ---------------------------------------------------------------- straggler
def test_straggler_monitor_wiring():
    mon = StragglerMonitor(alpha=0.1, threshold=1e-6, warmup=1)
    eng = ppsp.make_bfs_engine(port_graph(random_graph(60, 3.0, seed=1)), capacity=2,
                               straggler=mon, device="cpu")
    for a, b in np.random.default_rng(0).integers(0, 60, (5, 2)):
        eng.submit(np.asarray([int(a), int(b)], np.int32))
    eng.run_until_drained()
    assert eng.stats.straggler_rounds > 0
    assert eng.stats.straggler_rounds == len(mon.flags)
    assert mon.count == eng.stats.rounds
