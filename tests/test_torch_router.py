"""The port's replica router against a JAX pool on the same items: home
replicas, per-replica submits, p2c spills, cache hits and the merged
result, status and steps maps under every policy; the pool as an
open-loop target; and the replicas booted from one store read."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import ppsp as jppsp
from repro.core.graph import random_graph
from repro.launch import loadgen as jloadgen
from repro.launch import router as jrouter

from repro_torch.apps import ppsp
from repro_torch.core import store as tstore
from repro_torch.core.runtime import DONE
from repro_torch.launch import loadgen, router
from repro_torch.launch.router import POLICIES, ReplicaPool, boot_replicas_from_store

from _torch_common import assert_same_results, port_graph


@functools.lru_cache(maxsize=None)
def _directed():
    """The ``small_directed`` graph of ``tests/conftest.py``."""
    return random_graph(60, 3.0, seed=1, directed=True)


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, _directed().n_real, (n, 2)).astype(np.int32))


def _zipf_mix(keys, n, seed, alpha=1.1):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(keys) + 1) ** alpha
    p /= p.sum()
    return [keys[i] for i in rng.choice(len(keys), size=n, p=p)]


def _np_map(res):
    return {q: {k: np.asarray(v) for k, v in r.items()} for q, r in res.items()}


def _pool(n, *, policy="affine", capacity=2, **kw):
    reps = [ppsp.make_bfs_engine(port_graph(_directed()), capacity=capacity,
                                 device="cpu", **kw) for _ in range(n)]
    return ReplicaPool(reps, policy=policy)


def _jax_pool(n, *, policy="affine", capacity=2, **kw):
    reps = [jppsp.make_bfs_engine(_directed(), capacity=capacity, **kw) for _ in range(n)]
    return jrouter.ReplicaPool(reps, policy=policy)


def _observed(pool) -> tuple:
    """Everything placement decides: per-replica submits and rounds,
    spills, hits, and the merged maps."""
    s = pool.stats_summary()
    return (_np_map(pool.results), dict(pool.status), dict(pool.steps),
            (s["submits"], s["spills"], s["cache_hits"], s["rounds"], s["balance"]))


def _assert_same_pool(got, want):
    assert_same_results(got[0], want[0])
    assert got[1:] == want[1:]


# ----------------------------------------------------------- placement
@pytest.mark.parametrize("n", [2, 3, 4])
def test_home_of_matches_jax_pool(n):
    queries = _queries(16, seed=1)
    homes = [_pool(n).home_of(q) for q in queries]
    assert homes == [_jax_pool(n).home_of(q) for q in queries]
    assert len(set(homes)) > 1
    # content-derived: a tensor of the same values routes the same
    assert _pool(n).home_of(torch.as_tensor(queries[0])) == homes[0]


def test_bad_policy_and_empty_pool():
    with pytest.raises(ValueError, match="unknown routing policy"):
        _pool(2, policy="random")
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaPool([])


# ------------------------------------------- the same pool as a JAX pool
@functools.lru_cache(maxsize=None)
def _jax_drain(policy, scheduler, preemptive):
    queries = _queries(10, seed=2)
    budgets = [60 if i % 3 else 200 for i in range(len(queries))]
    pool = _jax_pool(2, policy=policy, scheduler=scheduler, preemptive=preemptive)
    for q, b in zip(queries, budgets):
        pool.submit(q, budget=b)
    pool.drain()
    return _observed(pool)


@pytest.mark.parametrize("scheduler,preemptive", [
    ("fifo", False), ("sjf", False), ("deadline", False), ("sjf", True)])
@pytest.mark.parametrize("policy", POLICIES)
def test_pool_matches_jax_pool(scheduler, preemptive, policy):
    queries = _queries(10, seed=2)
    budgets = [60 if i % 3 else 200 for i in range(len(queries))]
    pool = _pool(2, policy=policy, scheduler=scheduler, preemptive=preemptive)
    for q, b in zip(queries, budgets):
        pool.submit(q, budget=b)
    pool.drain()
    got = _observed(pool)
    _assert_same_pool(got, _jax_drain(policy, scheduler, preemptive))
    assert all(st == DONE for st in pool.status.values())


@functools.lru_cache(maxsize=None)
def _jax_zipf(policy, capacity, cache, closed):
    keys = _queries(12, seed=4)
    mix = _zipf_mix(keys, 48, seed=5)
    pool = _jax_pool(2, policy=policy, capacity=capacity, result_cache=cache)
    if closed:
        for q in mix:
            pool.submit(q)
            pool.drain()
    else:
        jloadgen.run_open_loop(pool, mix, jloadgen.constant_arrivals(2.0, len(mix)),
                               offered_qps=2.0)
    return _observed(pool)


@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_zipf_hits_and_spills_match_jax_pool(policy, closed):
    """A Zipf mix over 12 keys, per-replica LRU of 8, closed loop or open
    loop at 2 queries per tick: the same hits, spills and merged maps."""
    keys = _queries(12, seed=4)
    mix = _zipf_mix(keys, 48, seed=5)
    pool = _pool(2, policy=policy, result_cache=8)
    if closed:
        for q in mix:
            pool.submit(q)
            pool.drain()
    else:
        loadgen.run_open_loop(pool, mix, loadgen.constant_arrivals(2.0, len(mix)),
                              offered_qps=2.0)
    _assert_same_pool(_observed(pool), _jax_zipf(policy, 2, 8, closed))


def test_affine_hits_beat_round_robin():
    """Under affine each replica's LRU holds its half of the keys; under rr
    every replica churns through all of them."""
    hits = {}
    for policy in ("affine", "rr"):
        keys = _queries(12, seed=4)
        pool = _pool(2, policy=policy, result_cache=8)
        for q in _zipf_mix(keys, 48, seed=5):
            pool.submit(q)
            pool.drain()
        hits[policy] = pool.cache_hits
    assert hits["affine"] > hits["rr"]


def test_p2c_spills_hot_key_as_jax():
    hot = np.asarray((0, 33), np.int32)
    got, want = _pool(2, policy="p2c", capacity=1), _jax_pool(2, policy="p2c", capacity=1)
    for pool in (got, want):
        for _ in range(8):  # no pumping between submits: the backlog piles up
            pool.submit(hot)
        pool.drain()
    assert got.spills > 0 and got.submits[1 - got.home_of(hot)] > 0
    _assert_same_pool(_observed(got), _observed(want))


def test_pool_pump_poll_and_counters():
    pool = _pool(2)
    qids = [pool.submit(q) for q in _queries(6, seed=3)]
    assert pool.poll(qids[0]) is None
    reported = []
    for _ in range(1000):
        reported += [qid for qid, _, _ in pool.pump()]
        if len(reported) == len(qids):
            break
    assert sorted(reported) == qids and pool.pump() == []
    status, res = pool.poll(qids[0])
    assert status == DONE and "dist" in res
    assert pool.pending() == 0 and pool.inflight() == 0


# ------------------------------------------------------------- shared boot
def test_boot_replicas_from_store_single_read(tmp_path, monkeypatch):
    g = port_graph(_directed())
    store = tstore.Store(str(tmp_path / "store"))
    tstore.save_engine_store(store, g, aux_graphs={"rev": g.reverse()})
    reads = []
    orig = tstore.load_engine_store

    def counting(store_, device=None):
        reads.append(device)
        return orig(store_, device=device)

    monkeypatch.setattr(tstore, "load_engine_store", counting)
    built = []

    def factory(i, parts):
        built.append(i)
        return ppsp.make_bibfs_engine(parts["graph"], capacity=2, device="cpu")

    reps = boot_replicas_from_store(store, factory, 3, device="cpu")
    assert reads == ["cpu"] and built == [0, 1, 2]
    g0 = reps[0].runtime.program.graph
    assert all(r.runtime.program.graph is g0 for r in reps[1:])
    assert g0.content_hash() == _directed().content_hash()

    queries = _queries(8, seed=9)
    pool = ReplicaPool(reps, policy="affine")
    for q in queries:
        pool.submit(q)
    merged = pool.drain()
    single = jppsp.make_bibfs_engine(_directed(), capacity=2)
    for q in queries:
        single.submit(q)
    assert_same_results(merged, _np_map(single.run_until_drained()))


def test_router_module_boots_from_the_port_store():
    """The boot imports the port's store, never the JAX package's."""
    import inspect

    text = inspect.getsource(router.boot_replicas_from_store)
    assert "repro_torch.core.store" in text and "from repro." not in text
