"""Open-loop serving in the port against the JAX package: the arrival
processes bit for bit, the virtual-clock load generator driving the
port's engine as it drives the JAX engine (ticks, latencies, backlog,
statuses and answers), the sweep and its knee, the queue-wait/service
split, and the host-tuning module's API."""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import ppsp as jppsp
from repro.core.graph import random_graph
from repro.launch import loadgen as jloadgen

from repro_torch.apps import ppsp
from repro_torch.core.runtime import DONE, TIMEOUT
from repro_torch.launch import env as envmod
from repro_torch.launch import loadgen

from _torch_common import assert_same_results, port_graph


@functools.lru_cache(maxsize=None)
def _directed():
    """The ``small_directed`` graph of ``tests/conftest.py``."""
    return random_graph(60, 3.0, seed=1, directed=True)


def _items(n, seed, heavy_every=0):
    """Seeded (pair, submit kwargs) items; every ``heavy_every``-th gets a
    budget of 1 superstep, so some end in TIMEOUT."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, _directed().n_real, (n, 2)).astype(np.int32)
    return [(p, dict(budget=1 if heavy_every and i % heavy_every == 1 else 64))
            for i, p in enumerate(pairs)]


def _virtual_cell(res) -> dict:
    """The fields of a LoadResult summary that the virtual clock fixes (the
    queue-wait and service splits are host seconds)."""
    cell = res.summary() if hasattr(res, "summary") else res
    return {k: v for k, v in cell.items() if not k.startswith(("qwait", "service"))}


# ----------------------------------------------------------- arrivals
@pytest.mark.parametrize("process,kw", [
    ("poisson", {}), ("constant", {}), ("mmpp", {}),
    ("poisson", dict(start=3.5)), ("mmpp", dict(burst=8.0, dwell=2.0)),
    ("mmpp", dict(burst=1.0, dwell=0.5, start=1.0))])
@pytest.mark.parametrize("rate,n,seed", [(2.0, 50, 7), (0.25, 7, 0), (900.0, 300, 12)])
def test_arrivals_bit_equal_to_jax(process, kw, rate, n, seed):
    got = loadgen.make_arrivals(process, rate, n, seed=seed, **kw)
    want = jloadgen.make_arrivals(process, rate, n, seed=seed, **kw)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (n,)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("call", [
    lambda m: m.make_arrivals("pareto", 1.0, 4),
    lambda m: m.poisson_arrivals(0.0, 4),
    lambda m: m.constant_arrivals(-1.0, 4),
    lambda m: m.mmpp_arrivals(1.0, 4, burst=0.5)])
def test_bad_arrival_arguments_raise_as_jax(call):
    with pytest.raises(ValueError) as want:
        call(jloadgen)
    with pytest.raises(ValueError) as got:
        call(loadgen)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ open loop
@functools.lru_cache(maxsize=None)
def _jax_open_loop(process, rate, capacity, heavy_every):
    items = _items(12, seed=6, heavy_every=heavy_every)
    eng = jppsp.make_bfs_engine(_directed(), capacity=capacity, result_cache=4)
    arr = jloadgen.make_arrivals(process, rate, len(items), seed=7)
    res = jloadgen.run_open_loop(eng, items, arr, offered_qps=rate)
    return res, {q: {k: np.asarray(v) for k, v in r.items()}
                 for q, r in eng.runtime.results.items()}


@pytest.mark.parametrize("process,rate", [("poisson", 1.0), ("poisson", 8.0),
                                          ("constant", 0.5), ("mmpp", 2.0)])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_virtual_clock_run_matches_jax(process, rate, backend):
    """Same items and arrivals: the same ticks, per-query latencies,
    backlog, statuses (TIMEOUTs included) and answers."""
    want, want_map = _jax_open_loop(process, rate, 2, 4)
    items = _items(12, seed=6, heavy_every=4)
    eng = ppsp.make_bfs_engine(port_graph(_directed()), capacity=2, result_cache=4,
                               backend=backend, block=16, device="cpu")
    arr = loadgen.make_arrivals(process, rate, len(items), seed=7)
    got = loadgen.run_open_loop(eng, items, arr, offered_qps=rate)
    assert got.latencies == want.latencies
    assert (got.ticks, got.max_backlog, got.makespan) == (
        want.ticks, want.max_backlog, want.makespan)
    assert got.statuses == want.statuses
    assert TIMEOUT in got.statuses.values() and DONE in got.statuses.values()
    assert _virtual_cell(got) == _virtual_cell(want)
    assert len(got.queue_waits) == sum(s == DONE for s in got.statuses.values())
    assert_same_results(eng.runtime.results, want_map)


def test_wall_clock_split_sums_to_latency():
    """Wall clock: every latency is positive, and the runtime's split of
    each query's latency into queue wait and service sums to it."""
    eng = ppsp.make_bfs_engine(port_graph(_directed()), capacity=1, device="cpu")
    items = _items(5, seed=12)
    res = loadgen.run_open_loop(eng, items, loadgen.constant_arrivals(200.0, 5),
                                clock="wall", offered_qps=200.0)
    assert res.clock == "wall" and len(res.latencies) == 5
    assert all(lat > 0 for lat in res.latencies)
    st = eng.stats
    assert len(res.queue_waits) == len(res.service_times) == 5
    for qw, sv, lat in zip(st.queue_waits, st.service_times, st.query_latencies):
        assert qw >= 0 and sv >= 0
        assert qw + sv == pytest.approx(lat, abs=1e-12)
    assert max(st.queue_waits) > 0  # capacity 1: later queries wait


def test_open_loop_rejects_bad_clock_and_shapes():
    eng = ppsp.make_bfs_engine(port_graph(_directed()), capacity=1, device="cpu")
    with pytest.raises(ValueError, match="clock"):
        loadgen.run_open_loop(eng, [], [], clock="logical")
    with pytest.raises(ValueError, match="one arrival per item"):
        loadgen.run_open_loop(eng, [np.zeros(2, np.int32)], [1.0, 2.0])


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    eng = jppsp.make_bfs_engine(_directed(), capacity=2)
    return jloadgen.sweep_qps(lambda: eng, _items(8, seed=13), (0.1, 1.0, 8.0), seed=14)


def test_sweep_and_knee_match_jax():
    eng = ppsp.make_bfs_engine(port_graph(_directed()), capacity=2, device="cpu")
    got = loadgen.sweep_qps(lambda: eng, _items(8, seed=13), (0.1, 1.0, 8.0), seed=14)
    want = _jax_sweep()
    assert sorted(got["curve"]) == sorted(want["curve"]) == [0.1, 1.0, 8.0]
    for rate in want["curve"]:
        assert _virtual_cell(got["curve"][rate]) == _virtual_cell(want["curve"][rate])
    assert got["knee"] == want["knee"] and got["curve"][0.1]["busy_qps"] >= 0.1


@pytest.mark.parametrize("curve,tol", [
    ({1.0: {"busy_qps": 0.99}, 2.0: {"busy_qps": 1.95}, 4.0: {"busy_qps": 2.10}}, 0.9),
    ({4.0: {"busy_qps": 1.0}}, 0.9),
    ({1.0: {"achieved_qps": 0.95}}, 0.9),
    ({1.0: {"busy_qps": 0.6}, 3.0: {"busy_qps": 2.0}}, 0.6)])
def test_saturation_knee_matches_jax(curve, tol):
    got, want = loadgen.saturation_knee(curve, tol=tol), jloadgen.saturation_knee(curve, tol=tol)
    assert got == want or (math.isnan(got) and math.isnan(want))


# ----------------------------------------------------------------- env
def test_env_detect_reports_host():
    d = envmod.detect({})
    assert d["cpus"] >= 1
    assert d["tcmalloc_active"] is False and d["omp_num_threads"] is None


def test_env_advise_rows_and_exports():
    rows = envmod.advise(threads=4, env={})
    by_var = {r["var"]: r for r in rows}
    assert by_var["OMP_NUM_THREADS"]["value"] == "4"
    assert by_var["CUDA_MODULE_LOADING"]["value"] == "LAZY"
    assert by_var["TORCH_CPP_LOG_LEVEL"]["value"] == "ERROR"
    assert all(not r["active"] for r in rows)
    exports = envmod.shell_exports(threads=4)
    assert "export OMP_NUM_THREADS=4" in exports
    # one row for each row of the JAX module, tcmalloc only where it exists
    has_lib = envmod.find_tcmalloc() is not None
    assert ("LD_PRELOAD" in by_var) == has_lib
    assert len(rows) == len(__import__("repro.launch.env", fromlist=["advise"])
                            .advise(host_devices=4, env={}))


def test_env_apply_respects_existing():
    env = {"OMP_NUM_THREADS": "2"}
    applied = envmod.apply(env, threads=8)
    assert "OMP_NUM_THREADS" not in applied     # already set: kept
    assert "LD_PRELOAD" not in applied          # advisory only
    assert env["CUDA_MODULE_LOADING"] == "LAZY"
    assert envmod.detect(env)["omp_num_threads"] == 2
    assert envmod.apply(env, threads=8, overwrite=True)["OMP_NUM_THREADS"] == "8"


def test_env_active_flags_and_describe():
    env = {"OMP_NUM_THREADS": "8", "CUDA_MODULE_LOADING": "LAZY",
           "TORCH_CPP_LOG_LEVEL": "ERROR"}
    rows = {r["var"]: r for r in envmod.advise(env=env)}
    assert rows["OMP_NUM_THREADS"]["active"]
    assert rows["CUDA_MODULE_LOADING"]["active"]
    assert rows["TORCH_CPP_LOG_LEVEL"]["active"]
    line = envmod.describe(env)
    assert "omp_threads=8" in line and "module_loading=LAZY" in line
    assert f"torch={torch.__version__}" in line and f"cuda={torch.version.cuda}" in line
    assert "device=" in line


def test_env_cli_prints_report(capsys):
    assert envmod.main() == 0
    out = capsys.readouterr().out
    assert "# launcher prelude" in out and "export CUDA_MODULE_LOADING=LAZY" in out
