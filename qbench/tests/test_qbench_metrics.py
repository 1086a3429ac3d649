"""Each metric reader, and the trace summary under them, on a synthetic
trace whose numbers are worked out by hand."""
import importlib.util
import json

import pytest

from qbench import harness, trace
from qbench.loops import Record
from qbench.tests.tiny import QBENCH

US = 1e-6


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# times in us: a 1,000 us window; count span 50-90, propagate 100-200,
# slot_round 400-750; kernels launched from each, and a copy with no launch
EVENTS = [
    x("user_annotation", "qbench.window", 0, 1000),
    x("user_annotation", "qbench.count", 50, 40),
    x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=1),
    x("user_annotation", "qbench.propagate", 100, 100),
    x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=2),
    x("cpu_op", "aten::foo", 300, 60),
    x("user_annotation", "qbench.slot_round", 400, 350),
    x("cpu_op", "aten::bar", 450, 100),
    x("cuda_runtime", "cudaLaunchKernel", 460, 1, corr=3),
    x("kernel", "count_k", 100, 20, tid=99, corr=1),
    x("kernel", "prop_k", 150, 50, tid=99, corr=2),
    x("kernel", "other_k", 500, 100, tid=99, corr=3),
    x("gpu_memcpy", "Memcpy HtoD", 800, 10, tid=99),
    x("user_annotation", "qbench.propagate", 0, 1000, tid=2),
    {"ph": "i", "name": "marker", "ts": 5},
]


@pytest.fixture
def summary():
    return trace.summarize(EVENTS)


def reader(name):
    spec = importlib.util.spec_from_file_location(name, QBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def context(summary=None, **kw):
    recs = [Record(None, t, t, t + lat) for t, lat in
            zip(range(20), [0.010 * (i + 1) for i in range(20)])]
    stats = {"round_times": [0.002, 0.004], "queue_waits": [0.001 * i for i in range(21)],
             "service_times": [0.01 * i for i in range(21)], "slot_occupancy": [8, 6]}
    base = dict(seconds=4.0, setup_s=12.5, answered=recs, capacity=8, steps_per_round=1,
                stats=stats, summary=summary, bytes_counted=None, peaks=None)
    base.update(kw)
    return harness.Context(**base)


def test_summary_sorts_device_time_by_the_launching_span(summary):
    assert summary.window == pytest.approx((0.0, 1000 * US))
    regions = {name: region for _, _, name, region in summary.device}
    assert regions == {"count_k": "count", "prop_k": "propagate", "other_k": "other",
                       "Memcpy HtoD": "other"}
    assert summary.count_spans == [pytest.approx((50 * US, 90 * US))]
    assert all(h[2] != "qbench.window" for h in summary.host)


def test_device_idle_leaves_the_count_out(summary):
    # kept window 1,000 - 40 us; busy 50 + 100 + 10 us (the count kernel out)
    assert reader("device_idle")(context(summary)) == pytest.approx((1 - 160 / 960) * 100)


def test_ops_device_ms_is_outside_work_per_superstep(summary):
    assert reader("ops_device_ms")(context(summary)) == pytest.approx(110 * US / 2 * 1e3)
    assert reader("ops_device_ms")(context(summary, steps_per_round=2)) == pytest.approx(
        110 * US / 4 * 1e3)


def test_propagate_roofline_is_the_byte_bound_over_the_spans_device_time(summary):
    peaks = {"hbm_bytes_per_s": 3.35e12}
    ctx = context(summary, peaks=peaks, bytes_counted=int(3.35e12 * 25 * US))
    assert reader("propagate_roofline")(ctx) == pytest.approx(50.0)
    assert reader("propagate_roofline")(context(summary, bytes_counted=10)) is None


def test_readers_without_a_trace_find_nothing():
    for name in ("device_idle", "ops_device_ms", "propagate_roofline"):
        assert reader(name)(context()) is None


def test_program_counter_readers():
    ctx = context()
    assert reader("slot_fill")(ctx) == pytest.approx(7 / 8 * 100)
    assert reader("round_ms")(ctx) == pytest.approx(3.0)
    assert reader("queue_wait_p95_ms")(ctx) == pytest.approx(19.0)
    assert reader("service_p95_ms")(ctx) == pytest.approx(190.0)
    empty = context(stats={k: [] for k in harness.STAT_LISTS})
    assert all(reader(n)(empty) is None for n in
               ("slot_fill", "round_ms", "queue_wait_p95_ms", "service_p95_ms"))


def test_end_to_end_readers():
    ctx = context()
    assert reader("qps")(ctx) == pytest.approx(5.0)
    assert reader("p50_ms")(ctx) == pytest.approx(105.0)
    assert reader("p95_ms")(ctx) == pytest.approx(190.5)
    assert reader("setup_s")(ctx) == 12.5


def test_the_tail_read_per_layer_is_the_end_to_end_p95():
    ctx = context()
    assert reader("tail_p95_ms")(ctx) == pytest.approx(reader("p95_ms")(ctx))
    assert reader("tail_p95_ms")(context(answered=[])) is None


def test_breakdown_names_idle_time_by_the_host(summary):
    b = trace.breakdown(summary)
    assert b["device_ops"] == [["other_k", pytest.approx(100 * US)],
                               ["prop_k", pytest.approx(50 * US)],
                               ["Memcpy HtoD", pytest.approx(10 * US)]]
    got = {k: v for k, v in b["idle_gaps"]}
    assert got == {"qbench.client > aten::foo": pytest.approx(300 * US),
                   "qbench.client": pytest.approx(240 * US),
                   "qbench.slot_round": pytest.approx(200 * US),
                   "qbench.propagate > cudaLaunchKernel": pytest.approx(60 * US)}


def test_a_trace_file_is_read_one_event_at_a_time(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": EVENTS,
                                "traceName": "x"}, indent=2))
    assert list(trace.load_trace(path)) == EVENTS


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def test_interval_helpers():
    assert trace.union([(3, 4), (0, 2), (1, 3)]) == [(0, 4)]
    assert trace.subtract((0, 10), [(2, 3), (8, 12)]) == [(0, 2), (3, 8)]
    assert trace.intersect([(0, 5), (6, 9)], [(4, 7)]) == [(4, 5), (6, 7)]
    assert trace.measure([(0, 2), (3, 4)]) == 3
