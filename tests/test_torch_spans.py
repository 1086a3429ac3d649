"""The port's own spans: ``spans.span`` around the round's phases
(``quegel.*``) and around a tile plan's gate and kernel, nested under
``quegel.round``, and nothing at all while no profiler records."""
import numpy as np
import pytest
import torch

from repro_torch.apps.ppsp import make_bibfs_engine
from repro_torch.configs import get_arch, reduced
from repro_torch.core import spans
from repro_torch.core.graph import Graph
from repro_torch.core.runtime import DONE, TIMEOUT
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.models import transformer as T

SPANS = {"quegel.round", "quegel.admit", "quegel.step", "quegel.gate", "quegel.kernel",
         "quegel.sync", "quegel.collect", "quegel.retire"}
PHASES = ("quegel.admit", "quegel.step", "quegel.sync", "quegel.collect", "quegel.retire")


def _random_graph(n=300, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    keep = src != dst
    return Graph.from_edges(src[keep], dst[keep], n, device="cpu")


def _path_graph(n=64):
    """0 - 1 - ... - n-1, both arcs: a query from one end to the other takes
    about n/2 BiBFS supersteps."""
    a = np.arange(n - 1)
    return Graph.from_edges(np.r_[a, a + 1], np.r_[a + 1, a], n, device="cpu")


def _pairs(n, k, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n, 2).astype(np.int32) for _ in range(k)]


def _traced(run) -> dict:
    """name -> [(start, end)] of every ``quegel.*`` span that ``run`` made."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("quegel."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _within(iv, outer) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in outer)


def _assert_nested_in_rounds(got: dict, rounds: int):
    """One ``quegel.round`` per executed round; every other span inside
    one, and a round's phases take no more than the round itself."""
    assert len(got["quegel.round"]) == rounds
    for name, ivs in got.items():
        assert all(_within(iv, got["quegel.round"]) for iv in ivs), name
    for a, b in got["quegel.round"]:
        inner = [iv for n in PHASES for iv in got.get(n, []) if a <= iv[0] and iv[1] <= b]
        assert sum(y - x for x, y in inner) <= b - a


@pytest.mark.parametrize("backend", ["cuda", "blocks_ref"])
def test_a_round_spans_its_phases_inside_quegel_round(backend):
    eng = make_bibfs_engine(_random_graph(), capacity=4, backend=backend, device="cpu")
    for p in _pairs(300, 6, seed=1):
        eng.submit(p)
    got = _traced(eng.run_until_drained)
    assert set(got) == SPANS
    _assert_nested_in_rounds(got, eng.stats.rounds)
    steps = got["quegel.step"]
    assert len(steps) == eng.stats.rounds * eng.steps_per_round
    # BiBFS propagates forward and backward each superstep, each call once
    # through the gate and once through the plan's run
    for name in ("quegel.gate", "quegel.kernel"):
        assert len(got[name]) == 2 * len(steps)
        assert all(_within(iv, steps) for iv in got[name])
    assert len(got["quegel.collect"]) == len(got["quegel.retire"]) <= eng.stats.rounds


def test_no_span_is_created_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = make_bibfs_engine(_random_graph(), capacity=4, backend="cuda", device="cpu")
    for p in _pairs(300, 6, seed=2):
        eng.submit(p)
    eng.run_until_drained()
    assert eng.stats.rounds > 0 and made == []
    assert spans.span("quegel.round") is spans.span("quegel.step")
    # the same patch sees every span once a profiler records
    for p in _pairs(300, 2, seed=3):
        eng.submit(p)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.run_until_drained()
    assert set(made) == SPANS


@pytest.mark.parametrize("legacy", [False, True])
def test_rounds_that_admit_retire_or_evict_nothing_are_spanned_alike(legacy):
    """Rounds that admit nothing, retire nothing, retire, and evict (a
    budget TIMEOUT): each is one ``quegel.round`` holding its phases."""
    eng = make_bibfs_engine(_path_graph(), capacity=2, backend="coo", device="cpu",
                            legacy=legacy)
    short = [eng.submit(np.asarray((i, i + 2), np.int32)) for i in (3, 10, 20)]
    doomed = eng.submit(np.asarray((0, 63), np.int32), budget=3)
    long = eng.submit(np.asarray((0, 40), np.int32))
    got = _traced(eng.run_until_drained)
    rounds = eng.stats.rounds
    assert [eng.status[q] for q in short + [long]] == [DONE] * 4
    assert eng.status[doomed] == TIMEOUT
    _assert_nested_in_rounds(got, rounds)
    assert len(got["quegel.sync"]) == rounds
    assert 0 < len(got["quegel.collect"]) == len(got["quegel.retire"]) < rounds
    # the fused round admits only when a slot is filled; the legacy round
    # reads liveness in its admission every round
    assert 0 < len(got["quegel.admit"]) <= rounds
    assert (len(got["quegel.admit"]) == rounds) == legacy


def test_preempted_rounds_are_spanned_alike():
    eng = make_bibfs_engine(_path_graph(), capacity=2, backend="coo", device="cpu",
                            scheduler="priority", preemptive=True)
    slow = [eng.submit(np.asarray((0, 63), np.int32), priority=5),
            eng.submit(np.asarray((63, 0), np.int32), priority=5)]
    fast = []

    def run():
        for _ in range(3):
            eng.runtime.run_round()
        fast.extend(eng.submit(np.asarray((i, i + 1), np.int32), priority=0) for i in (5, 30))
        eng.run_until_drained()

    got = _traced(run)
    assert eng.stats.preemptions > 0 and eng.stats.resumes > 0
    assert all(eng.status[q] == DONE for q in slow + fast)
    _assert_nested_in_rounds(got, eng.stats.rounds)


def test_the_servers_rounds_are_spanned_by_the_runtime():
    """``launch/serve.py``'s program spans no phase of its own: its rounds
    carry the runtime's round, collection and retirement spans only."""
    cfg = reduced(get_arch("tinyllama-1.1b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = SlotServer(cfg, params, capacity=2, max_len=32, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(4):
        srv.submit(Request(i, rng.integers(0, cfg.vocab, 4, dtype=np.int32),
                           max_new_tokens=3, budget=2 if i == 3 else 0))
    got = _traced(srv.run_until_drained)
    assert srv.runtime.status[3] == TIMEOUT
    assert set(got) == {"quegel.round", "quegel.collect", "quegel.retire"}
    _assert_nested_in_rounds(got, srv.runtime.stats.rounds)
