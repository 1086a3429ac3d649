"""The per-cell checks of the harness on the CPU, one plain function each:
a sound run, a traced run's per-layer metrics, the program's spans, each
fault the timed path can have, and the control in the program's place.

Each takes a tiny checkout (``tiny.make_root``), its parsed
``BENCHMARK.json`` and a cell's name, and asserts only what that file lists
for the cell, so a cell that joins by files and entries alone is held to
the same checks as the cells already there.  A cell reports the metrics that
name it under ``workloads`` and those that name no cells; on the CPU, which
has no device, a traced run reads every listed metric of the program's
counters and spans and of the host's clock, and no kernel's roofline.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json

import pytest
import torch

from qbench import harness
from qbench.tests.tiny import ROOT

# read once at import, the same in every worker, so each collects the same cases
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READ_ON_THE_CPU = {"program_counter", "program_span", "host_clock"}


@pytest.fixture(autouse=True)
def only_what_the_run_loads(monkeypatch):
    """A run is its own process; in a test process other tests may already
    have loaded JAX, so only what a run loads counts here."""
    before = set(harness.forbidden_modules())
    orig = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: sorted(set(orig()) - before))


def run_cell(root, workload, *extra, fault=None, seconds="0.5"):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", workload, "--seed", "2147483659",
                           "--seconds", seconds, *extra],
                          root=root, device="cpu", fault=fault)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def listed(bench, kind, workload):
    """The ``kind`` metrics of ``bench`` that the cell reports, by name."""
    return {m["name"]: m for m in bench[kind] if workload in m.get("workloads", [workload])}


# --------------------------------------------------------------- the checks
def sound(root, bench, workload):
    """A sound run is correct and reports the cell's end-to-end metrics,
    with each number compared beside its limit last."""
    rc, res, err = run_cell(root, workload)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == set(listed(bench, "end_to_end", workload))
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "(limit " in line for line in tail)


def traced(root, bench, workload):
    """A traced run reports every listed per-layer metric that the CPU can
    read, and none that the cell does not list."""
    rc, res, err = run_cell(root, workload, "--trace", "1")
    assert rc == 0, err
    assert res["correct"] is True
    mine = listed(bench, "per_layer", workload)
    readable = {name for name, m in mine.items() if m["source"] in READ_ON_THE_CPU}
    assert readable <= set(res["metrics"]) <= set(mine)
    # no device on the CPU: no byte count over a device's time
    assert "propagate_roofline" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def spans(root, bench, workload):
    """A traced run reads each listed metric of the program's spans above 0,
    and the round off its barrier within the round's counted time."""
    rc, res, err = run_cell(root, workload, "--trace", "1")
    assert rc == 0, err
    m = res["metrics"]
    mine = listed(bench, "per_layer", workload)
    for name, entry in mine.items():
        if entry["source"] == "program_span":
            assert name in m and m[name]["value"] > 0, name
    if {"round_host_ms", "round_ms"} <= set(mine):
        assert m["round_host_ms"]["value"] < m["round_ms"]["value"] * 1.5
    # the CPU launches nothing on a device
    assert "step_launches" not in m


def broken(root, bench, workload, fault):
    """With the timed path broken underneath by ``fault``, not correct."""
    rc, res, err = run_cell(root, workload, fault=fault)
    assert rc == 0, err
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def control(root, bench, workload):
    """The control in the program's place: the app's own comparison judges
    its answers and finds them wrong."""
    rc, res, err = run_cell(root, workload, "--control", "1")
    assert rc == 0, err
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert "the control answers" in err


# --------------------------------------------------------------- the faults
def stale_state(engine):
    """A step that returns its state unchanged."""
    prog = engine.program
    inner = prog.superstep

    def superstep(state, ctx):
        return state, inner(state, ctx)[1]

    prog.superstep = superstep


def half_batch(engine):
    """Half of the batch left out: the upper half of the lanes sends nothing."""
    for backend in engine._backends.values():
        inner = backend.propagate

        def propagate(sr, x, frontier=None, _inner=inner):
            keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            keep[x.shape[0] // 2:] = False
            f = keep[:, None] if frontier is None else frontier & keep[:, None]
            return _inner(sr, x, f)

        backend.propagate = propagate


def altered_answer(engine):
    """An answer altered where it is produced: every other slot's distance."""
    prog = engine.program
    inner = prog.extract

    def extract(state, query):
        res = dict(inner(state, query))
        bump = torch.zeros_like(res["dist"])
        bump[::2] = 1
        res["dist"] = res["dist"] + bump
        return res

    prog.extract = extract


FAULTS = (stale_state, half_batch, altered_answer)
# every per-cell check, by the name a test case takes
CHECKS = {"sound": sound, "traced": traced, "spans": spans,
          **{f.__name__: functools.partial(broken, fault=f) for f in FAULTS},
          "control": control}
