"""Spans around the program's layers, the profiler's trace, and its summary.

``install_spans`` wraps the engine instance's ``submit``, ``pump`` and
``slot_round`` and each view backend's ``propagate`` in
``torch.profiler.record_function`` spans (``qbench.<name>``) from outside:
the program is not edited.  Around each ``propagate`` the wrapper also
counts the call's work (``roofline.propagate_bytes``) under a span of its
own, ``qbench.count``; every reader leaves that span's device time out.

``summarize`` reduces a Chrome trace (the profiler's export) to what the
readers need: each device operation with the span its launch fell in, the
host spans, and the traced window (the ``qbench.window`` span).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

import torch

from qbench import roofline

WINDOW = "qbench.window"
PROPAGATE = "qbench.propagate"
COUNT = "qbench.count"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
CLIENT = "qbench.client"


class ByteCounter:
    """The bytes of every ``propagate`` call until ``close``, summed on the
    device; calls after it (the drain's) are neither counted nor spanned."""

    def __init__(self, device):
        self.total = torch.zeros((), dtype=torch.int64, device=device)
        self.open = True

    def add(self, b: torch.Tensor) -> None:
        self.total += b

    def close(self) -> int:
        """Stop counting; the window's bytes."""
        self.open = False
        return int(self.total)


def _spanned(name: str, fn):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(f"qbench.{name}"):
            return fn(*a, **kw)
    return wrapped


def install_spans(engine, views: dict, counter: ByteCounter) -> None:
    """Wrap the engine's methods and each view's backend (``views``: view
    name -> (V,) out-degree of that view) on the instances."""
    for name in ("submit", "pump", "slot_round"):
        setattr(engine, name, _spanned(name, getattr(engine, name)))
    for view, backend in engine._backends.items():
        deg = views[view]
        inner = backend.propagate

        def propagate(sr, x, frontier=None, _inner=inner, _deg=deg):
            if not counter.open:
                return _inner(sr, x, frontier)
            with torch.profiler.record_function(COUNT):
                counter.add(roofline.propagate_bytes(_deg, sr.name, x, frontier))
            with torch.profiler.record_function(PROPAGATE):
                return _inner(sr, x, frontier)

        backend.propagate = propagate


# ----------------------------------------------------------------- summary
@dataclasses.dataclass
class Summary:
    """Times in seconds on the trace's clock.

    window        : (start, end) of the traced window
    device        : [(start, end, name, region)], region is the innermost
                    of ``qbench.propagate`` / ``qbench.count`` that the
                    launch fell in, else ``"other"``
    count_spans   : [(start, end)] host intervals of ``qbench.count``
    host          : [(start, end, name, is_span)] main-thread host events
    """

    window: tuple
    device: list
    count_spans: list
    host: list


def _intervals(evs) -> tuple[list, list]:
    evs = sorted(evs)
    return [a for a, _ in evs], [b for _, b in evs]


def _inside(starts: list, ends: list, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def summarize(events) -> Summary:
    """Reduce Chrome-trace events (``ph == "X"``, ``ts``/``dur`` in us), in
    one pass over any iterable of them."""
    us = 1e-6
    host, launch, device, window = [], {}, [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        a = e["ts"] * us
        b = a + e.get("dur", 0.0) * us
        if cat in DEVICE_CATS:
            device.append((a, b, sys.intern(e.get("name", "?")),
                           (e.get("args") or {}).get("correlation")))
            continue
        if cat not in HOST_CATS:
            continue
        thread = (e.get("pid"), e.get("tid"))
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (a, thread)
        name = e["name"]
        if cat == "user_annotation" and name == WINDOW:
            window = ((a, b), thread)
            continue
        host.append((a, b, sys.intern(name), cat == "user_annotation"
                     and name.startswith("qbench."), thread))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW} span")
    (lo, hi), main = window
    host = [h[:4] for h in host if h[4] == main]
    spans = {PROPAGATE: [], COUNT: []}
    for a, b, name, is_span in host:
        if is_span and name in spans:
            spans[name].append((a, b))
    prop, cnt = _intervals(spans[PROPAGATE]), _intervals(spans[COUNT])
    ops = []
    for a, b, name, corr in device:
        t, thread = launch.get(corr, (None, None))
        region = "other"
        if thread == main:
            if _inside(*cnt, t):
                region = "count"
            elif _inside(*prop, t):
                region = "propagate"
        ops.append((a, b, name, region))
    return Summary((lo, hi), ops, sorted(spans[COUNT]), host)


def load_trace(path):
    """The events of a Chrome trace file, one at a time (a large trace is
    never held whole as objects)."""
    text = Path(path).read_text()
    dec = json.JSONDecoder()
    i = text.index("[", text.index('"traceEvents"')) + 1
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            return
        e, i = dec.raw_decode(text, i)
        yield e


# --------------------------------------------------------------- intervals
def union(iv) -> list:
    """Sorted, merged ``[(start, end)]``."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def subtract(window: tuple, holes) -> list:
    """``window`` less the merged ``holes``."""
    out, cur = [], window[0]
    for a, b in union(holes):
        if b <= cur or a >= window[1]:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < window[1]:
        out.append((cur, window[1]))
    return out


def intersect(a, b) -> list:
    """Intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def measure(iv) -> float:
    return float(sum(b - a for a, b in iv))


def kept_window(s: Summary) -> list:
    """The traced window less the host intervals of ``qbench.count``."""
    return subtract(s.window, s.count_spans)


def busy(s: Summary) -> list:
    """Merged device-busy intervals inside the kept window, counting no
    operation launched under ``qbench.count``."""
    ops = union((a, b) for a, b, _, region in s.device if region != "count")
    return intersect(ops, kept_window(s))


def host_names(s: Summary, times: list) -> list:
    """For each time (sorted), what the main thread was doing: the
    innermost ``qbench.*`` span, and under it the innermost host
    operation, as ``"span > op"``; ``qbench.client`` outside every span."""
    evs = sorted(s.host, key=lambda e: (e[0], -e[1]))
    stack, i, out = [], 0, []
    for t in times:
        while i < len(evs) and evs[i][0] <= t:
            while stack and stack[-1][1] <= evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        span = next((e[2] for e in reversed(stack) if e[3]), CLIENT)
        op: Optional[str] = stack[-1][2] if stack and not stack[-1][3] else None
        out.append(span if op is None else f"{span} > {op}")
    return out


def breakdown(s: Summary, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by what the host was doing, ``top`` of each."""
    by_op: dict = {}
    for a, b, name, region in s.device:
        if region != "count":
            by_op[name] = by_op.get(name, 0.0) + (b - a)
    gaps = intersect(subtract(s.window, busy(s)), kept_window(s))
    names = host_names(s, [(a + b) / 2 for a, b in gaps])
    by_host: dict = {}
    for (a, b), name in zip(gaps, names):
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
