"""The measured window: a closed or an open loop of queries on the wall clock.

Closed loop: ``clients`` clients each issue their next query when their
last one is answered.  Open loop: queries are due at the arrival times of
a seeded process, each is submitted once its time has come, and its
latency runs from when it was due.  Either way the window lasts
``seconds``; a query counts in the window when the host holds its answer
by the window's close.  After the close ``drain`` follows what is still in
flight, up to ``drain_s`` more seconds, for the check of the answers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional


@dataclasses.dataclass
class Record:
    """One query: its content, when it was issued (closed loop) or due
    (open loop), when it was submitted and answered, and the answer."""

    query: Any
    t_issue: float
    t_submit: float
    t_done: float = float("nan")
    status: str = ""
    result: Any = None


class Window:
    """Drives ``target`` (``submit``/``pump``) through one window.

    ``next_query()`` gives the next query; ``arrivals`` (seconds from the
    opening, sorted) makes the loop open, else ``clients`` make it closed.
    """

    def __init__(self, target, next_query: Callable[[], Any], *, seconds: float,
                 drain_s: float, clients: int = 0, arrivals=None):
        if (arrivals is None) == (clients <= 0):
            raise ValueError("a window is closed (clients > 0) or open (arrivals)")
        self.target, self.next_query = target, next_query
        self.seconds, self.drain_s = float(seconds), float(drain_s)
        self.clients = int(clients)
        self.arrivals = None if arrivals is None else list(arrivals)
        self.records: list[Record] = []
        self.inflight: dict[int, Record] = {}
        self.t_open = self.t_close = float("nan")
        self.backlog_mid = None  # queries in flight at the window's middle
        self._next_due = 0

    def _submit(self, t_issue: float) -> None:
        q = self.next_query()
        t = time.perf_counter()
        rec = Record(q, t_issue, t)
        self.inflight[self.target.submit(q)] = rec
        self.records.append(rec)

    def _pump(self, reissue: bool) -> None:
        out = self.target.pump()
        t = time.perf_counter()
        for qid, res, status in out:
            rec = self.inflight.pop(qid)
            rec.t_done, rec.status, rec.result = t, status, res
            if reissue and t < self.t_close:
                self._submit(time.perf_counter())

    def _due(self, now: float) -> None:
        while (self._next_due < len(self.arrivals)
               and self.t_open + self.arrivals[self._next_due] <= now):
            due = self.t_open + self.arrivals[self._next_due]
            if due >= self.t_close:
                self._next_due = len(self.arrivals)
                break
            self._submit(due)
            self._next_due += 1

    def run(self, until: Optional[float] = None) -> None:
        """The window, or its part up to ``until`` seconds from the opening:
        returns there, and a later call goes on from there to the close."""
        if math.isnan(self.t_open):
            self.t_open = time.perf_counter()
            self.t_close = self.t_open + self.seconds
            if self.arrivals is None:
                for _ in range(self.clients):
                    self._submit(time.perf_counter())
        stop = self.t_close if until is None else min(self.t_close, self.t_open + until)
        if self.arrivals is None:
            while time.perf_counter() < stop:
                if not self.inflight:
                    break
                self._pump(True)
            return
        while True:
            now = time.perf_counter()
            if now >= stop:
                return
            if self.backlog_mid is None and now >= self.t_open + self.seconds / 2:
                self.backlog_mid = len(self.inflight)
            self._due(now)
            if self.inflight:
                self._pump(False)
            elif self._next_due < len(self.arrivals):
                nxt = self.t_open + self.arrivals[self._next_due]
                time.sleep(max(0.0, min(nxt, stop) - time.perf_counter()))
            else:
                time.sleep(max(0.0, stop - time.perf_counter()))

    def drain(self) -> None:
        """Follow the queries still in flight for up to ``drain_s`` seconds."""
        limit = self.t_close + self.drain_s
        while self.inflight and time.perf_counter() < limit:
            self._pump(False)

    # ------------------------------------------------------------ readings
    def answered(self) -> list[Record]:
        """Queries answered by the window's close."""
        return [r for r in self.records if r.status and r.t_done <= self.t_close]

    def unanswered(self) -> list[Record]:
        return [r for r in self.records if not r.status]
