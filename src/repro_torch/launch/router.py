"""Multi-replica query router with hash-affine placement, in the port.

The JAX package's ``launch/router.py`` over the port's engines: the same
policies, placement and merging.  Placement hashes the engine's result
cache key, which the port spells as the JAX package does (graph content
hash, then the query hash of ``core/runtime.py::default_cache_key``), so
a query lands on the same replica in both packages.  Replicas that share
one card are pumped one after another; nothing here spans cards.

One engine saturates at its slot capacity; Quegel's answer to more load is
more replicas of the same immutable V-data.  ``ReplicaPool`` is the
host-side router in front of N engine front ends:

* **Hash-affine routing** (default): a query's home replica is derived
  from the SAME canonicalized query-pytree hash the result cache keys on
  (``core/runtime.py::default_cache_key`` via ``program.cache_key``), so
  a repeated query always lands where its cached result lives — each
  replica's LRU stays hot on 1/N of the key space instead of every
  replica churning the full space (which is what round-robin does).
* **round-robin** (``policy="rr"``): the cache-oblivious baseline the
  bench A/Bs against.
* **power-of-two-choices with affinity bonus** (``policy="p2c"``): route
  home unless a second hash-derived candidate is at least
  ``p2c_bonus`` queued-or-running queries lighter — bounded spill that
  keeps hot keys from melting one replica while preserving affinity for
  everything else (each spill is counted).

Routing never touches result content, so the pool's merged
results/status/steps maps are identical to running every query on a
single engine — asserted in the tests and on the card by
``chip_smoke.py``.

Replicas share one immutable V-data build: ``boot_replicas_from_store``
reads the durable store (``core/store.py``) ONCE and hands the same in-memory
graph/index arrays to every replica factory — zero per-replica disk reads
or index rebuilds, which is what makes N replicas cheap to boot.

The pool speaks the same open-loop duck type the load generator drives
(``submit`` / ``pump`` / ``poll`` / ``pending`` / ``inflight``), so a
``ReplicaPool`` drops into ``launch/loadgen.py`` wherever an engine does.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional, Sequence

POLICIES = ("affine", "rr", "p2c")


class ReplicaPool:
    """Route queries across N engine replicas; merge their result maps.

    ``replicas`` are engine front ends (anything with ``submit``,
    ``runtime``).  Global qids are assigned by the pool in submission
    order (0, 1, 2, ...) — the same ids a single engine would assign —
    and mapped to per-replica local qids internally.
    """

    def __init__(self, replicas: Sequence, *, policy: str = "affine",
                 p2c_bonus: int = 2):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}: expected one of "
                f"{POLICIES}"
            )
        self.replicas = list(replicas)
        self.n = len(self.replicas)
        self.policy = policy
        self.p2c_bonus = int(p2c_bonus)
        self.results: dict[int, Any] = {}
        self.status: dict[int, str] = {}
        self.steps: dict[int, int] = {}
        self._rr_next = 0
        self._next_qid = 0
        self._to_global: dict[tuple[int, int], int] = {}
        self._replica_of: dict[int, int] = {}
        self.submits = [0] * self.n   # routed per replica (balance metric)
        self.spills = 0               # p2c: routed away from home

    # ------------------------------------------------------------- routing
    def _key(self, query) -> str:
        """Canonical query hash — shared with the result cache, so
        affinity and cache residency agree by construction.  Cache keys
        are graph-version-prefixed (``content_hash:query_hash``,
        DESIGN.md §12), so routing re-digests the WHOLE key: the bits
        must vary per query, not per graph."""
        key = self.replicas[0].runtime.program.cache_key(query)
        return hashlib.blake2b(key.encode()).hexdigest()

    def home_of(self, query) -> int:
        """The hash-affine home replica (deterministic across processes:
        derived from content, not identity)."""
        return int(self._key(query)[:16], 16) % self.n

    def _load(self, ri: int) -> int:
        rt = self.replicas[ri].runtime
        return rt.pending() + rt.inflight()

    def _route(self, query) -> int:
        if self.n == 1:
            return 0
        if self.policy == "rr":
            ri = self._rr_next
            self._rr_next = (ri + 1) % self.n
            return ri
        key = self._key(query)
        home = int(key[:16], 16) % self.n
        if self.policy == "affine":
            return home
        # p2c: second candidate from independent hash bits, excluding home
        alt = int(key[16:32], 16) % (self.n - 1)
        if alt >= home:
            alt += 1
        if self._load(alt) + self.p2c_bonus <= self._load(home):
            self.spills += 1
            return alt
        return home

    # -------------------------------------------------------------- client
    def submit(self, query, **submit_kw) -> int:
        ri = self._route(query)
        local = self.replicas[ri].submit(query, **submit_kw)
        gqid = self._next_qid
        self._next_qid += 1
        self._to_global[(ri, local)] = gqid
        self._replica_of[gqid] = ri
        self.submits[ri] += 1
        return gqid

    def pump(self) -> list[tuple[int, Any, str]]:
        """One round on every replica that has work; completions merged
        under global qids.  Same contract as ``SlotRuntime.pump``."""
        out: list[tuple[int, Any, str]] = []
        for ri, rep in enumerate(self.replicas):
            rt = rep.runtime
            for local, res, status in rt.pump():
                gqid = self._to_global[(ri, local)]
                self.results[gqid] = res
                self.status[gqid] = status
                self.steps[gqid] = int(rt.steps.get(local, 0))
                out.append((gqid, res, status))
        return out

    def poll(self, qid: int) -> Optional[tuple[str, Any]]:
        st = self.status.get(qid)
        if st is None:
            return None
        return st, self.results.get(qid)

    def pending(self) -> int:
        return sum(rep.runtime.pending() for rep in self.replicas)

    def inflight(self) -> int:
        return sum(rep.runtime.inflight() for rep in self.replicas)

    def drain(self, max_ticks: int = 100_000) -> dict[int, Any]:
        """Pump until every submitted query is terminal.  The first pump
        also flushes off-round completions (cache hits), so draining an
        all-hit workload costs zero rounds."""
        ticks = 0
        while True:
            got = self.pump()
            if not got and not self.pending() and not self.inflight():
                break
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"pool drain exceeded {max_ticks} ticks with "
                    f"{self.pending()} pending / {self.inflight()} in flight"
                )
        return dict(self.results)

    # --------------------------------------------------------------- stats
    @property
    def cache_hits(self) -> int:
        return sum(rep.runtime.stats.cache_hits for rep in self.replicas)

    def stats_summary(self) -> dict:
        """Balance + cache metrics for the bench tables."""
        rounds = [rep.runtime.stats.rounds for rep in self.replicas]
        total = sum(self.submits)
        return {
            "policy": self.policy,
            "replicas": self.n,
            "submits": list(self.submits),
            "balance": (self.n * max(self.submits) / total
                        if total else float("nan")),
            "spills": int(self.spills),
            "rounds": rounds,
            "cache_hits": int(self.cache_hits),
        }


def boot_replicas_from_store(
    store, factory: Callable[[int, dict], Any], n: int, *, device=None,
) -> list:
    """Boot ``n`` replicas from ONE durable-store read (DESIGN.md §10/§11).

    ``load_engine_store`` is called once, onto ``device`` (``cuda`` unless
    the caller passes another); every ``factory(i, parts)`` gets the same
    in-memory ``{"graph", "index", "aux_graphs", "tables"}`` dict —
    replicas share the immutable V-data tensors, and none of them
    re-reads the store or rebuilds an index or a table."""
    from repro_torch.core.store import load_engine_store

    parts = load_engine_store(store, device=device)
    return [factory(i, parts) for i in range(n)]
