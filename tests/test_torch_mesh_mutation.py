"""Mutable graphs under the port's mesh engine, against the JAX package
(tests/test_mutation.py's two SPMD subprocesses, in the port).

One spawned 8-rank gloo group drives a BFS engine on an (8,) mesh with
queries in flight across two deltas, once with constant editions and
once with ``arg_carried=True``.  Every in-flight answer equals a fresh
single-device JAX engine's on the query's admission version, on every
rank; in arg-carried mode the shard-local splice keeps Emax, the spliced
partitions equal a full re-partition of the final graph row for row, and
no edition changes shapes (where the JAX engine asserts zero
recompiles)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import ppsp as jppsp
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph

import _torch_mesh
from _torch_common import fields_np


@functools.lru_cache(maxsize=None)
def _versions():
    """The tail graph padded to 8 parts, and the graphs after each delta."""
    core = random_graph(48, 3.0, seed=1, directed=True)
    src = np.concatenate([np.asarray(core.src), np.arange(48, 59)])
    dst = np.concatenate([np.asarray(core.dst), np.arange(49, 60)])
    g0 = JGraph.from_edges(src.astype(np.int32), dst.astype(np.int32), 60).padded(8)
    g1 = g0.apply_delta(adds=[(48, 58)])
    return g0, g1, g1.apply_delta(adds=[(0, 59)], dels=[(48, 58)])


@functools.lru_cache(maxsize=None)
def _fresh(version: int, s: int, t: int):
    e = jppsp.make_bfs_engine(_versions()[version], capacity=2)
    qid = e.submit(jnp.asarray([s, t], jnp.int32))
    return {k: np.asarray(v) for k, v in e.run_until_drained()[qid].items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = _torch_mesh.start_ranks(8, "mutation_work", tmp_path_factory.mktemp("mut8"),
                                     g0=fields_np(_versions()[0]))
    for v, s, t in ((0, 48, 59), (0, 48, 57), (1, 48, 59), (2, 48, 59)):
        _fresh(v, s, t)
    return _torch_mesh.wait_ranks(handle, timeout=240)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_spmd_versioned_parity_pin(ranks):
    for out in ranks:
        assert out["pin_live"] == 2
        for got, (v, s, t) in zip(out["pin"], ((0, 48, 59), (0, 48, 57), (1, 48, 59),
                                               (2, 48, 59))):
            _same(got, _fresh(v, s, t))
        assert int(out["pin"][0]["dist"]) != int(out["pin"][2]["dist"])


def test_spmd_arg_carried_shard_local_delta(ranks):
    for out in ranks:
        assert out["ac_live"] == 1
        for got, v in zip(out["ac"], (0, 1, 2)):
            _same(got, _fresh(v, 48, 59))
        assert int(out["ac"][0]["dist"]) == 11 and int(out["ac"][1]["dist"]) == 2
        emax, emax0 = out["ac_emax"]
        assert emax == emax0
        assert out["ac_rows_equal"]
        assert out["ac_shape_changes"] == 0
