"""The port's mesh engine (``QuegelEngine(mesh=...)``) against the JAX
package's single-device engine: same qid->result maps and the same
EngineStats (super_rounds, barriers, queries_done, supersteps) on all five
semirings, both edge partitions and steps_per_round in {1, 4}, with
mid-stream admission; BFS on a (2, 4) mesh; BiBFS on both partitions; the
|V| % 8 refusal naming ``Graph.padded``, then padded parity (the port of
tests/test_sharded_engine.py's subprocess).  Those run in one spawned
8-rank gloo group, and every rank must return the same.

In-process, on a world-size-1 gloo group: every validation of the JAX
engine's ``test_mesh_validation`` with the JAX engine's messages,
one-part mesh parity, and ``collective_bytes_per_round()`` equal to the
JAX engine's on a 1-part JAX mesh; the 8-rank group's models apply the
(w - 1)/w and 2x factors to the JAX engine's payloads."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch.distributed as dist

from repro.apps import ppsp as jppsp
from repro.core.engine import QuegelEngine as JEngine
from repro.core.engine import VertexProgram as JVertexProgram
from repro.core.graph import Graph as JGraph
from repro.core.graph import random_graph
from repro.core.semiring import BY_NAME as JSR
from repro.launch.mesh import make_mesh as jmake_mesh

from repro_torch.apps import ppsp
from repro_torch.core.engine import QuegelEngine
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh

import _torch_mesh
from _torch_common import fields_np, port_graph

SEMIRINGS = ["min_plus", "min_right", "max_plus", "max_right", "sum_times"]
MATRIX = [(sr, part, k) for sr in SEMIRINGS for part in ("dst", "src") for k in (1, 4)]


class JProbe(JVertexProgram):
    """tests/test_sharded_engine.py's probe: ``steps`` supersteps of one
    semiring's propagation from a query-seeded state."""

    def __init__(self, sr, steps=3):
        self.sr = sr
        self.steps = steps

    def init(self, graph, query, index=None):
        dt = jnp.float32 if self.sr.name == "sum_times" else jnp.int32
        seed = 1.0 if self.sr.name == "sum_times" else 0
        x = jnp.full((graph.n,), self.sr.add_id, dt).at[query[0] % graph.n].set(seed)
        return dict(x=x)

    def superstep(self, state, ctx):
        y = ctx.propagate(self.sr, state["x"])
        return dict(x=self.sr.add(state["x"], y)), ctx.step >= self.steps

    def extract(self, state, query):
        return dict(x=state["x"])


@functools.lru_cache(maxsize=None)
def _graphs():
    g = random_graph(64, 3.0, seed=1, directed=True)
    rng = np.random.default_rng(0)
    gf = JGraph.from_edges(np.asarray(g.src), np.asarray(g.dst), g.n_real,
                           w=rng.standard_normal(g.num_edges), weight_dtype=np.float32)
    return g, gf, random_graph(60, 3.0, seed=2, directed=True)


@functools.lru_cache(maxsize=None)
def _pairs():
    return [(int(a), int(b))
            for a, b in np.random.default_rng(3).integers(0, _graphs()[0].n_real, (6, 2))]


@functools.lru_cache(maxsize=None)
def _jax_probe(sr, k):
    """The JAX single-device engine's (results, stats) and its discovery
    payloads (the collective model's inputs, from a 1-part JAX mesh)."""
    g, gf, _ = _graphs()
    gg = gf if sr == "sum_times" else g
    q0 = jnp.zeros((1,), jnp.int32)
    res, stats = _torch_mesh.run_staged(
        JEngine(gg, JProbe(JSR[sr]), 2, example_query=q0, steps_per_round=k))
    one = JEngine(gg, JProbe(JSR[sr]), 2, example_query=q0, steps_per_round=k,
                  mesh=jmake_mesh((1,), ("w",)))
    return res, stats, dict(one._collective_model)


@functools.lru_cache(maxsize=None)
def _jax_drain(kind, k=1):
    g, _, g60 = _graphs()
    if kind == "bfs":
        eng = jppsp.make_bfs_engine(g, capacity=3)
    elif kind == "padded":
        eng = jppsp.make_bfs_engine(g60, capacity=3)
    else:
        eng = jppsp.make_bibfs_engine(g, capacity=3, steps_per_round=k)
    return _torch_mesh.drain_staged(eng, _pairs())


def _same(got, want, approx=False):
    assert sorted(got) == sorted(want)
    for q in want:
        assert sorted(got[q]) == sorted(want[q])
        for key in want[q]:
            a, b = got[q][key], np.asarray(want[q][key])
            assert a.dtype == b.dtype and a.shape == b.shape, (q, key)
            if approx:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- 8 spawned ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g, gf, g60 = _graphs()
    handle = _torch_mesh.start_ranks(
        8, "engine_work", tmp_path_factory.mktemp("engine8"),
        g=fields_np(g), gf=fields_np(gf), pairs=_pairs(), g60=fields_np(g60))
    # the JAX references, while the ranks run
    for sr, _, k in MATRIX:
        _jax_probe(sr, k)
    for kind, k in (("bfs", 1), ("padded", 1), ("bibfs", 1), ("bibfs", 4)):
        _jax_drain(kind, k)
    return _torch_mesh.wait_ranks(handle, timeout=300)


@pytest.mark.parametrize("sr,part,k", MATRIX)
def test_mesh_parity_matrix_matches_jax(ranks, sr, part, k):
    want, want_stats, payload = _jax_probe(sr, k)
    for r, out in enumerate(ranks):
        got, got_stats, model = out["probe", sr, part, k]
        assert got_stats == want_stats, (r, got_stats, want_stats)
        _same(got, want, approx=(sr == "sum_times"))
        assert model["partition"] == part and model["n_parts"] == 8
        assert model["propagate_calls_per_superstep"] == 1
        assert model["round_total_bytes"] > 0


@pytest.mark.parametrize("part", ["dst", "src"])
def test_collective_model_factors_at_w8(ranks, part):
    """(w - 1)/w of the JAX engine's payloads for dst, twice that for src;
    the round-entry state gather at (w - 1)/w either way."""
    for sr, k in (("min_right", 1), ("sum_times", 4)):
        payload = _jax_probe(sr, k)[2]
        model = ranks[0]["probe", sr, part, k][2]
        f = 7 / 8 * (1 if part == "dst" else 2)
        assert model["propagate_bytes_per_superstep"] == (
            payload["propagate_payload_bytes_per_superstep"] * f)
        assert model["state_gather_bytes"] == payload["state_gather_payload_bytes"] * 7 / 8
        assert model["round_total_bytes"] == (
            model["state_gather_bytes"] + k * model["propagate_bytes_per_superstep"])


def test_bfs_on_2x4_mesh_matches_jax(ranks):
    want, want_stats = _jax_drain("bfs")
    for out in ranks:
        _same(out["bfs24"][0], want)
        assert out["bfs24"][1] == want_stats


@pytest.mark.parametrize("part,k", [(p, k) for p in ("dst", "src") for k in (1, 4)])
def test_bibfs_mesh_matches_jax(ranks, part, k):
    want, want_stats = _jax_drain("bibfs", k)
    for out in ranks:
        got, stats, model = out["bibfs", part, k]
        _same(got, want)
        assert stats == want_stats
        # two views: two collectives per superstep
        assert model["propagate_calls_per_superstep"] == 2


def test_host_and_elastic_meshes_match_jax_shapes(ranks):
    """launch/mesh.py's shapes over 8 ranks: the JAX functions' over 8
    devices (1-D ("w",); the largest (data, model) with model <= min_model
    dividing 8)."""
    for out in ranks:
        assert out["meshes"] == [((8,), ("w",)), ((2, 4), ("data", "model")),
                                 ((4, 2), ("data", "model"))]


def test_unpadded_refusal_then_padded_parity(ranks):
    want, want_stats = _jax_drain("padded")
    for out in ranks:
        assert "Graph.padded(8)" in out["refusal"]
        _same(out["padded"][0], want)
        assert out["padded"][1] == want_stats


# --------------------------------------------- in-process, world size 1
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    path = tmp_path_factory.mktemp("group1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=1, rank=0)
    try:
        yield make_mesh((1,), ("w",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _bfs(g, **kw):
    return ppsp.make_bfs_engine(g, capacity=2, **({"device": "cpu"} | kw))


def _misuse(g, mesh):
    """(what, kwargs) of every refusal of the JAX test_mesh_validation."""
    return [
        ("legacy", dict(mesh=mesh, legacy=True)),
        ("override", dict(mesh=mesh, propagate_override={"default": lambda sr, x, f: x})),
        ("pallas", dict(mesh=mesh, backend="pallas")),
        ("instance", dict(mesh=mesh, backend="coo_instance")),
        ("blocks", dict(mesh=mesh, blocks="blocks")),
        ("no mesh", dict(backend="sharded")),
        ("warmup", dict(mesh=mesh, warmup=True)),
    ]


def _resolve(kw, g, blocks, backend):
    kw = dict(kw)
    if kw.get("backend") == "coo_instance":
        kw["backend"] = backend(g)
    if kw.get("blocks") == "blocks":
        kw["blocks"] = blocks
    return kw


def test_mesh_validation_matches_jax(small_directed, mesh1):
    jg = small_directed
    g = port_graph(jg)
    jmesh = jmake_mesh((1,), ("w",))
    for what, kw in _misuse(g, mesh1):
        with pytest.raises(ValueError) as got:
            _bfs(g, **_resolve(kw, g, g.to_blocks(16, 0), ops.CooBackend))
        jkw = dict(_misuse(jg, jmesh))[what]
        from repro.kernels import ops as jops

        with pytest.raises(ValueError) as want:
            jppsp.make_bfs_engine(jg, capacity=2,
                                  **_resolve(jkw, jg, jg.to_blocks(16, 0), jops.CooBackend))
        if what not in ("instance", "warmup"):  # an object's repr; a JAX compile note
            assert str(got.value) == str(want.value), what
    with pytest.raises(ValueError):
        ops.make_backend("no_such_plan", g)
    with pytest.raises(ValueError):  # one instance cannot serve the rev view
        ppsp.make_bibfs_engine(g, capacity=2, backend=ops.CooBackend(g), device="cpu")
    with pytest.raises(ValueError, match="one padded vertex space"):
        QuegelEngine(g, ppsp.BiBFSProgram(), 2, aux_graphs={"rev": g.reverse().padded(64)},
                     example_query=np.zeros((2,), np.int32), mesh=mesh1)
    with pytest.raises(ValueError, match="no axis"):
        _bfs(g, mesh=mesh1, mesh_axis="model")


def test_one_part_mesh_parity(small_directed, mesh1):
    """A size-1 shard axis runs the whole mesh round structure and must
    already match the plain engine and the JAX engine."""
    jg = small_directed
    g = port_graph(jg)
    pairs = [(int(a), int(b))
             for a, b in np.random.default_rng(7).integers(0, jg.n_real, (5, 2))]

    def drain(eng):
        for p in pairs:
            eng.submit(np.asarray(p, np.int32))
        return _torch_mesh.result_map(eng.run_until_drained())

    want = drain(jppsp.make_bfs_engine(jg, capacity=2))
    for part in ("dst", "src"):
        eng = _bfs(g, mesh=mesh1, steps_per_round=2, partition=part)
        assert eng.device.type == "cpu"
        _same(drain(eng), want)
        assert eng.collective_bytes_per_round()["n_parts"] == 1
    _same(drain(_bfs(g)), want)
    assert _bfs(g).collective_bytes_per_round() is None


@pytest.mark.parametrize("make", ["bfs", "bibfs"])
@pytest.mark.parametrize("part,k", [("dst", 1), ("src", 2)])
def test_collective_bytes_match_jax_one_part(small_directed, mesh1, make, part, k):
    jg = small_directed
    jmake = {"bfs": jppsp.make_bfs_engine, "bibfs": jppsp.make_bibfs_engine}[make]
    tmake = {"bfs": ppsp.make_bfs_engine, "bibfs": ppsp.make_bibfs_engine}[make]
    want = jmake(jg, capacity=3, steps_per_round=k, partition=part,
                 mesh=jmake_mesh((1,), ("w",))).collective_bytes_per_round()
    got = tmake(port_graph(jg), capacity=3, steps_per_round=k, partition=part,
                mesh=mesh1).collective_bytes_per_round()
    assert got == want
