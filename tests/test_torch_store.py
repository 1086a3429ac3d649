"""The port's durable store (``repro_torch/core/store.py``) against the JAX
package's: atomic content-hashed entries, template-free restore, sharded
files, corruption refusal, the Hub² zero-rebuild boot path, and entries of
plain dicts and arrays that each package reads back from the other."""
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.apps import hub2 as jhub2
from repro.core import store as jstore
from repro.core.graph import random_graph

from repro_torch.apps import hub2, ppsp
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import Graph, PackedBlocks
from repro_torch.core.store import (
    Store, StoreError, _resolve_class, load_engine_store, save_engine_store,
    verify_manifest)

from _torch_common import port_graph


@pytest.fixture()
def store(tmp_path):
    return Store(str(tmp_path / "store"))


@functools.lru_cache(maxsize=None)
def _jax_graph(seed=1, directed=True):
    return random_graph(60, 3.0, seed=seed, directed=directed)


def _small_directed():
    return port_graph(_jax_graph())


def _graphs_equal(a: Graph, b: Graph) -> bool:
    return a.content_hash() == b.content_hash() and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ("src", "dst", "w", "in_deg", "out_deg", "csr_row", "csr_src",
                  "csr_dst", "csr_w"))


# --------------------------------------------------------------- roundtrips
def test_graph_roundtrip(store):
    g0 = _small_directed()
    store.put("graph", g0)
    g = store.get("graph", device="cpu")
    assert isinstance(g, Graph)
    assert g.n == g0.n and g.n_real == g0.n_real
    assert _graphs_equal(g, g0)
    assert g.content_hash() == _jax_graph().content_hash()


def test_nested_pytree_roundtrip(store):
    obj = {
        "a": torch.arange(5, dtype=torch.int32),
        "b": [1, "two", 3.5, None, True],
        "c": (np.float32(2.5), {"deep": np.ones((2, 3), np.float32)}),
    }
    store.put("misc", obj, meta={"note": "x"})
    got = store.get("misc", device="cpu")
    assert torch.equal(got["a"], torch.arange(5, dtype=torch.int32))
    assert got["b"] == [1, "two", 3.5, None, True]
    assert isinstance(got["c"], tuple)
    assert float(got["c"][0]) == pytest.approx(2.5)
    assert got["c"][1]["deep"].dtype == torch.float32
    assert store.meta("misc") == {"note": "x"}
    assert store.names() == ["misc"]


def test_hub_index_roundtrip(store):
    idx = hub2.build_hub_index(_small_directed(), k=4, device="cpu")
    store.put("index", idx)
    got = store.get("index", device="cpu")
    assert type(got).__name__ == "HubIndex"
    for f in ("hub_ids", "is_hub", "hub_dist", "core"):
        assert torch.equal(getattr(got, f), getattr(idx, f)), f
    assert got.hub_dist.dtype == torch.int32


def test_bf16_disk_dtype_roundtrip(store):
    x = torch.arange(8).to(torch.bfloat16)
    store.put("bf16", x)
    got = store.get("bf16", device="cpu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x)


def test_get_refuses_the_cpu_unless_asked(store, monkeypatch):
    store.put("misc", {"a": np.arange(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        store.get("misc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_engine_store(store)


# ----------------------------------------------------------------- sharding
def test_sharded_layout_and_logical_reassembly(store):
    g = _small_directed().padded(4)
    store.put("graph", g, shards=4, shard_dim=g.n)
    d = os.path.join(store.root, "graph")
    names = sorted(os.listdir(d))
    assert "common.npz" in names
    assert [n for n in names if n.startswith("shard_")] == [
        f"shard_{i:03d}.npz" for i in range(4)]
    with np.load(os.path.join(d, "shard_000.npz")) as z:
        assert any(k.endswith("in_deg") for k in z.files)
        for k in z.files:
            assert z[k].shape[-1] == g.n // 4
    assert _graphs_equal(store.get("graph", device="cpu"), g)


def test_shard_divisibility_enforced(store):
    g = _small_directed()
    with pytest.raises(StoreError, match="not divisible"):
        store.put("g", g, shards=7, shard_dim=g.n)
    with pytest.raises(StoreError, match="needs shard_dim"):
        store.put("g", g, shards=2)


# ----------------------------------------------------- corruption / atomicity
def test_corrupt_file_refused(store):
    store.put("graph", _small_directed())
    target = os.path.join(store.root, "graph", "common.npz")
    with open(target, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    assert not store.exists("graph")
    with pytest.raises(StoreError, match="hash mismatch|no valid entry"):
        store.get("graph", device="cpu")


def test_incomplete_manifest_refused(store):
    store.put("graph", _small_directed())
    mpath = os.path.join(store.root, "graph", "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["complete"] = False
    with open(mpath, "w") as f:
        json.dump(m, f)
    assert verify_manifest(os.path.join(store.root, "graph")) is None
    assert not store.exists("graph")
    assert store.names() == []


def test_failed_put_preserves_old_entry(store):
    g = _small_directed()
    store.put("graph", g)

    class Unserializable:
        pass

    with pytest.raises(StoreError, match="cannot serialize"):
        store.put("graph", {"bad": Unserializable()})
    assert store.exists("graph")
    assert _graphs_equal(store.get("graph", device="cpu"), g)
    assert store.names() == ["graph"]


def test_class_resolution_restricted():
    with pytest.raises(StoreError, match="outside repro_torch"):
        _resolve_class("os.path:join")
    with pytest.raises(StoreError, match="not a dataclass"):
        _resolve_class("repro_torch.core.store:Store")
    # the JAX package's classes are not the port's: never imported
    for ref in ("repro.core.graph:Graph", "repro.apps.hub2:HubIndex",
                "repro_torchx.core:Graph"):
        with pytest.raises(StoreError, match="outside repro_torch"):
            _resolve_class(ref)
    assert _resolve_class("repro_torch.core.graph:PackedBlocks") is PackedBlocks


def test_bad_entry_names(store):
    for bad in ("../x", ".hidden", "a/b", ""):
        with pytest.raises(StoreError, match="bad entry name"):
            store.put(bad, {"x": 1})


# ------------------------------------------------ entries across packages
def _plain_entry():
    rng = np.random.default_rng(4)
    return {"ids": rng.integers(0, 99, 7).astype(np.int32),
            "w": rng.standard_normal((3, 4)).astype(np.float32),
            "mask": rng.random(5) < 0.5, "small": np.arange(4, dtype=np.int16),
            "nested": [np.uint8(3), {"deep": np.zeros((2, 2), np.int32)}],
            "k": 4, "name": "hub"}


def _same_plain(got, want, as_np):
    for k in ("ids", "w", "mask", "small"):
        a = as_np(got[k])
        assert a.dtype == want[k].dtype and np.array_equal(a, want[k]), k
    assert as_np(got["nested"][0]) == 3
    assert np.array_equal(as_np(got["nested"][1]["deep"]), want["nested"][1]["deep"])
    assert got["k"] == 4 and got["name"] == "hub"


def test_jax_written_entry_reads_in_the_port(tmp_path):
    want = _plain_entry()
    jstore.Store(str(tmp_path)).put("plain", want, shards=2, shard_dim=4,
                                    meta={"graph_hash": "abc"})
    jstore.Store(str(tmp_path)).put("bf16", jnp.asarray(np.arange(6), jnp.bfloat16))
    s = Store(str(tmp_path))
    _same_plain(s.get("plain", device="cpu"), want, lambda t: t.numpy())
    assert s.meta("plain") == {"graph_hash": "abc"}
    got = s.get("bf16", device="cpu")
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), torch.arange(6.0))


def test_port_written_entry_reads_in_jax(tmp_path):
    want = _plain_entry()
    tensors = dict(want, ids=torch.from_numpy(want["ids"]),
                   mask=torch.from_numpy(want["mask"]))
    Store(str(tmp_path)).put("plain", tensors, shards=2, shard_dim=4)
    Store(str(tmp_path)).put("bf16", torch.arange(6).to(torch.bfloat16))
    js = jstore.Store(str(tmp_path))
    _same_plain(js.get("plain"), want, np.asarray)
    got = js.get("bf16")
    assert got.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got, np.float32), np.arange(6, dtype=np.float32))


def test_jax_graph_entry_is_refused_not_imported(tmp_path):
    jstore.Store(str(tmp_path)).put("graph", _jax_graph())
    with pytest.raises(StoreError, match="outside repro_torch"):
        Store(str(tmp_path)).get("graph", device="cpu")


# --------------------------------------------------------- engine boot state
@pytest.mark.parametrize("backend", ["blocks_ref", "cuda"])
def test_save_load_engine_store_with_tables(store, backend, monkeypatch):
    g = _small_directed()
    pair = np.asarray([0, 5], np.int32)
    eng = ppsp.make_bibfs_engine(g, capacity=2, backend=backend, block=16, device="cpu")
    want = eng.query(pair)
    tables = eng.export_tables()
    assert set(tables) == {"default", "rev"}
    written = save_engine_store(store, g, index=hub2.build_hub_index(g, 3, device="cpu"),
                                aux_graphs={"rev": g.reverse()}, tables=tables)
    assert set(written) == {"graph", "index", "aux_graphs", "tables"}
    state = load_engine_store(store, device="cpu")
    assert _graphs_equal(state["graph"], g)
    assert state["index"].k == 3
    assert set(state["aux_graphs"]) == {"rev"}
    for view, tabs in tables.items():
        for sr, tab in tabs.items():
            got = state["tables"][view][sr]
            assert type(got) is type(tab) and got.block == tab.block
            for f in ("src_ids", "nslots", "tiles", "row_ptr", "entries", "w"):
                a, b = getattr(got, f, None), getattr(tab, f, None)
                assert (a is None) == (b is None), f
                assert a is None or (a.dtype == b.dtype and torch.equal(a, b)), f
    if backend == "cuda":
        assert all(t.dtype == torch.int32 for v in state["tables"].values()
                   for t in v.values())

    # an engine booted from the store builds no table and answers the same
    def refuse(*a, **k):
        raise AssertionError("booted engine built a table")

    monkeypatch.setattr(tgraph.Graph, "to_packed_blocks", refuse)
    monkeypatch.setattr(tgraph.Graph, "to_blocks", refuse)
    booted = ppsp.QuegelEngine(
        state["graph"], ppsp.BiBFSProgram(), 2, backend=backend, block=16,
        blocks=state["tables"]["default"],
        aux_graphs={"rev": (state["aux_graphs"]["rev"], state["tables"]["rev"])},
        example_query=np.zeros(2, np.int32), device="cpu")
    got = booted.query(pair)
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


def test_cuda_plan_refuses_one_shared_packed_table():
    g = _small_directed()
    pb = g.to_packed_blocks(16, ppsp.MIN_RIGHT)
    with pytest.raises(TypeError, match="dict"):
        ppsp.make_bfs_engine(g, backend="cuda", block=16, blocks=pb, device="cpu")


def test_graph_hash_mismatch_refused(store):
    g = _small_directed()
    save_engine_store(store, g, index=hub2.build_hub_index(g, 3, device="cpu"))
    other = port_graph(_jax_graph(seed=2, directed=False))
    store.put("graph", other, meta={"graph_hash": other.content_hash()})
    with pytest.raises(StoreError, match="built against graph"):
        load_engine_store(store, device="cpu")


# ------------------------------------------------- Hub² zero-rebuild boot
def test_load_or_build_hub_index_zero_rounds(store):
    g = _small_directed()
    idx1, info1 = hub2.load_or_build_hub_index(store, g, k=4, device="cpu")
    assert info1["built"] and info1["index_rounds"] > 0
    jidx, jinfo = jhub2.load_or_build_hub_index(
        jstore.Store(store.root + "_jax"), _jax_graph(), k=4)
    assert info1 == jinfo  # same rounds, same graph hash
    for f in ("hub_ids", "is_hub", "hub_dist", "core"):
        assert np.array_equal(getattr(idx1, f).numpy(), np.asarray(getattr(jidx, f))), f
    idx2, info2 = hub2.load_or_build_hub_index(Store(store.root), g, k=4, device="cpu")
    assert not info2["built"] and info2["index_rounds"] == 0
    q = np.asarray([0, 17], np.int32)
    want = hub2.make_hub2_engine(g, idx1, device="cpu").query(q)
    got = hub2.make_hub2_engine(g, idx2, device="cpu").query(q)
    assert int(got["dist"]) == int(want["dist"])
    g2 = port_graph(random_graph(60, 3.0, seed=9, directed=True))
    _, info3 = hub2.load_or_build_hub_index(Store(store.root), g2, k=4, device="cpu")
    assert info3["built"] and info3["index_rounds"] > 0
