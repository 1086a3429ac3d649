"""Hub² parity across packages: the index the port builds through its
engine equals the JAX package's, and indexed PPSP answers agree, also when
the port queries an index the JAX package built."""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.apps import hub2 as jhub2
from repro.apps import ppsp as jppsp
from repro.core.graph import barabasi_albert

from repro_torch import carry
from repro_torch.apps import hub2

from _torch_common import assert_same_results, fields_np, port_graph

INDEX_FIELDS = ("hub_ids", "is_hub", "hub_dist", "core")
K = 12


@functools.lru_cache(maxsize=None)
def _graph():
    return barabasi_albert(240, 2, seed=13)


@functools.lru_cache(maxsize=None)
def _jax_index():
    return jhub2.build_hub_index(_graph(), K, capacity=8)


def _pairs():
    return np.random.default_rng(17).integers(0, _graph().n_real, (20, 2)).astype(np.int32)


def _answers(eng, pairs):
    for p in pairs:
        eng.submit(p)
    return eng.run_until_drained()


@functools.lru_cache(maxsize=None)
def _jax_answers():
    return _answers(jhub2.make_hub2_engine(_graph(), _jax_index(), capacity=8), _pairs())


def test_pick_hubs_matches_jax():
    for mode in ("degree", "in", "out"):
        np.testing.assert_array_equal(hub2.pick_hubs(port_graph(_graph()), K, mode),
                                      jhub2.pick_hubs(_graph(), K, mode))


@pytest.mark.parametrize("capacity,k", [(8, 1), (3, 4)])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_index_build_matches_jax(capacity, k, backend):
    """Every HubIndex array bit for bit, whatever the slot count, the
    supersteps per round and the plan (the kernel's plain version here)."""
    idx = hub2.build_hub_index(port_graph(_graph()), K, capacity=capacity,
                               backend=backend, block=16, steps_per_round=k,
                               device="cpu")
    want = fields_np(_jax_index())
    for name in INDEX_FIELDS:
        got = getattr(idx, name).numpy()
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_index_build_pins_explicit_hubs():
    hubs = np.asarray([5, 0, 77], np.int32)
    idx = hub2.build_hub_index(port_graph(_graph()), 3, hubs=hubs, device="cpu")
    want = jhub2.build_hub_index(_graph(), 3, hubs=hubs)
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("backend", ["coo", "cuda"])
def test_hub2_answers_match_jax(source, backend):
    """Indexed answers on the port's own index and on the JAX-built index
    carried over through numpy; the answers are also the BiBFS distances."""
    tg = port_graph(_graph())
    if source == "port":
        idx = hub2.build_hub_index(tg, K, capacity=8, device="cpu")
    else:
        idx = carry.hub_index_from_numpy(fields_np(_jax_index()), device="cpu")
    eng = hub2.make_hub2_engine(tg, idx, capacity=8, backend=backend, block=16,
                                device="cpu")
    res = _answers(eng, _pairs())
    assert_same_results(res, _jax_answers())
    bibfs = _answers(jppsp.make_bibfs_engine(_graph(), capacity=8), _pairs())
    for qid, r in res.items():
        assert int(r["dist"]) == int(bibfs[qid]["dist"]), qid
