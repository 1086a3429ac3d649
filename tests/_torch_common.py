"""Shared helpers of the cross-package tests (``test_torch_*.py``): move
objects the JAX package built into the PyTorch port through numpy, and
make seeded inputs both packages consume."""
import dataclasses

import numpy as np

from repro.core.semiring import INF

from repro_torch import carry


def fields_np(obj) -> dict:
    """A JAX dataclass as {field name: numpy array or int}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, (int, str)) else np.asarray(v)
    return out


def port_graph(jg):
    return carry.graph_from_numpy(fields_np(jg), device="cpu")


def port_blocks(jbs):
    return carry.blocks_from_numpy(fields_np(jbs), device="cpu")


def rand_x(rng, sr_name, n, q):
    """Seeded lanes for one semiring: INF/-INF-sprinkled ints, or floats."""
    if sr_name in ("min_plus", "min_right"):
        x = rng.integers(0, 20, (q, n)).astype(np.int32)
        x[rng.random((q, n)) < 0.5] = INF
    elif sr_name in ("max_plus", "max_right"):
        x = rng.integers(0, 20, (q, n)).astype(np.int32)
        x[rng.random((q, n)) < 0.5] = -(2**30)
    else:
        x = rng.standard_normal((q, n)).astype(np.float32)
    return x


def assert_same(got, want, floating):
    """Integers bit for bit; floats to the rtol/atol of tests/test_kernels.py."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if floating:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


def assert_same_results(got: dict, want: dict):
    """qid -> result pytree maps, leaf by leaf, exactly."""
    assert sorted(got) == sorted(want)
    for qid in want:
        g, w = got[qid], want[qid]
        assert sorted(g) == sorted(w), qid
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=f"qid {qid} field {k}")
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, (qid, k)
