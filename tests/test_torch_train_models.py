"""The port's backward and train step against the JAX package, per
architecture (reduced configs, float32).

``loss_fn``'s value and every gradient leaf equal ``jax.value_and_grad(
loss_fn)`` within rtol = atol = 1e-4, the tolerance of
``test_torch_models.py`` (measured: under 0.4 % of it), with remat on and
off in both packages; one microbatched ``train_step`` (the twin of
``tests/test_models.py::test_train_step``) agrees with JAX's under
``_torch_train.assert_step_matches``' rule.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (OPT, TOL, assert_step_matches, batch_of, configs, f32, jax_state,
                          jax_step, port_state)
from repro.configs import list_archs
from repro.models import transformer as JT

from repro_torch.core.runtime import tree_leaves, tree_map
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_step

ARCHS = list_archs()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch: str):
    """JAX's (loss, grads) with remat on and off, one jitted call."""
    jcfg, _ = configs(arch)
    p, _ = jax_state(arch)
    batch = {k: jnp.asarray(v) for k, v in batch_of(arch, 2, 24, seed=3).items()}

    def both(p_, b_):
        return {remat: jax.value_and_grad(lambda q: JT.loss_fn(q, jcfg, b_, remat=remat))(p_)
                for remat in (True, False)}

    return jax.tree.map(np.asarray, jax.jit(both)(p, batch))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """24 tokens cross the reduced configs' 16-position attention chunks
    and mamba2's 8-token SSD chunks; llava adds its 16 patches and
    whisper encodes its 32 frames, so the encoder and the MoE dispatch
    run backward too."""
    _, cfg = configs(arch)
    params, _ = port_state(arch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    batch = {k: torch.as_tensor(v) for k, v in batch_of(arch, 2, 24, seed=3).items()}
    loss = TT.loss_fn(live, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    want_loss, want_grads = _jax_loss_and_grads(arch)[remat]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want = jax.tree.leaves(want_grads)
    assert len(grads) == len(want) == len(tree_leaves(params))
    for g, w, p in zip(grads, want, tree_leaves(params)):
        assert g.dtype == p.dtype and g.shape == w.shape
        np.testing.assert_allclose(f32(g), w, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Two microbatches of 2 x 16 tokens: finite metrics, step 1, moved
    parameters (as the JAX smoke test asks), and JAX's new state."""
    _, cfg = configs(arch)
    params, opt = port_state(arch)
    before = [p.clone() for p in tree_leaves(params)]
    step = make_train_step(cfg, OptConfig(**OPT), n_micro=2, donate=False)
    got = step(params, opt, batch_of(arch))
    metrics = got[2]
    assert all(m.ndim == 0 and torch.isfinite(m) for m in metrics.values())
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert any(not torch.allclose(a, b) for a, b in zip(before, tree_leaves(got[0])))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert assert_step_matches(got, jax_step(arch, 2, False)) == 0
