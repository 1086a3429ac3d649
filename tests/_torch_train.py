"""Shared parts of the training parity tests (``test_torch_train*.py``).

Both packages start from the same state: the JAX package draws the
parameters and optimizer state, and ``carry.params_from_numpy`` /
``opt_state_from_numpy`` copy them into the port (``jax.random`` keys
cannot be replayed in torch).  The batches are ``synthetic_batch``'s,
byte-equal in both.  JAX calls are jitted and their results cached per
module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as j_arch, reduced as j_reduced
from repro.train import train_step as JS
from repro.train.data import synthetic_batch as j_batch
from repro.train.optimizer import OptConfig as JOptConfig

from repro_torch import carry
from repro_torch.configs import get_arch, reduced
from repro_torch.core.runtime import tree_leaves
from repro_torch.train.data import synthetic_batch
from repro_torch.train.optimizer import OptConfig

TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(warmup_steps=2, total_steps=50)  # tests/test_train.py's OptConfig
B1, B2 = OptConfig().betas


def configs(arch: str, **over):
    """(JAX cfg, port cfg) of ``arch`` at reduced size, ``over`` replaced."""
    return (dataclasses.replace(j_reduced(j_arch(arch)), **over),
            dataclasses.replace(reduced(get_arch(arch)), **over))


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_state(arch: str, compression: bool = False, **over):
    """The JAX package's initial (params, opt_state) as numpy trees."""
    jcfg, _ = configs(arch, **over)
    p, o = JS.init_train_state(jcfg, JOptConfig(**OPT), jax.random.PRNGKey(0),
                               use_compression=compression)
    return to_numpy_tree(p), to_numpy_tree(o)


def port_state(arch: str, compression: bool = False, **over):
    """The same state as fresh tensors on the CPU."""
    p, o = jax_state(arch, compression, **over)
    return (carry.params_from_numpy(p, device="cpu"),
            carry.opt_state_from_numpy(o, device="cpu"))


def batch_of(arch: str, b: int = 4, s: int = 16, seed: int = 7, step: int = 0, **over):
    _, cfg = configs(arch, **over)
    got = synthetic_batch(cfg, b, s, seed, step)
    want = j_batch(configs(arch, **over)[0], b, s, seed, step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    return got


@functools.lru_cache(maxsize=None)
def jax_step(arch: str, n_micro: int, compression: bool, b: int = 4, s: int = 16, **over):
    """One JAX ``train_step`` from ``jax_state``: (new params, new opt
    state, metrics), as numpy."""
    jcfg, _ = configs(arch, **over)
    p, o = jax_state(arch, compression, **over)
    batch = {k: jnp.asarray(v) for k, v in batch_of(arch, b, s, **over).items()}
    step = JS.make_train_step(jcfg, JOptConfig(**OPT), n_micro=n_micro,
                              use_compression=compression, donate=False)
    return to_numpy_tree(step(p, o, batch))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |x| (8 significant bits)."""
    x = np.abs(x).astype(np.float32)
    return np.where(x > 0, np.spacing(x) * 2.0 ** 16, np.float32(2.0 ** -133))


def assert_rel(got, want, rtol: float, what: str):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), f"{what}: {got} against {want}"


def assert_step_matches(got, want, rtol: float = 1e-4, metric_rtol: float = 1e-4,
                        grad_err: float = 0.0) -> int:
    """The port's step ``got`` (params, opt, metrics) against JAX's ``want``
    (params, opt, metrics); returns the count of elements that one int8
    level separates (0 without compression).

    g below is the gradient JAX's AdamW received (after the microbatch
    mean and compression), read back from its first moment: at step 1
    from zero moments, mu = (1 - b1) * clip * g.  At step 1 Adam's
    update is ~ lr * g / |g| per element, so where g is near zero another
    summation order can flip its sign and move the element by up to
    2 * lr.  The new parameters are held within ``rtol`` of their value
    or of lr (a new parameter near 0 is the difference of p and
    lr * delta) where JAX's |g| > 1e-5 and both packages' first moments
    are nonzero with one sign (and, under compression, on one int8
    level), or where both first moments are exactly 0 (no gradient in
    either: the update is the weight decay alone), and within 2 * lr
    elsewhere.  The bf16 moments are held within
    one bf16 ulp plus what a gradient difference of 1e-4 * |g| + 1e-6
    moves them (the gradients' absolute error follows the size of the
    sums, not of the result).  ``grad_err`` widens that difference by a
    share of each tensor's largest |g| (bfloat16 parameters, whose
    gradients carry bf16 rounding), and raises the 1e-5 floor of the
    parameter rule to it; a bfloat16 parameter may also differ by its
    own ulp.  Under compression an element whose corrected gradient sits
    at a rounding tie between two int8 levels can land on either: its
    moments and residual may then differ by one level of its tensor's
    scale, and its parameter is held to the sign rule's bound; such
    elements must stay under 0.1 % of all.  The loss and gradient norm
    agree within ``metric_rtol``."""
    params, opt, metrics = got
    jp, jo, jm = want
    assert_rel(metrics["loss"], jm["loss"], metric_rtol, "loss")
    assert_rel(metrics["grad_norm"], jm["grad_norm"], metric_rtol, "grad_norm")
    assert_rel(metrics["lr"], jm["lr"], 1e-6, "lr")
    assert int(opt["step"]) == int(jo["step"]) == 1
    assert sorted(opt) == sorted(jo)
    lr = float(jm["lr"])
    clip = min(1.0, OptConfig().grad_clip / (float(jm["grad_norm"]) + 1e-9))
    compressed = "err" in jo
    errs = (zip(tree_leaves(opt["err"]), jax.tree.leaves(jo["err"])) if compressed
            else iter(lambda: (None, None), 0))
    leaves = zip(tree_leaves(params), jax.tree.leaves(jp),
                 tree_leaves(opt["mu"]), jax.tree.leaves(jo["mu"]),
                 tree_leaves(opt["nu"]), jax.tree.leaves(jo["nu"]), errs)
    n_level = n_all = 0
    for p, wp, m, wm, v, wv, (e, we) in leaves:
        assert str(p.dtype) == f"torch.{np.asarray(wp).dtype}" and p.shape == wp.shape
        g = f32(wm) / ((1 - B1) * clip)
        dg = 1e-4 * np.abs(g) + 1e-6 + grad_err * np.abs(g).max()
        n_all += g.size

        def lims(d):
            return (bf16_ulp(f32(wm)) + (1 - B1) * clip * d,
                    bf16_ulp(f32(wv)) + (1 - B2) * clip ** 2 * d * (2 * np.abs(g) + d))

        dm, dv = np.abs(f32(m) - f32(wm)), np.abs(f32(v) - f32(wv))
        m_lim, v_lim = lims(dg)
        off = np.zeros(g.shape, bool)
        if compressed:
            level = np.abs(g).max() / 127 * (1 + 2.0 ** -7)  # the int8 step, from bf16 mu
            off = (dm > m_lim) | (dv > v_lim)
            n_level += int(off.sum())
            m_lim, v_lim = lims(dg + np.where(off, level, 0))
            de = np.abs(f32(e) - f32(we))
            e_lim = dg + 1e-4 * 127 * level + np.where(off, level, 0)
            assert (de <= e_lim).all(), f"err: {(de - e_lim).max()} over"
        assert (dm <= m_lim).all(), f"mu: {(dm - m_lim).max()} over"
        assert (dv <= v_lim).all(), f"nu: {(dv - v_lim).max()} over"
        # both first moments exactly 0: no gradient in either package, so
        # the update is the same deterministic decay, held to rtol too
        steady = ((np.abs(g) > np.maximum(1e-5, dg)) & (np.sign(f32(m)) == np.sign(f32(wm)))
                  & ~off) | ((f32(m) == 0) & (f32(wm) == 0))
        dp = np.abs(f32(p) - f32(wp))
        bound = np.where(steady, rtol * (np.abs(f32(wp)) + lr), 2 * lr)
        if p.dtype == torch.bfloat16:
            bound = bound + bf16_ulp(f32(wp))
        assert (dp <= bound).all(), f"params: {dp.max()} over {bound[dp > bound].min()}"
    assert n_level <= 1e-3 * n_all, (n_level, n_all)
    return n_level
