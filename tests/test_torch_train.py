"""The port's training substrate against the JAX package: twins of every
``tests/test_train.py`` test (checkpoint/restart equivalence, fault
injection, compression, data determinism, stragglers, elastic restore),
and parity of the schedule, AdamW, the compression and the microbatched
train step on the same numpy-built state and batches, checkpoints that
restore across the packages, and the training CLI.

Tolerances: the schedule and AdamW's float32 arithmetic fed the same
inputs within 1e-6 relative (XLA may fuse a multiply and an add that
torch rounds apart; a new parameter near 0 is the difference of p and
lr * delta, so there within 1e-6 * lr), the global norm within 1e-5 (a
float32 sum of 1e5 squares in another order), the bf16 moments equal or
one bf16 ulp apart (a float32 difference of an ulp can round either
way); int8 levels
equal except at exact half-way ties; the train step under
``_torch_train.assert_step_matches``' rule (1e-4 in float32; in bfloat16
the loss and gradient norm within 3e-3, under one bf16 epsilon of
2**-8, and the gradients within 5 % of each tensor's largest, where
XLA and torch round the bf16 products of the backward at other points:
measured 0.03 % and 3 %).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (B1, B2, OPT, assert_step_matches, batch_of, bf16_ulp, configs,
                          f32, jax_state, jax_step, port_state, to_numpy_tree)
from repro.train import checkpoint as jckpt
from repro.train import compress as JC
from repro.train import optimizer as JO

from repro_torch import carry
from repro_torch.configs import get_arch, reduced
from repro_torch.core.runtime import tree_leaves, tree_map
from repro_torch.core.store import verify_manifest
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compress import (compress_grads, compressed_bytes, dequantize_int8,
                                        init_error_state, quantize_int8)
from repro_torch.train.data import Prefetcher, synthetic_batch, synthetic_stream
from repro_torch.train.fault import (FailureInjector, SimulatedFailure, StragglerMonitor,
                                     run_with_restarts)
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update, cosine_lr,
                                         global_norm)
from repro_torch.train.train_step import init_train_state, make_train_step

CFG = reduced(get_arch("tinyllama-1.1b"))
OPT_CFG = OptConfig(**OPT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init():
    return init_train_state(CFG, OPT_CFG, torch.Generator().manual_seed(0), device="cpu")


def _train(steps, ckpt_dir=None, injector=None, start=0, seed=7, every=2):
    """Deterministic mini training loop with optional checkpointing and
    failure injection.  Returns final params."""
    params, opt = _init()
    step_fn = make_train_step(CFG, OPT_CFG, donate=False)
    inj = injector or FailureInjector(set())
    if ckpt_dir and start:
        state, got = ckpt.restore(ckpt_dir, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        assert got == start
    elif ckpt_dir and start == 0:
        restored, got = ckpt.restore(ckpt_dir, {"params": params, "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = got
    for s in range(start, steps):
        batch = synthetic_batch(CFG, 4, 16, seed, s)
        inj.check(s)
        params, opt, _ = step_fn(params, opt, batch)
        if ckpt_dir and (s + 1) % every == 0:
            ckpt.save(ckpt_dir, s + 1, {"params": params, "opt": opt})
    return params


# --------------------------------------------------- twins of test_train.py
def test_checkpoint_roundtrip(tmp_path):
    params, opt = _init()
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, {"params": params, "opt": opt})
    assert ckpt.latest_step(d) == 3
    state, step = ckpt.restore(d, {"params": params, "opt": opt})
    assert step == 3
    for a, b in zip(tree_leaves(state), tree_leaves({"params": params, "opt": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_detected(tmp_path):
    params, _ = _init()
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": params})
    ckpt.save(d, 2, {"params": params})
    # corrupt the newest
    path = os.path.join(d, "step_00000002", "params.npz")
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 50)
    assert ckpt.latest_step(d) == 1  # falls back to the verified one
    assert ckpt.restore(d, {"params": params}, step=2) == (None, None)


def test_restart_bit_identical(tmp_path):
    """Crash + restore-from-checkpoint reproduces the uninterrupted run
    bit for bit (deterministic data stream, the CPU's deterministic ops)."""
    d = str(tmp_path / "ck")
    clean = _train(8)
    inj = FailureInjector({5})  # fires once, shared across restarts

    def run(start):
        _train(8, ckpt_dir=d, injector=inj, start=start)
        return 8

    final, restarts = run_with_restarts(run, lambda: ckpt.latest_step(d))
    assert (final, restarts) == (8, 1)
    got = _train(8, ckpt_dir=d, start=8)
    for a, b in zip(tree_leaves(got), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_data_stream_deterministic():
    a = list(zip(range(3), synthetic_stream(CFG, 2, 8, seed=5)))
    b = list(zip(range(3), synthetic_stream(CFG, 2, 8, seed=5)))
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    c = synthetic_batch(CFG, 2, 8, seed=5, step=1)
    np.testing.assert_array_equal(a[1][1]["tokens"], c["tokens"])


def test_prefetcher_order():
    it = iter([{"i": i} for i in range(5)])
    got = [b["i"] for b in Prefetcher(it, depth=2)]
    assert got == list(range(5))


def test_compression_error_feedback():
    """Error feedback: the *accumulated* applied gradient converges to the
    true accumulated gradient (residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.as_tensor(rng.standard_normal((32, 32)).astype(np.float32))}
    err = init_error_state(g_true)
    applied = torch.zeros((32, 32))
    for _ in range(10):
        g_c, err = compress_grads(g_true, err)
        applied = applied + g_c["w"]
    total_true = 10 * g_true["w"].numpy()
    # with error feedback the residual never exceeds one quantization step
    resid = np.abs(applied.numpy() + err["w"].numpy() - total_true)
    assert resid.max() < 1e-4
    raw, comp = compressed_bytes(g_true)
    assert comp < raw / 3.5


def test_straggler_monitor():
    m = StragglerMonitor(threshold=2.0, warmup=3)
    for s in range(10):
        assert not m.record(s, 1.0)
    assert m.record(10, 5.0)
    assert m.flags == [10]
    # EMA not poisoned by the outlier
    assert abs(m.ema - 1.0) < 1e-6


def test_max_restarts_exceeded():
    def always_fail(start):
        raise SimulatedFailure("boom")

    with pytest.raises(SimulatedFailure):
        run_with_restarts(always_fail, lambda: None, max_restarts=2)


def test_cosine_schedule():
    o = OptConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(cosine_lr(o, 0)) == 0.0
    assert abs(float(cosine_lr(o, 10)) - 1.0) < 1e-6
    assert float(cosine_lr(o, 110)) < 1e-6
    assert 0.4 < float(cosine_lr(o, 60)) < 0.6


def test_elastic_restore_different_topology(tmp_path):
    """Checkpoints are logical: each leaf comes back on its prototype's
    device and dtype, whatever wrote it (here float32 prototypes take a
    bfloat16 checkpoint written as float32 on disk)."""
    params, _ = init_train_state(configs("tinyllama-1.1b", dtype="bfloat16")[1], OPT_CFG,
                                 torch.Generator().manual_seed(0), device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": params})
    proto = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32), params)
    state, _ = ckpt.restore(d, {"params": proto})
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(params)):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        assert a.device.type == "cpu" and torch.equal(a, b.float())


# ------------------------------------------------------- parity with JAX
@pytest.mark.parametrize("cfg", [dict(), dict(lr=1.0, warmup_steps=10, total_steps=110),
                                 dict(warmup_steps=0, total_steps=1)])
def test_cosine_lr_matches_jax(cfg):
    """Within 1e-6 relative, or 1e-7 * lr where the cosine nears -1: there
    one float32 ulp of cos (6e-8) is all of 1 + cos's difference."""
    steps = np.arange(0, 130, dtype=np.int32)
    o = OptConfig(**cfg)
    got = cosine_lr(o, torch.as_tensor(steps)).numpy()
    want = np.asarray(jax.jit(lambda s: JO.cosine_lr(JO.OptConfig(**cfg), s))(steps))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * o.lr)


def _grads_like(params, seed: int, scale: float):
    """Numpy gradients of ``params``' shapes and dtypes (bf16 where the
    parameter is), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(p.dtype),
                        params)


# stacked (2 super-blocks) and unrolled tinyllama, float32 and bfloat16;
# a gradient scale of 1e-3 leaves the clip off, 1.0 turns it on
ADAMW = {"stacked-clip": ("tinyllama-1.1b", {}, 1.0),
         "stacked-noclip": ("tinyllama-1.1b", {}, 1e-3),
         "unrolled-clip": ("recurrentgemma-2b", {}, 1.0),
         "bf16-params": ("tinyllama-1.1b", dict(dtype="bfloat16"), 1.0)}


@pytest.mark.parametrize("case", sorted(ADAMW))
def test_adamw_update_matches_jax(case):
    """Three steps from a nonzero state, fed the same numpy gradients: the
    float32 parameters within 1e-6 relative (a bf16 parameter within one
    bf16 ulp), the step equal, the gradient norm within 1e-5 and the
    rate within 1e-6.  The bf16 moments are equal or one bf16 ulp apart,
    or, where b * m + (1 - b) * g nearly cancels, within 1e-5 of its
    terms: the clip scale carries the norm's 1e-5."""
    arch, over, scale = ADAMW[case]
    jp, jo = jax_state(arch, **over)
    p, o = port_state(arch, **over)
    jopt = JO.OptConfig(**OPT)
    update = jax.jit(lambda g, o_, p_: JO.adamw_update(g, o_, p_, jopt))
    for i in range(3):
        g = _grads_like(jp, i, scale)
        prev_o = jo
        jp, jo, jm = to_numpy_tree(update(g, jo, jp))
        with torch.no_grad():
            p, o, m = adamw_update(carry.params_from_numpy(g, device="cpu"), o, p, OPT_CFG)
        assert int(o["step"]) == int(jo["step"]) == i + 1 and o["step"].dtype == torch.int32
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        lr = float(jm["lr"])
        np.testing.assert_allclose(float(m["lr"]), lr, rtol=1e-6)
        for a, w in zip(tree_leaves(p), jax.tree.leaves(jp)):
            assert str(a.dtype) == f"torch.{np.asarray(w).dtype}"
            if a.dtype == torch.bfloat16:
                assert (np.abs(f32(a) - f32(w)) <= bf16_ulp(f32(w))).all()
            else:
                np.testing.assert_allclose(f32(a), w, rtol=1e-6, atol=1e-6 * lr)
        clip = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-9))
        for key, beta, power in (("mu", B1, 1), ("nu", B2, 2)):
            for a, w, prev, gi in zip(tree_leaves(o[key]), jax.tree.leaves(jo[key]),
                                      jax.tree.leaves(prev_o[key]), jax.tree.leaves(g)):
                assert a.dtype == torch.bfloat16
                terms = beta * np.abs(f32(prev)) + (1 - beta) * np.abs(clip * f32(gi)) ** power
                lim = bf16_ulp(f32(w)) + 1e-5 * terms
                assert (np.abs(f32(a) - f32(w)) <= lim).all(), key
        # the same state after each step: the next update starts equal
        p = carry.params_from_numpy(jp, device="cpu")
        o = carry.opt_state_from_numpy(jo, device="cpu")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b"])
def test_weight_decay_follows_leaf_rank_as_jax(arch):
    """JAX decays every leaf with ndim >= 2: a stacked norm scale
    ``(n_super, d)`` is decayed, an unrolled one ``(d,)`` is not; the port
    keeps that.  With zero gradients only the decay moves a leaf."""
    p, o = port_state(arch)
    p = tree_map(lambda t: t + 0.5 if t.ndim <= 2 and t.shape[-1] == 64 else t, p)
    zero = tree_map(torch.zeros_like, p)
    with torch.no_grad():
        new, _, _ = adamw_update(zero, o, p, OPT_CFG)
    update = jax.jit(lambda g, o_, p_: JO.adamw_update(g, o_, p_, JO.OptConfig(**OPT)))
    jnew, _, _ = update(to_numpy_tree(zero), jax_state(arch)[1], to_numpy_tree(p))
    norm = new["blocks"][0]["ln1_rep"] if new["blocks"] else new["rem_blocks"][0]["ln1_rep"]
    old = p["blocks"][0]["ln1_rep"] if p["blocks"] else p["rem_blocks"][0]["ln1_rep"]
    assert bool((norm != old).all()) == (norm.ndim == 2)  # stacked: decayed
    assert torch.equal(new["final_norm_rep"], p["final_norm_rep"])  # (d,): never
    for a, w in zip(tree_leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(f32(a), np.asarray(w), rtol=1e-6)


def test_global_norm_and_adamw_init_match_jax():
    jp, jo = jax_state("tinyllama-1.1b", dtype="bfloat16")
    p, _ = port_state("tinyllama-1.1b", dtype="bfloat16")
    np.testing.assert_allclose(float(global_norm(p)), float(jax.jit(JO.global_norm)(jp)),
                               rtol=1e-5)
    o = adamw_init(p, OPT_CFG)
    assert int(o["step"]) == 0 and o["step"].dtype == torch.int32
    for key in ("mu", "nu"):
        for a, w in zip(tree_leaves(o[key]), jax.tree.leaves(jo[key])):
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == w.shape and not a.any()


def test_compress_grads_matches_jax():
    """Two rounds of error feedback on the same numpy gradients and
    residuals: int8 levels equal except at exact half-way ties (none on
    these draws), so the decompressed gradients agree within the scale's
    last two bits (XLA may divide by 127 as a product by its
    reciprocal), the residuals within 1e-6."""
    jp, _ = jax_state("tinyllama-1.1b")
    jerr = JC.init_error_state(jp)
    step = jax.jit(JC.compress_grads)
    for i in range(2):
        g = _grads_like(jp, 10 + i, 1e-2)
        err = carry.params_from_numpy(to_numpy_tree(jerr), device="cpu")
        jg, jerr = to_numpy_tree(step(g, jerr))
        got, err = compress_grads(carry.params_from_numpy(g, device="cpu"), err)
        for a, w, e, we in zip(tree_leaves(got), jax.tree.leaves(jg), tree_leaves(err),
                               jax.tree.leaves(jerr)):
            np.testing.assert_allclose(f32(a), w, rtol=2.4e-7, atol=0)
            np.testing.assert_allclose(f32(e), we, rtol=0, atol=1e-6)
    x = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    x[0, 0] = 127.0  # the scale is 1 (+1e-12): the draws times 1 are far from ties
    x[1, :4] = [0.5, 1.5, -2.5, 126.5]  # exact half-way: both round to even
    q, s = quantize_int8(torch.as_tensor(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and q[1, :4].tolist() == [0, 2, -2, 126]
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    assert compressed_bytes(carry.params_from_numpy(jp, device="cpu")) == \
        JC.compressed_bytes(jp)


@pytest.mark.parametrize("n_micro,compression", [(1, False), (2, False), (1, True), (2, True)],
                         ids=["1-plain", "2-plain", "1-int8", "2-int8"])
def test_train_step_matches_jax(n_micro, compression):
    """tinyllama (stacked), 4 x 16 tokens, one or two microbatches, with
    and without int8 compression and its error-feedback state."""
    params, opt = port_state("tinyllama-1.1b", compression)
    step = make_train_step(CFG, OPT_CFG, n_micro=n_micro, use_compression=compression,
                           donate=False)
    got = step(params, opt, batch_of("tinyllama-1.1b"))
    assert sorted(got[1]) == sorted(["step", "mu", "nu"] + ["err"] * compression)
    assert_step_matches(got, jax_step("tinyllama-1.1b", n_micro, compression))


def test_train_step_bf16_matches_jax():
    """tinyllama in its own bfloat16, two microbatches: the parameters stay
    bf16, and the float32 accumulation of the microbatch gradients keeps
    the step within the bf16 tolerance of the module docstring."""
    _, cfg = configs("tinyllama-1.1b", dtype="bfloat16")
    params, opt = port_state("tinyllama-1.1b", dtype="bfloat16")
    got = make_train_step(cfg, OPT_CFG, n_micro=2, donate=False)(
        params, opt, batch_of("tinyllama-1.1b", dtype="bfloat16"))
    assert got[0]["embed_embed"].dtype == torch.bfloat16
    assert_step_matches(got, jax_step("tinyllama-1.1b", 2, False, dtype="bfloat16"),
                        metric_rtol=3e-3, grad_err=0.05)


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
def test_donate_writes_the_same_state_in_place(compression):
    """``donate=True`` returns the given tensors, holding what
    ``donate=False`` returns as new tensors; ``donate=False`` leaves its
    inputs unchanged."""
    batch = batch_of("tinyllama-1.1b")
    p1, o1 = port_state("tinyllama-1.1b", compression)
    before = [t.clone() for t in tree_leaves((p1, o1))]
    fresh = make_train_step(CFG, OPT_CFG, n_micro=2, use_compression=compression,
                            donate=False)(p1, o1, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p1, o1))))
    p2, o2 = port_state("tinyllama-1.1b", compression)
    ids = [id(t) for t in tree_leaves((p2, {k: v for k, v in o2.items() if k != "step"}))]
    donated = make_train_step(CFG, OPT_CFG, n_micro=2, use_compression=compression)(
        p2, o2, batch)
    out = tree_leaves((donated[0], {k: v for k, v in donated[1].items() if k != "step"}))
    assert [id(t) for t in out] == ids
    for a, b in zip(tree_leaves(donated[:2]), tree_leaves(fresh[:2])):
        assert torch.equal(a, b)


def test_synthetic_batches_match_jax_for_every_family():
    """tokens and targets, whisper's frames and llava's patches, byte-equal."""
    for arch in ("tinyllama-1.1b", "whisper-base", "llava-next-34b"):
        assert len(batch_of(arch, 2, 8, seed=11, step=3)) == 2 + (arch != "tinyllama-1.1b")


def _same_tree(a, b):
    for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(f32(x), f32(y))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """bf16 params and moments (float32 on disk) and the int32 step come
    back with the prototypes' dtypes and JAX's values."""
    jp, jo = jax_state("tinyllama-1.1b", True, dtype="bfloat16")
    d = str(tmp_path / "ck")
    jckpt.save(d, 4, {"params": jp, "opt": jo})
    assert verify_manifest(os.path.join(d, "step_00000004")) is not None
    p, o = port_state("tinyllama-1.1b", True, dtype="bfloat16")
    proto = tree_map(torch.empty_like, {"params": p, "opt": o})
    state, step = ckpt.restore(d, proto)
    assert step == 4 and ckpt.latest_step(d) == 4
    for a, b in zip(tree_leaves(state), tree_leaves(proto)):
        assert a.dtype == b.dtype and a.shape == b.shape
    _same_tree(state, {"params": jp, "opt": jo})


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A trained step of the port, saved; JAX's restore into its own
    prototypes gives the same values, and its manifest check passes."""
    _, cfg = configs("tinyllama-1.1b", dtype="bfloat16")
    p, o = port_state("tinyllama-1.1b", dtype="bfloat16")
    p, o, _ = make_train_step(cfg, OPT_CFG)(p, o, batch_of("tinyllama-1.1b",
                                                          dtype="bfloat16"))
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": p, "opt": o})
    assert jckpt.latest_step(d) == 1
    jp, jo = jax_state("tinyllama-1.1b", dtype="bfloat16")
    state, step = jckpt.restore(d, {"params": jp, "opt": jo})
    assert step == 1
    assert jax.tree.structure(state) == jax.tree.structure({"params": jp, "opt": jo})
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves({"params": jp, "opt": jo})):
        assert a.dtype == np.asarray(b).dtype
    _same_tree({"params": p, "opt": o}, state)


def test_train_cli_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "2"])


def test_train_cli_restarts_on_the_cpu(tmp_path, capsys):
    """The JAX driver's flags on the CPU: a failure at step 3 restarts from
    the step-2 checkpoint and the run finishes."""
    rc = launch_train.main(["--device", "cpu", "--steps", "5", "--batch", "2", "--seq", "16",
                            "--n-micro", "2", "--compress", "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "2", "--fail-at", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and "[train] restored checkpoint @ step 2" in out
    assert out[-1] == "[train] finished at step 5 with 1 restart(s)"
