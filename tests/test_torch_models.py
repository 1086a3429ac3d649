"""The port's LM configs and dense model code against the JAX package.

The same numpy-seeded inputs go through the JAX function and its port;
the JAX parameters are carried over with ``carry.params_from_numpy``
(``jax.random`` keys cannot be replayed in torch).  float32 logits and
cache leaves must agree within rtol = atol = 1e-4, the tolerance of
``tests/test_kernels.py`` (measured differences are ~5e-6: XLA and torch
sum in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (SHAPES as J_SHAPES, cell_is_supported as j_cell,
                           get_arch as j_arch, input_specs as j_specs,
                           list_archs as j_list, reduced as j_reduced)
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mlp as JM
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT

from repro_torch import carry
from repro_torch.configs import (SHAPES, cell_is_supported, get_arch, input_specs,
                                 list_archs, reduced)
from repro_torch.core.runtime import tree_leaves
from repro_torch.launch.serve import SlotServer
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TM
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

ARCHS = j_list()
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny models: the test workers
    share the box, and torch's idle threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **TOL)


def t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ configs
def test_list_archs_matches_jax():
    assert list_archs() == j_list()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    """Every field, the reduced config, the derived sizes, the cells and
    the input stand-ins."""
    for mine, ref in ((get_arch(arch), j_arch(arch)),
                      (reduced(get_arch(arch)), j_reduced(j_arch(arch)))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for name in ("hd", "vocab_padded", "is_attention_free", "sub_quadratic"):
            assert getattr(mine, name) == getattr(ref, name), name
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        for key in SHAPES:
            assert cell_is_supported(mine, SHAPES[key]) == j_cell(ref, J_SHAPES[key])
            got, want = input_specs(mine, SHAPES[key]), j_specs(ref, J_SHAPES[key])
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == want[k].shape, k
                assert str(got[k].dtype) == f"torch.{want[k].dtype}", k


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


def test_all_archs_registered():
    assert len(list_archs()) == 10
    want = {
        "arctic-480b", "deepseek-v2-236b", "whisper-base", "mamba2-780m",
        "tinyllama-1.1b", "starcoder2-15b", "glm4-9b", "gemma2-9b",
        "llava-next-34b", "recurrentgemma-2b",
    }
    assert set(list_archs()) == want


def test_param_counts_in_range():
    """Full configs land near their advertised sizes."""
    expect = {
        "arctic-480b": (350e9, 550e9),
        "deepseek-v2-236b": (180e9, 280e9),
        "tinyllama-1.1b": (0.8e9, 1.4e9),
        # the stack is uniformly SwiGLU (3 FFN mats); upstream StarCoder2
        # uses a 2-matrix GELU FFN, so the same dims land ~1.4x heavier
        "starcoder2-15b": (14e9, 24e9),
        "glm4-9b": (7e9, 12e9),
        "gemma2-9b": (7e9, 12e9),
        "llava-next-34b": (28e9, 40e9),
        "recurrentgemma-2b": (1.6e9, 3.5e9),
        "mamba2-780m": (0.55e9, 1.0e9),
        "whisper-base": (0.05e9, 0.12e9),
    }
    for arch, (lo, hi) in expect.items():
        n = get_arch(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B params out of [{lo/1e9}, {hi/1e9}]"


# ------------------------------------------------------------------- layers
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    close(TC.rms_norm(t(x), t(scale), 1e-6), JC.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap_matches_jax(cap):
    x = np.random.default_rng(1).standard_normal((3, 7)).astype(np.float32) * 80
    close(TC.softcap(t(x), cap), JC.softcap(jnp.asarray(x), cap))


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_jax(batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 6)) if batched else np.arange(6) + 4090).astype(np.int32)
    for theta in (10000.0, 500000.0):
        close(TC.apply_rope(t(x), t(pos), theta),
              JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_sinusoidal_embed_matches_jax():
    """XLA's float32 ``exp`` differs from torch's in the last bit on a few
    frequencies, which moves an angle by one of its own ulps.  Below
    position 1,024 that ulp (6.1e-5) is under the tolerance; at whisper's
    last frame (1,499) it is 1.2e-4, so there the bound is two such ulps."""
    pos = np.asarray([[0, 1, 7], [100, 1023, 3]], np.int32)
    last = np.asarray([1499, 1200], np.int32)
    for d in (64, 512):
        close(TC.sinusoidal_embed(t(pos), d), JC.sinusoidal_embed(jnp.asarray(pos), d))
        np.testing.assert_allclose(
            TC.sinusoidal_embed(t(last), d).numpy(),
            np.asarray(JC.sinusoidal_embed(jnp.asarray(last), d)),
            rtol=0, atol=2 * float(np.spacing(np.float32(1499))))


def test_dense_init_is_seeded_and_scaled():
    a = TC.dense_init(torch.Generator().manual_seed(3), (256, 512), dtype=torch.float32)
    b = TC.dense_init(torch.Generator().manual_seed(3), (256, 512), dtype=torch.float32)
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 1 / 16) < 2e-3  # 1/sqrt(fan_in = 256)
    e = TC.dense_init(torch.Generator().manual_seed(3), (64, 100), in_axis=-1)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.1) < 5e-3


# ---------------------------------------------------------------- attention
def _qkv(rng, B, S, H, KV, D=16):
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


# name -> (S, q_chunk, kv_chunk, local_window, softcap, heads, kv heads, causal)
CAUSAL = {
    "single": (12, 16, 16, 0, 0.0, 4, 2, True),
    "single-local": (12, 16, 16, 5, 0.0, 4, 4, True),
    "chunked": (64, 16, 16, 0, 0.0, 4, 2, True),
    "chunked-kv32": (64, 16, 32, 0, 0.0, 4, 2, True),
    "ragged": (40, 16, 16, 0, 0.0, 4, 2, True),
    "ragged-lcm": (44, 8, 12, 0, 0.0, 4, 1, True),
    "local": (64, 16, 16, 20, 0.0, 4, 2, True),
    "local-ragged": (52, 16, 8, 9, 0.0, 4, 2, True),
    "softcap": (64, 16, 16, 0, 30.0, 4, 2, True),
    "softcap-single": (12, 16, 16, 0, 5.0, 4, 2, True),
    "noncausal": (40, 16, 16, 0, 0.0, 4, 2, False),
}


@pytest.mark.parametrize("name", sorted(CAUSAL))
def test_causal_attention_matches_jax(name):
    S, qc, kc, win, cap, H, KV, causal = CAUSAL[name]
    q, k, v = _qkv(np.random.default_rng(len(name)), 2, S, H, KV)
    kw = dict(q_chunk=qc, kv_chunk=kc, local_window=win, attn_softcap=cap, causal=causal)
    close(TA.causal_attention(t(q), t(k), t(v), **kw),
          JA.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_causal_attention_refuses_kv_shard():
    """kv_shard=True, once refused, is now JAX's key-axis-sharded path:
    without a mesh it computes JAX's attention (tests/test_torch_sharding.py
    covers its dtypes and windows)."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 40, 4, 2)
    kw = dict(q_chunk=16, kv_chunk=16, kv_shard=True)
    close(TA.causal_attention(t(q), t(k), t(v), **kw),
          JA.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (6, 30.0)])
def test_decode_attention_matches_jax(window, cap):
    """GQA (4 heads over 2 KV heads), a position per row, a local window."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    pos = np.asarray([0, 9, 19], np.int32)
    kw = dict(local_window=window, attn_softcap=cap)
    close(TA.decode_attention(t(q), t(kc), t(vc), t(pos), **kw),
          JA.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(pos), **kw))


def test_full_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    mask = rng.random((2, 1, 7, 11)) < 0.8
    mask[..., 0] = True
    for m in (None, mask):
        close(TA.full_attention(t(q), t(k), t(v), attn_softcap=20.0,
                                mask=None if m is None else t(m)),
              JA.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                attn_softcap=20.0, mask=None if m is None else jnp.asarray(m)))


# ------------------------------------------------------ value width (MLA)
def _qkv_v(rng, B, S, H, D=24, Dv=16):
    """MLA's widths at reduced size: queries and keys of nope + rope = 24,
    values of nope = 16."""
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, Dv)).astype(np.float32))


@pytest.mark.parametrize("S", [12, 64, 40])
def test_causal_attention_value_width_matches_jax(S):
    """One chunk, the chunked online softmax and the padded ragged path."""
    q, k, v = _qkv_v(np.random.default_rng(S), 2, S, 4)
    kw = dict(q_chunk=16, kv_chunk=16)
    got = TA.causal_attention(t(q), t(k), t(v), **kw)
    assert tuple(got.shape) == (2, S, 4, 16)
    close(got, JA.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_decode_attention_value_width_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 4, 24)).astype(np.float32)
    _, kc, vc = _qkv_v(rng, 3, 20, 4)
    pos = np.asarray([0, 9, 19], np.int32)
    close(TA.decode_attention(t(q), t(kc), t(vc), t(pos)),
          JA.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(pos)))


# -------------------------------------------------------------------- model
@functools.lru_cache(maxsize=None)
def _jax_model(arch: str, scan: bool):
    cfg = dataclasses.replace(j_reduced(j_arch(arch)), scan_layers=scan)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _model(arch: str, scan=None, **over):
    """(JAX cfg, JAX params, port cfg, the same params as tensors); the
    config's own layout unless ``scan`` sets ``scan_layers``; ``over``
    replaces other config fields (the parameters do not depend on them)."""
    if scan is None:
        scan = j_arch(arch).scan_layers
    jcfg, jp = _jax_model(arch, scan)
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
    cfg = dataclasses.replace(reduced(get_arch(arch)), scan_layers=scan, **over)
    tp = carry.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _batch(cfg, B=2, S=40, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax_layer(jcfg):
    """JAX's prefill of one global attention layer, jitted."""
    return jax.jit(lambda p, x, pos: JT.apply_attn_layer(p, x, jcfg, "global", pos))


def _layer0(jp, tp):
    """The first layer's parameters of an unrolled model in both packages."""
    return jp["rem_blocks"][0], tp["rem_blocks"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_jax(arch):
    """The same keys, shapes and dtypes as the JAX initialisation: carrying
    weights across is a copy."""
    jcfg, jp, cfg, _ = _model(arch)
    mine = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = tree_leaves(mine)
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", path
    assert [len(mine["blocks"]), len(mine["rem_blocks"])] == \
        [len(jp["blocks"]), len(jp["rem_blocks"])]
    assert sorted(mine) == sorted(jp)


# every arch in its own layout, and the other layout where the reduced
# config has more than one super-block (recurrentgemma's 3 layers are one)
LAYOUTS = [(a, j_arch(a).scan_layers) for a in ARCHS] + [
    ("tinyllama-1.1b", False), ("mamba2-780m", False), ("deepseek-v2-236b", False),
    ("arctic-480b", False), ("whisper-base", True)]
LAYOUT_IDS = [f"{a}-{'stacked' if s else 'unrolled'}" for a, s in LAYOUTS]


@pytest.mark.parametrize("arch,scan", LAYOUTS, ids=LAYOUT_IDS)
def test_forward_matches_jax(arch, scan):
    """Logits over 40 tokens (llava: after its 16 patch embeddings;
    whisper: after encoding 32 frames), which crosses the reduced configs'
    16-position chunks and mamba2's 8-token SSD chunks."""
    jcfg, jp, cfg, tp = _model(arch, scan)
    batch = _batch(cfg)
    with torch.no_grad():
        got = TT.forward(tp, cfg, {k: t(v) for k, v in batch.items()})
    want = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_prefill_match_jax(arch):
    jcfg, jp, cfg, tp = _model(arch)
    batch = _batch(cfg, S=16, seed=4)
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, last = jax.jit(lambda p, b: (JT.loss_fn(p, jcfg, b), JT.prefill(p, jcfg, b)))(jp, jb)
    with torch.no_grad():
        tb = {k: t(v) for k, v in batch.items()}
        close(TT.loss_fn(tp, cfg, tb), loss)
        close(TT.prefill(tp, cfg, tb), last)


@functools.lru_cache(maxsize=None)
def _jax_step(arch: str, scan: bool):
    cfg = _jax_model(arch, scan)[0]
    return jax.jit(lambda p, c, tok, pos: JT.serve_step(p, cfg, c, tok, pos))


@pytest.mark.parametrize("arch,scan", LAYOUTS, ids=LAYOUT_IDS)
def test_serve_step_and_cache_match_jax(arch, scan):
    """Six decode steps at uneven per-row positions (gemma2's local ring of
    32 wraps at row 1); the logits and every cache leaf after each step:
    keys and values, MLA latents, SSD and RG-LRU states with their conv
    inputs.  whisper's ``enc_out`` holds the same random encoding in
    both, so the cross-attention is not attending to zeros."""
    jcfg, jp, cfg, tp = _model(arch, scan)
    rng = np.random.default_rng(6)
    B, L = 2, 40
    jc = JT.init_cache(jcfg, B, L, dtype=jnp.float32)
    tc = TT.init_cache(cfg, B, L, dtype=torch.float32, device="cpu")
    if cfg.encoder_layers:
        enc = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        jc["enc_out"] = jnp.asarray(enc)
        tc["enc_out"].copy_(t(enc))
    assert sorted(tc) == sorted(jc)
    for i in range(6):
        tok = rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
        pos = np.asarray([i, 30 + i], np.int32)
        jl, jc = _jax_step(arch, scan)(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = TT.serve_step(tp, cfg, tc, t(tok), t(pos))
        close(tl, jl)
        want = jax.tree.leaves(jc)
        got = tree_leaves(tc)
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            close(g, w)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "llava-next-34b"])
def test_decode_matches_prefill(arch):
    """Teacher-forced decode through the KV/state cache reproduces the
    forward logits position by position (the twin of the JAX test, at 1e-4
    where JAX holds 2e-2 / 2e-3; a vlm forward needs its patch prefix, so
    llava, as in JAX, is not among them).  MoE archs run at
    ``capacity_factor = n_experts``, as in JAX, so no assignment is
    dropped; whisper decodes against ``cache["enc_out"] = encode(frames)``."""
    over = {}
    if get_arch(arch).n_experts:
        over["capacity_factor"] = float(reduced(get_arch(arch)).n_experts)
    _, _, cfg, tp = _model(arch, **over)
    B, S = 2, 12
    batch = _batch(cfg, B, S)
    tokens = t(batch["tokens"])
    with torch.no_grad():
        full = TT.forward(tp, cfg, {k: t(v) for k, v in batch.items()})
        cache = TT.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
        if cfg.encoder_layers:
            cache["enc_out"].copy_(TT.encode(tp, cfg, t(batch["frames"])))
        outs = []
        for i in range(S):
            logits, cache = TT.serve_step(tp, cfg, cache, tokens[:, i : i + 1],
                                          torch.full((B,), i, dtype=torch.int32))
            outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **TOL)


# ---------------------------------------------------------------------- MoE
def _routed(jcfg, router, x, n_blocks):
    """Assignments over capacity in JAX's routing of ``x`` (T, D)."""
    T = x.shape[0]
    Tb = T // n_blocks
    K, E = jcfg.experts_per_token, jcfg.n_experts
    cap = max(1, int(np.ceil(Tb * K / E * jcfg.capacity_factor)))
    _, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1), K)
    topi = np.asarray(topi).reshape(n_blocks, Tb * K)
    counts = np.stack([np.bincount(b, minlength=E) for b in topi])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_matches_jax(arch, n_blocks):
    """The sort-based dispatch at the config's own capacity factor (1.25),
    on 48 tokens pushed towards expert 0, so that capacity drops some
    assignments (asserted); deepseek adds its shared expert."""
    jcfg, jp, cfg, tp = _model(arch, False)
    jl, tl = _layer0(jp, tp)
    router = np.asarray(jl["moe"]["w_router_rep"])
    rng = np.random.default_rng(11)
    x = rng.standard_normal((48, cfg.d_model)).astype(np.float32)
    x += 3.0 * router[:, 0] / np.linalg.norm(router[:, 0])
    assert _routed(jcfg, router, x, n_blocks) > 0
    want = jax.jit(lambda p, x_: JM.moe(p, x_, jcfg, n_blocks=n_blocks))(jl["moe"],
                                                                        jnp.asarray(x))
    close(TM.moe(tl["moe"], t(x), cfg, n_blocks=n_blocks), want)


def test_moe_layer_with_dense_residual_matches_jax():
    """arctic's layer: attention, then the MoE plus the dense MLP beside
    it, on 2 x 24 tokens."""
    jcfg, jp, cfg, tp = _model("arctic-480b", False)
    jl, tl = _layer0(jp, tp)
    assert "mlp" in tl and "moe" in tl
    x = np.random.default_rng(12).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want, _ = _jax_layer(jcfg)(jl, jnp.asarray(x), jnp.asarray(pos))
    got, _ = TT.apply_attn_layer(tl, t(x), cfg, "global",
                                 TC.rope_angles(t(pos), cfg.hd, cfg.rope_theta))
    close(got, want)


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("mode", ["prefill-12", "prefill-40", "decode"])
def test_mla_matches_jax(mode):
    """deepseek's layer: prefill in one chunk and across the 16-position
    chunks (ragged, padded), and four decode steps at uneven positions
    with the ``ckv`` / ``krope`` cache leaves after each."""
    jcfg, jp, cfg, tp = _model("deepseek-v2-236b", False)
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(13)
    if mode.startswith("prefill"):
        S = int(mode.split("-")[1])
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        pos = np.arange(S, dtype=np.int32)
        want, _ = _jax_layer(jcfg)(jl, jnp.asarray(x), jnp.asarray(pos))
        got, _ = TT.apply_attn_layer(tl, t(x), cfg, "global",
                                     TC.rope_angles(t(pos), cfg.rope_head_dim, cfg.rope_theta))
        close(got, want)
        return
    jc = {k: v for k, v in JT.init_cache(jcfg, 2, 20, dtype=jnp.float32)["rem_blocks"][0].items()}
    tc = TT.init_cache(cfg, 2, 20, dtype=torch.float32, device="cpu")["rem_blocks"][0]
    step = jax.jit(lambda p, x_, c, q: JT.apply_attn_layer(p, x_, jcfg, "global", None, c, q))
    for i in range(4):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = np.asarray([i, 11 + 2 * i], np.int32)
        want, jc = step(jl, jnp.asarray(x), jc, jnp.asarray(pos))
        got, tc = TT.apply_attn_layer(
            tl, t(x), cfg, "global",
            TC.rope_angles(t(pos)[:, None], cfg.rope_head_dim, cfg.rope_theta), tc, t(pos))
        close(got, want)
        for key in ("ckv", "krope"):
            close(tc[key], jc[key])


# ---------------------------------------------------------------------- SSD
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                           None if st is None else jnp.asarray(st))
    got = TS._causal_conv(t(x), t(w), None if st is None else t(st))
    for g, w_ in zip(got, want):
        close(g, w_)


def test_ssd_chunked_matches_jax():
    """Three chunks of 8, so the inter-chunk recurrence runs twice."""
    rng = np.random.default_rng(15)
    b, s, h, p, n = 2, 24, 3, 4, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (0.5 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    want = jax.jit(lambda *a: JS.ssd_chunked(*a, chunk=8))(*map(jnp.asarray, (x, dt, A, B, C)))
    got = TS.ssd_chunked(*map(t, (x, dt, A, B, C)), chunk=8)
    for g, w in zip(got, want):
        close(g, w)


def test_ssm_block_matches_jax():
    """Prefill of 13 tokens (padded to two chunks of 8), then two decode
    steps from its state and conv inputs."""
    jcfg, jp, cfg, tp = _model("mamba2-780m", False)
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    block = jax.jit(lambda p, x_, *st: JS.ssm_block(p, x_, jcfg, *st))
    want = block(jl["ssm"], jnp.asarray(x))
    got = TS.ssm_block(tl["ssm"], t(x), cfg)
    for g, w in zip(got, want):
        close(g, w)
    jst, tst = want[1:], got[1:]
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want = block(jl["ssm"], jnp.asarray(x1), *jst)
        got = TS.ssm_block(tl["ssm"], t(x1), cfg, *tst)
        for g, w in zip(got, want):
            close(g, w)
        jst, tst = want[1:], got[1:]


# ------------------------------------------------------------------- RG-LRU
def test_rglru_scan_matches_jax():
    """The sequential loop against JAX's associative scan, 20 steps."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 20, 12)).astype(np.float32)
    r, i = (1 / (1 + np.exp(-rng.standard_normal((2, 20, 12))))).astype(np.float32), \
        (1 / (1 + np.exp(-rng.standard_normal((2, 20, 12))))).astype(np.float32)
    lam = rng.standard_normal(12).astype(np.float32)
    want = jax.jit(JR._rglru_scan)(*map(jnp.asarray, (x, r, i, lam)))
    got = TR._rglru_scan(*map(t, (x, r, i, lam)))
    for g, w in zip(got, want):
        close(g, w)


def test_rglru_block_matches_jax():
    """Prefill of 9 tokens, then two decode steps from its state."""
    jcfg, jp, cfg, tp = _model("recurrentgemma-2b")
    jl, tl = _layer0(jp, tp)
    assert "rglru" in tl
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    block = jax.jit(lambda p, x_, *st: JR.rglru_block(p, x_, jcfg, *st))
    want = block(jl["rglru"], jnp.asarray(x))
    got = TR.rglru_block(tl["rglru"], t(x), cfg)
    for g, w in zip(got, want):
        close(g, w)
    jst, tst = want[1:], got[1:]
    for _ in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want = block(jl["rglru"], jnp.asarray(x1), *jst)
        got = TR.rglru_block(tl["rglru"], t(x1), cfg, *tst)
        for g, w in zip(got, want):
            close(g, w)
        jst, tst = want[1:], got[1:]


# ------------------------------------------------------------------ encoder
def test_encode_matches_jax():
    """whisper's encoder over 2 x 32 frames (``encoder_seq`` 32)."""
    jcfg, jp, cfg, tp = _model("whisper-base")
    assert cfg.encoder_seq == 32
    frames = np.random.default_rng(19).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = TT.encode(tp, cfg, t(frames))
    close(got, jax.jit(lambda p, f: JT.encode(p, jcfg, f))(jp, jnp.asarray(frames)))


def test_bf16_forward_runs_in_bf16_as_jax(monkeypatch):
    """bf16 parameters keep a bf16 residual stream and float32 logits; the
    logits agree with JAX's bf16 forward to a few bf16 roundings (eps
    2^-8) of the stream: 2^-5 of the largest logit (measured 7e-3)."""
    arch = "gemma2-9b"
    jcfg = dataclasses.replace(j_reduced(j_arch(arch)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = carry.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed_embed"].dtype == torch.bfloat16
    assert tp["final_norm_rep"].dtype == torch.float32
    batch = _batch(cfg, S=16)
    seen = []
    orig = TT.apply_attn_layer

    def spy(p, x, *a, **kw):
        out = orig(p, x, *a, **kw)
        seen.append(out[0].dtype)
        return out

    monkeypatch.setattr(TT, "apply_attn_layer", spy)
    with torch.no_grad():
        got = TT.forward(tp, cfg, {"tokens": t(batch["tokens"])}).numpy()
    assert seen == [torch.bfloat16] * cfg.n_layers and got.dtype == np.float32
    want = np.asarray(jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(batch["tokens"])}))
    assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max()


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 2, 16)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotServer(cfg, params, capacity=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carry.params_from_numpy({"w": np.zeros(2, np.float32)})
    assert SlotServer(cfg, params, capacity=2, max_len=16, device="cpu").device.type == "cpu"
