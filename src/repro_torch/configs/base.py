"""Architecture configs (``repro.configs.base``): the ten LM architectures.

Every architecture is a selectable config (``--arch <id>``) with its
published widths; ``reduced`` gives a tiny same-family config for CPU
tests.  The configs are shapes, not weights: all ten register here, and
``models/transformer.py`` runs and serves each of them.
"""
from __future__ import annotations

import dataclasses
import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    rope: bool = True
    rope_theta: float = 10000.0
    attn_pattern: tuple = ("global",)  # cycled across layers
    local_window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # hybrid (recurrentgemma): pattern cycled; rglru width
    block_pattern: tuple = ()
    rglru_width: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False
    # vlm stub
    num_patches: int = 0
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    scan_layers: bool = True
    q_chunk: int = 1024
    kv_chunk: int = 1024
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/lm-head
        shard cleanly over any mesh 'model' axis (MaxText-style padding;
        whisper's 51865 and mamba2's 50280 are otherwise unshardable).
        Pad rows are ordinary never-targeted parameters."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can serve 500k-token contexts (SSM / hybrid-local only)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.family == "ssm":
            din = self.ssm_expand * d
            per = d * (2 * din + 2 * self.ssm_state + din // self.ssm_head_dim) + din * d
        elif self.family == "hybrid":
            w = self.rglru_width or d
            n_rec = sum(1 for b in self._pattern() if b == "rec")
            n_att = L - n_rec
            per_rec = d * w * 3 + w * d + 3 * w
            per_att = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            per_mlp = 3 * d * f
            return emb + n_rec * (per_rec + per_mlp) + n_att * (per_att + per_mlp)
        else:
            if self.use_mla:
                attn = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.nope_head_dim + self.rope_head_dim
                ) + d * (self.kv_lora_rank + self.rope_head_dim) + self.kv_lora_rank * self.n_heads * (
                    self.nope_head_dim * 2
                ) + self.n_heads * self.nope_head_dim * d
            else:
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = 3 * d * f if f else 0
            moe = 0
            if self.n_experts:
                moe = self.n_experts * 3 * d * self.expert_d_ff + d * self.n_experts
                moe += self.n_shared_experts * 3 * d * self.expert_d_ff
            per = attn + mlp + moe
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d + 3 * d * f)
            per += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d  # cross-attn
        return emb + L * per + enc

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-in experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * self.d_model * self.expert_d_ff
        moe_act = self.n_layers * self.experts_per_token * 3 * self.d_model * self.expert_d_ff
        return full - moe_all + moe_act

    def _pattern(self):
        if self.block_pattern:
            return [self.block_pattern[i % len(self.block_pattern)] for i in range(self.n_layers)]
        return ["attn"] * self.n_layers


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib

    for mod in (
        "arctic_480b",
        "deepseek_v2_236b",
        "whisper_base",
        "mamba2_780m",
        "tinyllama_1_1b",
        "starcoder2_15b",
        "glm4_9b",
        "gemma2_9b",
        "llava_next_34b",
        "recurrentgemma_2b",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")


def cell_is_supported(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason when skipped (DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; full-attention arch skipped"
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2 if not cfg.block_pattern else 3,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        head_dim=16,
        local_window=32,
        q_chunk=16,
        kv_chunk=16,
        scan_layers=cfg.scan_layers,
        dtype="float32",
    )
    if cfg.n_experts:
        kw.update(n_experts=4, experts_per_token=2, expert_d_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8, nope_head_dim=16, head_dim=24)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.rglru_width:
        kw.update(rglru_width=96)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=32)
    if cfg.num_patches:
        kw.update(num_patches=16)
    return dataclasses.replace(cfg, **kw)


def input_specs(cfg: ArchConfig, shape: ShapeCfg, *, dtype=torch.bfloat16):
    """Stand-ins for every model input, on the ``meta`` device: the shapes
    and dtypes of ``jax.ShapeDtypeStruct``s, with no storage."""
    B, S = shape.global_batch, shape.seq_len
    ints = torch.int32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    specs = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = spec((B, S), ints)
        if shape.kind == "train":
            specs["targets"] = spec((B, S), ints)
    else:  # decode: one new token against a seq_len-sized cache
        specs["tokens"] = spec((B, 1), ints)
        specs["pos"] = spec((B,), ints)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            specs["frames"] = spec((B, cfg.encoder_seq, cfg.d_model), dtype)
        if cfg.family == "vlm":
            specs["patches"] = spec((B, cfg.num_patches, cfg.d_model), dtype)
    return specs
