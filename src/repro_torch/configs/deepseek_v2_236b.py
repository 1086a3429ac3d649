"""DeepSeek-V2 236B — MLA (kv_lora=512), 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: latent-compressed, per-head after decompress
    d_ff=0,               # all-MoE FFN (paper: first layer dense; simplified)
    vocab=102400,
    n_experts=160,
    experts_per_token=6,
    expert_d_ff=1536,
    n_shared_experts=2,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    head_dim=192,         # nope + rope
    tie_embeddings=False,
))
