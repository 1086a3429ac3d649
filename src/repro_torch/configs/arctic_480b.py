"""Snowflake Arctic 480B — MoE 128e top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,            # dense residual MLP
    vocab=32000,
    n_experts=128,
    experts_per_token=2,
    expert_d_ff=4864,
    moe_dense_residual=True,
    tie_embeddings=False,
))
