"""Mamba2 780M — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    rope=False,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
))
