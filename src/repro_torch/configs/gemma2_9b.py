"""Gemma2 9B — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    attn_pattern=("local", "global"),
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
))
