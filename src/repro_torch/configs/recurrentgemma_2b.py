"""RecurrentGemma 2B — RG-LRU + local attention, 2:1 pattern (Griffin).
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    rglru_width=2560,
    scan_layers=False,
))
