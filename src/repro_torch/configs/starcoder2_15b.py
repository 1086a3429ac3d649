"""StarCoder2 15B — GQA kv=4, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    tie_embeddings=False,
))
