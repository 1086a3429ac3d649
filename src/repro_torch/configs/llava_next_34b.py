"""LLaVA-NeXT 34B — decoder LM backbone; anyres vision tower stubbed to
patch embeddings. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    num_patches=2880,     # anyres tiling: base + 4 tiles x 576 patches
    tie_embeddings=False,
))
