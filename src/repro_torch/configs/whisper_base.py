"""Whisper base — enc-dec, conv audio frontend stubbed to frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register

ARCH = register(ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    rope=False,            # whisper uses learned/sinusoidal positions
    encoder_layers=6,
    encoder_seq=1500,
    cross_attention=True,
    scan_layers=False,
    tie_embeddings=True,
))
