"""Whisper-large-v3 backbone [arXiv:2212.04356]: encoder-decoder audio.

32L(dec) d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866, plus a
32-layer encoder over 1500 audio frames.  The conv/mel frontend is a
STUB per the assignment: input_specs() supplies precomputed frame
embeddings (B, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab_size=51866,
    n_encoder_layers=32,
    encoder_seq=1500,
    mlp_act="gelu",
    tie_embeddings=True,
)
