"""Gemma-2 2B [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local(4096-window)/global alternating attention, attn logit softcap 50,
final logit softcap 30, post-norms (RMSNorm after attn and mlp outputs),
GeGLU MLP, head_dim 256, tied embeddings (vocab 256k dominates params).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab_size=256000,
    window=4096,
    local_global_period=2,      # layers 0,2,4,... local; 1,3,5,... global
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    mlp_act="gelu",
    tie_embeddings=True,
)
