"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks.

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0 -> blocks are pure token
mixers with in/out projections (no separate FFN).  Even layers mLSTM
(matrix memory, chunk-parallelizable), odd layers sLSTM (scalar memory,
strictly recurrent).  Recurrent state is O(1) per token -> long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    tie_embeddings=True,
    sub_quadratic=True,
)
