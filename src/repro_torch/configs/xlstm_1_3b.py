"""xlstm-1.3b [ssm]: 48L d=2048 4H, sLSTM + mLSTM blocks, vocab 50304.
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,          # every 8th block is sLSTM (6 of 48)
)
