"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) d_ff 24576, vocab 49152.
Llama-arch code model.  [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
)
