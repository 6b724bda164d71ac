"""zamba2-7b [hybrid]: 81L d=3584 32H (kv=32) d_ff 14336, vocab 32000,
ssm_state=64.  Mamba2 blocks + ONE shared attention block (E-mode weight
sharing) applied every 6 layers.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    shared_attn_every=6,
)
