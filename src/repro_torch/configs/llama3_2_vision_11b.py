"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H (GQA kv=8) d_ff 14336,
vocab 128256, cross-attn image layers every 5.  Vision encoder STUBBED:
image inputs are precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    image_tokens=1600,
)
