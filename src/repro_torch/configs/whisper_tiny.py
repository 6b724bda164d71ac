"""whisper-tiny [audio]: 4L enc + 4L dec, d=384 6H, d_ff 1536, vocab 51865.
Conv frontend STUBBED: enc inputs are precomputed frame embeddings.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encoder_layers=4,
    encoder_seq=1500,
)
