"""Architecture registry: ``--arch <id>`` resolves through ARCHS."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from repro_torch.configs.xlstm_1_3b import CONFIG as xlstm_1_3b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.minitron_4b import CONFIG as minitron_4b
from repro_torch.configs.llama3_2_3b import CONFIG as llama3_2_3b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.llama3_2_vision_11b import CONFIG as llama3_2_vision_11b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "xlstm-1.3b": xlstm_1_3b,
    "whisper-tiny": whisper_tiny,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "minitron-4b": minitron_4b,
    "llama3.2-3b": llama3_2_3b,
    "granite-34b": granite_34b,
    "llama-3.2-vision-11b": llama3_2_vision_11b,
    "zamba2-7b": zamba2_7b,
}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "shape_applicable"]
