"""Config registry of the port: the paper's three GPT-2 models, the
dense llama3.2-3b, phi4-mini-3.8b and llama3-405b, the MoE
phi3.5-moe-42b-a6.6b, the SSM model falcon-mamba-7b, the hybrid
zamba2-2.7b, the Multi-head Latent Attention models minicpm3-4b
(dense) and deepseek-v2-236b (MoE), the encoder-decoder whisper-small
and the vision-language phi-3-vision-4.2b: every architecture of the
reference's registry.
"""
from repro_torch.configs.base import (
    MLAConfig, ModelConfig, MoEConfig, SSMConfig, TrainConfig,
)
from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK_V2_236B
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gpt2 import (
    GPT2_LARGE, GPT2_LARGE_REDUCED, GPT2_MEDIUM,
)
from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA3_2_3B
from repro_torch.configs.llama3_405b import CONFIG as LLAMA3_405B
from repro_torch.configs.minicpm3_4b import CONFIG as MINICPM3_4B
from repro_torch.configs.phi35_moe_42b import CONFIG as PHI35_MOE_42B
from repro_torch.configs.phi3_vision_4_2b import CONFIG as PHI3_VISION_4_2B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI_3_8B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B

ARCH_CONFIGS = {c.name: c for c in (GPT2_MEDIUM, GPT2_LARGE,
                                    GPT2_LARGE_REDUCED, LLAMA3_2_3B,
                                    PHI35_MOE_42B, FALCON_MAMBA_7B,
                                    ZAMBA2_2_7B, MINICPM3_4B,
                                    DEEPSEEK_V2_236B, PHI4_MINI_3_8B,
                                    LLAMA3_405B, WHISPER_SMALL,
                                    PHI3_VISION_4_2B)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCH_CONFIGS:
        return ARCH_CONFIGS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; available: "
                   f"{sorted(ARCH_CONFIGS)}")


__all__ = ["ARCH_CONFIGS", "MLAConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "TrainConfig", "get_config"]
