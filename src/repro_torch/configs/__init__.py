"""Config registry of the port: the paper's three GPT-2 models, the SSM
model falcon-mamba-7b and the hybrid zamba2-2.7b.

The reference registry also holds MoE, MLA, encoder-decoder and vision
architectures; those families are ROADMAP queue 1, item 10 ("the other
model families") and raise here until they are ported.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, TrainConfig
from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON_MAMBA_7B
from repro_torch.configs.gpt2 import (
    GPT2_LARGE, GPT2_LARGE_REDUCED, GPT2_MEDIUM,
)
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B

ARCH_CONFIGS = {c.name: c for c in (GPT2_MEDIUM, GPT2_LARGE,
                                    GPT2_LARGE_REDUCED, FALCON_MAMBA_7B,
                                    ZAMBA2_2_7B)}

_NOT_PORTED = (
    "minicpm3-4b", "phi-3-vision-4.2b", "phi3.5-moe-42b-a6.6b",
    "llama3-405b", "phi4-mini-3.8b", "whisper-small", "deepseek-v2-236b",
    "llama3.2-3b",
)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in ARCH_CONFIGS:
        return ARCH_CONFIGS[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to PyTorch yet (ROADMAP "
            f"queue 1, item 10: the other model families); available: "
            f"{sorted(ARCH_CONFIGS)}")
    raise KeyError(f"unknown arch {arch_id!r}; available: "
                   f"{sorted(ARCH_CONFIGS)}")


__all__ = ["ARCH_CONFIGS", "ModelConfig", "SSMConfig", "TrainConfig",
           "get_config"]
