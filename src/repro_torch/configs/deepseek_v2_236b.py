"""DeepSeek-V2 236B — MLA (kv_lora=512) + MoE 160 routed top-6 + 2 shared
(a copy of the reference's ``repro/configs/deepseek_v2_236b.py``).

[arXiv:2405.04434] 60L d_model=5120 128H (kv=128 — MLA heads) expert
d_ff=1536 vocab=102400.  DeepSeek-V2's first layer is a dense FFN; we fold
it into a uniform MoE stack (deviation noted in DESIGN.md §4) so the layer
stack is scan/pipeline-uniform.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    rope_theta=10000.0,
    sliding_window=8192,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared_experts=2, expert_d_ff=1536),
    source="arXiv:2405.04434",
)
