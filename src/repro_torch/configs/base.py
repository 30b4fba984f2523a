"""Model configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base.ModelConfig`` that the dense
family reads, with the same names, defaults and ``reduced()`` rule, so a
port config and a reference config built the same way compare equal
field by field.  The other families' sub-configs (MLA, MoE, SSM, the
encoder and vision extras) are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

Family = str  # only "dense" is ported


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // n_heads
    max_seq_len: int = 131072
    rope_theta: float = 500000.0
    norm: str = "rmsnorm"           # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    activation: str = "silu"        # "silu" (SwiGLU) | "gelu" (plain MLP)
    tie_embeddings: bool = False
    sliding_window: int = 0         # 0 => full causal attention
    dtype: str = "bfloat16"         # compute dtype over fp32 params
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count of a dense model (biases and norms
        excluded from the layers, as in the reference's count)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        per_mlp = (3 if self.activation == "silu" else 2) * d * self.d_ff
        return emb + self.n_layers * (per_attn + per_mlp + 2 * d) + d

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 heads (head_dim
        stays d_model // n_heads, so 64 for the GPT-2 configs)."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) or 4
        kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else n_heads
        return replace(
            self, n_layers=2, d_model=d, n_heads=n_heads,
            n_kv_heads=max(1, kv), d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512), head_dim=d // n_heads,
            max_seq_len=1024,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0)
