"""Model and training configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base.ModelConfig`` that the
dense, MoE, SSM, hybrid, encoder-decoder and vision-language families
read, Multi-head Latent Attention (``MLAConfig``, MiniCPM3 and
DeepSeek-V2) included, with the same names, defaults and ``reduced()``
rule, so a port config and a reference config built the same way compare
equal field by field; of ``TrainConfig``, field for field; and of
``ShapeConfig`` and the four ``INPUT_SHAPES`` the launch tooling prices
(``launch/dryrun.py``), unchanged.  The
plans' runtime fields of the reference's config
(``moe_dispatch_axes``, ``moe_expert_axis``) are not fields here: the
port's plans tell the model how to route (``models.moe.Dispatch``) and
what the model axis cuts (``core.sharding.ModelAxis``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

Family = str  # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style).

    K/V are compressed into a ``kv_lora_rank``-dim latent that is what gets
    cached at decode time; a decoupled RoPE key of ``rope_head_dim`` is
    cached alongside.  Queries may also be low-rank (``q_lora_rank``).
    """
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 => full-rank queries
    rope_head_dim: int = 64         # decoupled rope key dim (all heads')
    nope_head_dim: int = 128        # per-head non-rope dim
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared_experts: int = 0       # always-on experts (DeepSeek style)
    expert_d_ff: int = 0            # 0 => use model d_ff
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    router_jitter: float = 0.0
    capacity_factor: float = 1.25   # >= n_experts/top_k => never drops


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    version: int = 1                # 1 => Mamba1 selective scan, 2 => Mamba2/SSD
    n_heads: int = 0                # Mamba2 heads (0 => d_inner//head_dim)
    head_dim: int = 64              # Mamba2 head dim
    chunk: int = 64                 # SSD chunk length


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
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): apply the shared attention block every k-th layer
    hybrid_attn_every: int = 0      # 0 => no interleaved attention
    # enc-dec (whisper): encoder depth + frontend stub shape
    n_enc_layers: int = 0
    enc_seq_len: int = 0            # precomputed frame embeddings length
    # vlm (phi-3-vision): stub vision frontend shape
    vision_dim: int = 0             # patch embedding dim fed to the projector
    n_patches: int = 0
    dtype: str = "bfloat16"         # compute dtype over fp32 params
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode available (native state or sliding window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count, term for term the reference's
        (biases and most norms excluded)."""
        c = self
        d = c.d_model
        emb = c.vocab_size * d * (1 if c.tie_embeddings else 2)
        per_attn = per_mlp = per_ssm = 0
        if c.family != "ssm" and c.mla is not None:
            m = c.mla
            qdim = m.nope_head_dim + m.rope_head_dim
            q_in = m.q_lora_rank or d
            per_attn = (d * m.q_lora_rank + q_in * c.n_heads * qdim
                        + d * (m.kv_lora_rank + m.rope_head_dim)
                        + m.kv_lora_rank * c.n_heads
                        * (m.nope_head_dim + m.v_head_dim)
                        + c.n_heads * m.v_head_dim * d)
        elif c.family != "ssm":
            hd = c.head_dim
            per_attn = d * (c.n_heads * hd) + 2 * d * (c.n_kv_heads * hd) \
                + (c.n_heads * hd) * d
        if c.family != "ssm":
            per_mlp = (3 if c.activation == "silu" else 2) * d * c.d_ff
        if c.family == "moe":
            if c.moe is None:
                raise ValueError("family 'moe' needs a MoEConfig")
            eff = c.moe.expert_d_ff or c.d_ff
            n_e = c.moe.n_experts + c.moe.n_shared_experts
            per_mlp = n_e * 3 * d * eff + d * c.moe.n_experts  # + router
        if c.family in ("ssm", "hybrid"):
            di, ds = c.ssm.expand * d, c.ssm.d_state
            per_ssm = 2 * d * di + c.ssm.d_conv * di + di * ds * 2 + di * 2 \
                + di * d
            if c.ssm.version == 2:
                nh = c.ssm.n_heads or di // c.ssm.head_dim
                per_ssm = 2 * d * di + c.ssm.d_conv * di + di * 2 * ds \
                    + nh * 2 + di * d
        if c.family == "ssm":
            layers = c.n_layers * (per_ssm + 2 * d)
        elif c.family == "hybrid":
            n_attn = c.n_layers // c.hybrid_attn_every \
                if c.hybrid_attn_every else 0
            shared = per_attn + 3 * d * c.d_ff   # one shared attn+mlp block
            layers = c.n_layers * (per_ssm + 2 * d) + shared + n_attn * d
        else:
            layers = c.n_layers * (per_attn + per_mlp + 2 * d)
        enc = 0
        if c.family == "encdec":
            # encoder layers + decoder cross-attention
            enc_layer = 4 * d * d \
                + (3 if c.activation == "silu" else 2) * d * c.d_ff + 2 * d
            enc = c.n_enc_layers * enc_layer + c.n_layers * 4 * d * d
        vlm = 0
        if c.family == "vlm":
            vlm = c.vision_dim * d + d * d  # 2-layer projector
        return emb + layers + enc + vlm + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        c, m = self, self.moe
        total = self.param_count()
        eff = m.expert_d_ff or c.d_ff
        inactive = (m.n_experts - m.top_k) * 3 * c.d_model * eff * c.n_layers
        return total - inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 heads (head_dim
        d_model // n_heads, so 64; the ssm family recomputes it the same
        way from 4 heads), SSM state 8 and chunk 16, a hybrid group of 2,
        for MLA a latent of 32 and full-rank queries of 32 + 16 (rope)
        dims over values of 32, and for MoE 4 experts, top-2, expert d_ff
        <= 256 and a capacity factor of 2.0 (no drops, so forward,
        prefill and decode agree); an encoder-decoder keeps 2 encoder
        layers over 32 frames, a vision-language model 8 patches of 64
        features."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) or 4
        kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else n_heads
        kw = dict(
            n_layers=2, d_model=d, n_heads=n_heads, n_kv_heads=max(1, kv),
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=d // n_heads if self.family != "ssm" else 0,
            max_seq_len=1024,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                  rope_head_dim=16, nope_head_dim=32,
                                  v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=2,
                                n_shared_experts=min(
                                    self.moe.n_shared_experts, 1),
                                expert_d_ff=min(
                                    self.moe.expert_d_ff or 256, 256),
                                capacity_factor=2.0)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=8, n_heads=0, head_dim=32,
                                chunk=16)
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
        if self.family == "encdec":
            kw["n_enc_layers"] = 2
            kw["enc_seq_len"] = 32
        if self.family == "vlm":
            kw["vision_dim"] = 64
            kw["n_patches"] = 8
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"        # "cosine" | "linear" | "constant"
    seed: int = 0
    microbatches: int = 4           # pipeline microbatches (pipeshard)
    remat: bool = True              # per-layer activation checkpointing
    zero_opt_state: bool = False    # shard optimizer state over data axes
    grad_accum: int = 1             # sequential microbatches per step (cuts
    #   activation memory ~grad_accum x at zero extra collective volume)
