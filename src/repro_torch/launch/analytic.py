"""Analytic per-step FLOPs and HBM-byte estimates per (arch × shape × plan)
(port of ``repro/launch/analytic.py``, line for line: the same floats for
every config and shape).

The reference's roofline takes its compute and memory terms from these
closed-form estimates because XLA's ``cost_analysis`` undercounts scanned
(while-loop) bodies; the port's dry run (``launch/dryrun.py``) takes them
for the same two terms, and its collective term from the collectives its
step issues (``launch/collective_trace.py``).  MODEL_FLOPS = 6·N_active·D
stays the *useful* work yardstick — the gap between the two is the
remat/full-block waste reported as ``useful_flops_fraction``.

Some terms describe the reference's program rather than the port's, and
are kept as the reference counts them (a second count would be a feature
the reference lacks):

  * attention FLOPs count every score block, the masked half of causal
    attention included, as the reference's chunked attention computes
    them; the port's kernel A skips the blocks above the diagonal (and
    outside a window), so on the card it executes about half the train
    and prefill attention FLOPs counted here;
  * the SSM term is the reference's closed form, 8·B·S·d_inner·d_state a
    layer; the port's scans (kernels 3 and 4, or the plain per-token
    recurrences where a family trains) do other work for the same
    function;
  * the HBM bytes assume bf16 weights (2 bytes a parameter a pass) and
    fp32 optimizer state (24 bytes a parameter a step); the port keeps
    fp32 params and casts each layer's to bf16 at its use, reads and
    writes the estimate does not count.

Per-device traffic depends on the plan: ``dp`` (batch-sharding degree) and
``tp`` (model-axis degree) describe how activations / weights / caches are
spread; ``zero_deg`` how optimizer state is spread.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _attn_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_heads, qk_dim, v_dim) per attention layer."""
    if cfg.mla is not None:
        m = cfg.mla
        return cfg.n_heads, m.nope_head_dim + m.rope_head_dim, m.v_head_dim
    return cfg.n_heads, cfg.head_dim, cfg.head_dim


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    if cfg.family == "encdec":
        return cfg.n_layers * 2 + cfg.n_enc_layers   # self + cross + enc
    return cfg.n_layers


@dataclass
class AnalyticCost:
    flops_total: float          # executed FLOPs for the whole step, all chips
    hbm_bytes_per_device: float
    model_flops: float          # useful 6·N_active·D (or fwd equivalents)


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *, n_devices: int,
                  dp: int = 1, tp: int = 1, zero_deg: int = 1,
                  remat: bool = True, window: int = 0) -> AnalyticCost:
    B, S = shape.global_batch, shape.seq_len
    n_active = cfg.active_param_count()
    n_params = cfg.param_count()
    H, dqk, dv = _attn_dims(cfg)
    La = _n_attn_layers(cfg)
    Ls = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    ds = cfg.ssm.d_state if cfg.ssm else 0
    di = (cfg.ssm.expand * cfg.d_model) if cfg.ssm else 0
    d = cfg.d_model
    dp = max(dp, 1)
    tp = max(tp, 1)

    def act_traffic(tokens: float, passes: float) -> float:
        """Residual stream (batch-sharded) + tp-sharded hidden streams."""
        d_ff_eff = cfg.d_ff
        if cfg.family == "moe" and cfg.moe:
            eff = cfg.moe.expert_d_ff or cfg.d_ff
            d_ff_eff = eff * (cfg.moe.top_k + cfg.moe.n_shared_experts)
        per_layer = d * 2 * 6 + (2 * d_ff_eff + H * (dqk + dv)) / tp * 2 * 2
        return tokens / dp * per_layer * cfg.n_layers * passes / 2

    if shape.kind == "train":
        tokens = B * S
        mult = 8.0 if remat else 6.0         # fwd+bwd(+remat fwd)
        param_flops = mult / 6.0 * 6.0 * n_active * tokens
        # chunked attention computes full (non-causal-skipped) blocks:
        attn_flops = (4.0 if remat else 3.0) * 2 * B * S * S * H \
            * (dqk + dv) / 2 * La
        ssm_flops = (4.0 if remat else 3.0) * 8 * B * S * di * ds * Ls
        flops = param_flops + attn_flops + ssm_flops
        model_flops = 6.0 * n_active * tokens
        param_traffic = n_params / tp * 2 * 3      # bf16, fwd+bwd+remat
        opt_traffic = n_params / max(zero_deg * tp, 1) * 24  # fp32 m,v rw + g
        hbm = param_traffic + opt_traffic + act_traffic(tokens, 3 if remat
                                                        else 2)
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens \
            + 2 * B * S * S * H * (dqk + dv) / 2 * La \
            + 2 * B * S * di * ds * Ls
        model_flops = 2.0 * n_active * tokens
        hbm = n_params / tp * 2 + act_traffic(tokens, 1)
    else:  # decode: ONE token, cache length = min(S, window or S)
        cache_len = min(S, window) if window else S
        flops = 2.0 * n_active * B \
            + 2 * B * cache_len * H * (dqk + dv) * La \
            + 8 * B * di * ds * Ls
        model_flops = 2.0 * n_active * B
        if cfg.mla is not None:
            kv_row = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
            layers_cached = cfg.n_layers
        else:
            kv_row = 2 * cfg.n_kv_heads * cfg.head_dim
            layers_cached = La if cfg.family != "encdec" else cfg.n_layers
        # decode caches are sharded over batch (dp) AND cache-seq (tp)
        cache_local = B * cache_len * kv_row * layers_cached * 2 \
            / (dp * tp)
        state_local = B * di * ds * Ls * 4 / dp
        hbm = n_params / tp * 2 + cache_local + state_local
    return AnalyticCost(flops_total=float(flops),
                        hbm_bytes_per_device=float(hbm),
                        model_flops=float(model_flops))


def placement_degrees(plan, topo, placement, global_batch: int, *,
                      model: int = 1) -> Tuple[int, int, int]:
    """(dp, tp, zero_deg) for a plan *placed on topology sites* — the
    device-free twin of ``plan_degrees`` for ``core.search`` candidates:
    degrees come from the (pod, data, model) shape the placement's sites
    map to (launch/mesh.topology_mesh_spec), so the analytic roofline can
    price a searched plan before any mesh exists.  The placement's
    ``stage_order``/``stage_layers`` do not change the degrees (they
    permute pod blocks and re-slice — pad-and-mask at runtime — the
    layer stack, not the axis sizes), so any ``core.plans.Placement``
    is accepted as-is.  Extended-pool winners price the same way:
    ``shard_zero``/``fsdp`` placements get their ZeRO degree from the
    pod×data pool of the selected sites (docs/cost-model.md)."""
    from repro_torch.launch.mesh import topology_mesh_spec
    (pod, data, m), _ = topology_mesh_spec(topo, placement.sites,
                                           model=model)
    sizes = {"pod": pod, "data": data, "model": m}
    cand = ("pod", "data") if (plan.shards_weights or plan.pipeline) \
        else ("pod", "data", "model")
    dp = 1
    for a in cand:
        if global_batch > 0 and global_batch % (dp * sizes[a]) == 0:
            dp *= sizes[a]
    tp = m if (plan.shards_weights or plan.pipeline) else 1
    zdeg = pod * data if plan.zero_sharding else 1
    return max(dp, 1), max(tp, 1), max(zdeg, 1)


def plan_degrees(plan, mesh, global_batch: int) -> Tuple[int, int, int]:
    """(dp, tp, zero_deg) for a plan on a mesh."""
    axes = plan.batch_axes(mesh, global_batch)
    dp = 1
    for a in axes:
        dp *= mesh.shape[a]
    tp = mesh.shape.get("model", 1) if (plan.shards_weights or plan.pipeline) \
        else 1
    zdeg = 1
    if plan.zero_sharding:
        for a in plan.mesh_axes(mesh)["data"]:
            zdeg *= mesh.shape[a]
    return max(dp, 1), max(tp, 1), max(zdeg, 1)