"""State-space blocks (port of ``repro/models/ssm.py``): Mamba1
(falcon-mamba) and Mamba2/SSD (zamba2), with the reference's names,
parameter keys and dtypes.

Full-sequence forward and prefill scan the sequence:

  * ``use_kernels=True`` goes through ``kernels/ops.py``: kernel 4
    (Mamba1) or kernel 3 (SSD) on a CUDA tensor, their plain sequential
    versions on the CPU;
  * ``use_kernels=False`` runs the reference's jnp algorithms: chunks
    carried by a loop, a log-step prefix scan within a Mamba1 chunk (the
    reference's ``lax.associative_scan``), and the SSD block
    decomposition ``(L ∘ C Bᵀ) X`` within an SSD chunk.

Both take the initial state ``h0`` from the cache, so a prefill from a
filled state continues it.  Decode keeps a constant-size state: the
last ``d_conv - 1`` inputs of the conv and the SSM state ``h`` (fp32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import dense_init


def _softplus(x):
    """``jax.nn.softplus`` as the reference computes it (logaddexp(x, 0))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _dt_bias_init(n: int):
    """softplus^-1(0.01), n times: the initial dt bias."""
    return torch.log(torch.expm1(torch.full((n,), 0.01)))


def _const(values, lead, device):
    """``values`` broadcast to ``lead + values.shape`` (a fresh tensor)."""
    values = values.to(device)
    return values.expand(tuple(lead) + tuple(values.shape)).clone()


# --------------------------------------------------------------------- #
# causal depthwise conv (kernel size d_conv, shift-based)
# --------------------------------------------------------------------- #

def causal_conv(x, w, b):
    """x: [B, S, C]; w: [K, C]; b: [C].  Multiplies and sums in x.dtype,
    as the reference does."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def conv_step(x_new, conv_state, w, b):
    """One-token conv.  x_new: [B, 1, C]; conv_state: [B, K-1, C] holds the
    previous K-1 inputs.  Sums in fp32.  Returns (y [B, 1, C], new
    state)."""
    full = torch.cat([conv_state, x_new], dim=1)            # [B, K, C]
    y = torch.einsum("bkc,kc->bc", full.float(), w.float()) + b.float()
    return y[:, None, :].to(x_new.dtype), full[:, 1:]


# --------------------------------------------------------------------- #
# Mamba1
# --------------------------------------------------------------------- #

class SSMState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, conv_channels]
    h: torch.Tensor      # mamba1: [B, d_inner, d_state]; mamba2: [B, nh, hd, ds]


def init_mamba1(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    s, d = cfg.ssm, cfg.d_model
    di, ds = s.expand * d, s.d_state
    dt_rank = max(1, (d + 15) // 16)
    kw = dict(lead=lead, device=device)
    # S4D-real initialization of A
    A = torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), d, **kw),
        "conv_w": dense_init(generator, (s.d_conv, di), s.d_conv, **kw),
        "conv_b": _const(torch.zeros(di), lead, device),
        "x_proj": dense_init(generator, (di, dt_rank + 2 * ds), di, **kw),
        "dt_proj": dense_init(generator, (dt_rank, di), dt_rank, **kw),
        "dt_bias": _const(_dt_bias_init(di), lead, device),
        "A_log": _const(torch.log(A), lead, device),
        "D": _const(torch.ones(di), lead, device),
        "out_proj": dense_init(generator, (di, d), di, **kw),
    }


def _linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` (from h = 0) along
    dim 1 in log2 steps, combining as the reference's
    ``lax.associative_scan``: (a_l, b_l) ∘ (a_r, b_r) = (a_r a_l,
    a_r b_l + b_r).  Returns (cumulative a, h)."""
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return a, b


def _mamba1_chunk_scan(x, dt, b_s, c_s, A, h0, chunk: int):
    """The reference's jnp Mamba1 scan.  x/dt: [B, S, di]; b_s/c_s:
    [B, S, ds]; A: [di, ds]; h0: [B, di, ds]; fp32.  Returns (y [B, S, di],
    h_last)."""
    S = x.shape[1]
    pad = (-S) % chunk
    xp, dp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, b_s, c_s))
    h = h0.float()
    ys = []
    for c0 in range(0, S + pad, chunk):
        xc, dc, bc, cc = (t[:, c0:c0 + chunk] for t in (xp, dp, bp, cp))
        a = torch.exp(dc[..., None] * A)                    # [B, K, di, ds]
        b = (dc * xc)[..., None] * bc[:, :, None, :]
        aa, bb = _linear_scan(a, b)
        states = bb + aa * h[:, None]
        ys.append(torch.einsum("bkds,bks->bkd", states, cc))
        h = states[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def _mamba1_inner(x_conv, z, params, cfg: ModelConfig, h0, chunk: int, *,
                  use_kernels: bool = False):
    """x_conv: [B, S, di] post-conv+silu; returns (y [B, S, di], h_last).
    The scan is kernel 4 (through ``kernels/ops.py``) or the reference's
    chunked scan; the D skip and the gate stay here, as in the
    reference's adapter."""
    ds = cfg.ssm.d_state
    dt_rank = params["dt_proj"].shape[0]
    dt = x_conv.dtype
    proj = x_conv @ params["x_proj"].to(dt)
    dt_raw, B_s, C_s = proj.split([dt_rank, ds, ds], dim=-1)
    delta = _softplus((dt_raw @ params["dt_proj"].to(dt)).float()
                      + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                # [di, ds]
    xf = x_conv.float()
    if use_kernels:
        y, h_last = kernel_ops.mamba1_scan(xf, delta, B_s.float(),
                                           C_s.float(), A, h0)
    else:
        y, h_last = _mamba1_chunk_scan(xf, delta, B_s.float(), C_s.float(),
                                       A, h0, chunk)
    y = y + params["D"].float() * xf
    y = y * F.silu(z.float())
    return y.to(dt), h_last


def mamba1_forward(x, params, cfg: ModelConfig, *, state: SSMState = None,
                   use_kernels: bool = False):
    """x: [B, S, d] -> ([B, S, d], new state or None).  With a ``state``
    the scan starts from ``state.h`` (the conv pads with zeros, as the
    reference's does)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    dt = x.dtype
    xz = x @ params["in_proj"].to(dt)
    x_in, z = xz.chunk(2, dim=-1)
    x_conv = causal_conv(x_in, params["conv_w"], params["conv_b"])
    x_conv = F.silu(x_conv.float()).to(dt)
    h0 = torch.zeros((x.shape[0], di, s.d_state), device=x.device) \
        if state is None else state.h.float()
    y, h_last = _mamba1_inner(x_conv, z, params, cfg, h0, s.chunk,
                              use_kernels=use_kernels)
    out = y @ params["out_proj"].to(dt)
    new_state = None
    if state is not None:
        conv = torch.cat([state.conv, x_in.to(state.conv.dtype)],
                         dim=1)[:, -(s.d_conv - 1):]
        new_state = SSMState(conv=conv, h=h_last.to(state.h.dtype))
    return out, new_state


def mamba1_decode(x, params, cfg: ModelConfig, *, state: SSMState):
    """One token: x [B, 1, d]."""
    ds = cfg.ssm.d_state
    dt = x.dtype
    dt_rank = params["dt_proj"].shape[0]
    xz = x @ params["in_proj"].to(dt)
    x_in, z = xz.chunk(2, dim=-1)
    x_c, conv = conv_step(x_in, state.conv, params["conv_w"],
                          params["conv_b"])
    x_c = F.silu(x_c.float())
    proj = x_c.to(dt) @ params["x_proj"].to(dt)
    dt_raw, B_s, C_s = proj.split([dt_rank, ds, ds], dim=-1)
    delta = _softplus((dt_raw @ params["dt_proj"].to(dt)).float()
                      + params["dt_bias"].float())[:, 0]
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(delta[..., None] * A)                     # [B, di, ds]
    b = (delta * x_c[:, 0])[..., None] * B_s[:, 0, None, :].float()
    h = a * state.h.float() + b
    y = torch.einsum("bds,bs->bd", h, C_s[:, 0].float())
    y = y + params["D"].float() * x_c[:, 0]
    y = y * F.silu(z[:, 0].float())
    out = y.to(dt) @ params["out_proj"].to(dt)
    return out[:, None], SSMState(conv=conv.to(state.conv.dtype),
                                  h=h.to(state.h.dtype))


# --------------------------------------------------------------------- #
# Mamba2 / SSD
# --------------------------------------------------------------------- #

def _m2_dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = s.n_heads or di // s.head_dim
    return di, nh, di // nh, s.d_state


def init_mamba2(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    s, d = cfg.ssm, cfg.d_model
    di, nh, hd, ds = _m2_dims(cfg)
    conv_ch = di + 2 * ds
    kw = dict(lead=lead, device=device)
    return {
        "in_proj": dense_init(generator, (d, 2 * di + 2 * ds + nh), d, **kw),
        "conv_w": dense_init(generator, (s.d_conv, conv_ch), s.d_conv, **kw),
        "conv_b": _const(torch.zeros(conv_ch), lead, device),
        "dt_bias": _const(_dt_bias_init(nh), lead, device),
        "A_log": _const(torch.log(torch.linspace(1.0, 16.0, nh)), lead,
                        device),
        "D": _const(torch.ones(nh), lead, device),
        "norm_scale": _const(torch.ones(di), lead, device),  # gated RMSNorm
        "out_proj": dense_init(generator, (di, d), di, **kw),
    }


def _ssd_chunk_scan(xh, dt_h, B_s, C_s, A, h0, chunk: int):
    """SSD block decomposition, the reference's jnp path.

    xh: [B, S, nh, hd]; dt_h: [B, S, nh]; B_s/C_s: [B, S, ds]; A: [nh]
    (negative); h0: [B, nh, hd, ds].  Returns (y [B, S, nh, hd] fp32,
    h_last).  The upper triangle of the decay is masked before ``exp``:
    there ``s_i - s_j`` is positive and can overflow, where the
    reference selects 0 after ``exp``; the values kept are the same."""
    S = xh.shape[1]
    pad = (-S) % chunk
    xp = F.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    dp = F.pad(dt_h.float(), (0, 0, 0, pad))
    bp, cp = (F.pad(t.float(), (0, 0, 0, pad)) for t in (B_s, C_s))
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    h = h0.float()
    ys = []
    for c0 in range(0, S + pad, chunk):
        xc, dc, bc, cc = (t[:, c0:c0 + chunk] for t in (xp, dp, bp, cp))
        s_cum = torch.cumsum(dc * A, dim=1)                 # [B, K, nh]
        scores = torch.einsum("bis,bjs->bij", cc, bc)       # [B, K, K]
        decay = s_cum[:, :, None, :] - s_cum[:, None, :, :]  # [B, i, j, nh]
        decay = decay.masked_fill(~causal[None, :, :, None], float("-inf"))
        M = torch.exp(decay) * dc[:, None, :, :] * scores[..., None]
        y_intra = torch.einsum("bijh,bjhd->bihd", M, xc)
        y_inter = torch.einsum("bis,bhds->bihd", cc, h) \
            * torch.exp(s_cum)[..., None]
        ys.append(y_intra + y_inter)
        tail = torch.exp(s_cum[:, -1:, :] - s_cum) * dc     # [B, K, nh]
        dh = torch.einsum("bjh,bjhd,bjs->bhds", tail, xc, bc)
        h = torch.exp(s_cum[:, -1])[:, :, None, None] * h + dh
    return torch.cat(ys, dim=1)[:, :S], h


def mamba2_forward(x, params, cfg: ModelConfig, *, state: SSMState = None,
                   use_kernels: bool = False):
    """x: [B, S, d] -> ([B, S, d], new state or None); the scan is kernel
    3 (through ``kernels/ops.py``) or the reference's chunked scan."""
    s = cfg.ssm
    di, nh, hd, ds = _m2_dims(cfg)
    dt = x.dtype
    B = x.shape[0]
    proj = x @ params["in_proj"].to(dt)
    z, xBC, dt_raw = proj.split([di, di + 2 * ds, nh], dim=-1)
    xBC = causal_conv(xBC, params["conv_w"], params["conv_b"])
    xBC = F.silu(xBC.float()).to(dt)
    x_in, B_s, C_s = xBC.split([di, ds, ds], dim=-1)
    delta = _softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = x_in.reshape(B, -1, nh, hd)
    h0 = torch.zeros((B, nh, hd, ds), device=x.device) if state is None \
        else state.h.float()
    if use_kernels:
        y, h_last = kernel_ops.ssd_scan(xh.float(), delta, B_s.float(),
                                        C_s.float(), A, h0, chunk=s.chunk)
    else:
        y, h_last = _ssd_chunk_scan(xh, delta, B_s, C_s, A, h0, s.chunk)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, -1, di)
    # gated RMSNorm (mamba2 places the gate inside the norm)
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm_scale"]
    out = y.to(dt) @ params["out_proj"].to(dt)
    new_state = None
    if state is not None:
        # the conv state keeps the conv's inputs, before the conv
        conv = torch.cat([state.conv, proj[..., di:2 * di + 2 * ds].to(
            state.conv.dtype)], dim=1)[:, -(s.d_conv - 1):]
        new_state = SSMState(conv=conv, h=h_last.to(state.h.dtype))
    return out, new_state


def mamba2_decode(x, params, cfg: ModelConfig, *, state: SSMState):
    """One token: x [B, 1, d]."""
    di, nh, hd, ds = _m2_dims(cfg)
    dt = x.dtype
    B = x.shape[0]
    proj = x @ params["in_proj"].to(dt)
    z, xBC, dt_raw = proj.split([di, di + 2 * ds, nh], dim=-1)
    xBC_c, conv = conv_step(xBC, state.conv, params["conv_w"],
                            params["conv_b"])
    xBC_c = F.silu(xBC_c.float())
    x_in, B_s, C_s = xBC_c[:, 0].split([di, ds, ds], dim=-1)
    delta = _softplus(dt_raw[:, 0].float()
                      + params["dt_bias"].float())          # [B, nh]
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(delta * A)                                # [B, nh]
    xh = x_in.reshape(B, nh, hd)
    dh = torch.einsum("bh,bhd,bs->bhds", delta, xh, B_s)
    h = a[:, :, None, None] * state.h.float() + dh
    y = torch.einsum("bhds,bs->bhd", h, C_s)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, di)
    y = y * F.silu(z[:, 0].float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * params["norm_scale"]
    out = y.to(dt) @ params["out_proj"].to(dt)
    return out[:, None], SSMState(conv=conv.to(state.conv.dtype),
                                  h=h.to(state.h.dtype))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, *, lead=(),
                   device="cpu") -> SSMState:
    """Zero decode state; ``lead`` stacking dims come first."""
    s = cfg.ssm
    lead = tuple(lead)
    if s.version == 1:
        di = s.expand * cfg.d_model
        conv_ch, h_shape = di, (di, s.d_state)
    else:
        di, nh, hd, ds = _m2_dims(cfg)
        conv_ch, h_shape = di + 2 * ds, (nh, hd, ds)
    return SSMState(
        conv=torch.zeros(lead + (batch, s.d_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        h=torch.zeros(lead + (batch,) + h_shape, dtype=torch.float32,
                      device=device))
