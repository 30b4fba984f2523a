"""Direct (materialized-score, sequential-recurrence) oracles, port of
``repro/kernels/ref.py``: the slow, obviously right versions.  The
attention kernels' plain versions are held against them; the scans'
plain versions are these recurrences, started from a given state; the
int8 matmul is held to the fp32 product; the RMSNorm is its own
oracle, as in the reference."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, H, Sq, D]; k/v: [B, KV, Sk, D*]; returns [B, H, Sq, Dv] in
    q.dtype."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    group = H // KV
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / (D ** 0.5)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window:
        mask &= (qi - kj) < window
    s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)


def int8kv_attention_ref(q, k_q, k_scale, v_q, v_scale, valid):
    """Dequantize-then-attend oracle in the [B, H, S, D] layout.
    q: [B, H, Sq, D]; k_q/v_q: [B, KV, Sk, D] int8; k_scale/v_scale:
    [B, KV, Sk] fp32; valid: [B, Sk].  Non-causal."""
    B, H, Sq, D = q.shape
    group = H // k_q.shape[1]
    k = (k_q.float() * k_scale[..., None]).repeat_interleave(group, dim=1)
    v = (v_q.float() * v_scale[..., None]).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / (D ** 0.5)
    s = s.masked_fill(~valid.bool()[:, None, None, :], -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v).to(q.dtype)


def ssd_ref(xh, dt, b_s, c_s, a, h0=None):
    """Sequential (per-token) SSD recurrence, the slow trusted path.
    xh: [B, nh, S, hd]; dt: [B, nh, S]; b_s/c_s: [B, S, ds]; a: [nh];
    h0: [B, nh, hd, ds] or None (zeros, as the reference's oracle).
    Returns (y [B, nh, S, hd] fp32, h_last [B, nh, hd, ds] fp32)."""
    B, nh, S, hd = xh.shape
    ds = b_s.shape[-1]
    xh, dt, b_s, c_s = (t.float() for t in (xh, dt, b_s, c_s))
    h = torch.zeros((B, nh, hd, ds), device=xh.device) if h0 is None \
        else h0.float().clone()
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, :, t] * a)                     # [B, nh]
        dx = dt[:, :, t, None] * xh[:, :, t]                   # [B, nh, hd]
        h = decay[..., None, None] * h \
            + dx[..., None] * b_s[:, None, t, None, :]
        ys.append(torch.einsum("bhds,bs->bhd", h, c_s[:, t]))
    return torch.stack(ys, dim=2), h


def mamba1_ref(x, dt, b_s, c_s, A, h0=None):
    """Sequential mamba1 recurrence.  x/dt: [B, S, di]; b_s/c_s:
    [B, S, ds]; A: [di, ds]; h0: [B, di, ds] or None (zeros, as the
    reference's oracle).  Returns (y [B, S, di] fp32, h_last [B, di, ds])."""
    B, S, di = x.shape
    ds = b_s.shape[-1]
    x, dt, b_s, c_s = (t.float() for t in (x, dt, b_s, c_s))
    h = torch.zeros((B, di, ds), device=x.device) if h0 is None \
        else h0.float().clone()
    ys = []
    for t in range(S):
        a_t = torch.exp(dt[:, t, :, None] * A)                 # [B, di, ds]
        h = a_t * h + (dt[:, t] * x[:, t])[..., None] * b_s[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_s[:, t]))
    return torch.stack(ys, dim=1), h


def rmsnorm_ref(x, weight, *, eps: float = 1e-5):
    """Reference RMSNorm (the same math as ``models/layers.rmsnorm``):
    the oracle of kernel 6."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def matmul_ref(x, w):
    """fp32 reference matmul: the accuracy oracle for the int8 blocked
    matmul (kernel 5)."""
    return torch.matmul(x.float(), w.float())
