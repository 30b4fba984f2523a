"""Direct (materialized-score) oracles, port of ``repro/kernels/ref.py``:
the slow, obviously right versions the kernels' plain versions are held
against."""
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
