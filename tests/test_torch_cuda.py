"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card.  Every test here is marked ``cuda`` and skips without a
card; this file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.models import Model  # noqa: E402

# bf16 in and out: the kernel and the plain version both accumulate in
# fp32 and round once to bf16, so they differ by about one bf16 ulp of
# O(1) outputs (2^-8) plus summation order.
BF16_ATOL = 2e-2
# fp32 scans: the kernels against the sequential plain versions.  Over
# up to a few hundred steps, and within chunks of 64 terms, the sums run
# in other orders on states and outputs of O(1) to O(10): atol for the
# O(1) values, rtol for the larger ones.  (Kernel 3 keeps its log-decay
# cumsum in fp64, so large dt |A| costs it no extra error.)
SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-3
# kernel A's backward against its plain version on the same bf16 inputs
# and the same lse: both accumulate in fp32 (in other orders) and round
# dq, dk and dv once to bf16, one ulp of 2^-8 of the value; relative to
# the largest gradient, since dk and dv sum over up to 1024 queries and
# the group's heads
BWD_RTOL = 1e-2
# the logsumexp, fp32 from the same bf16 inputs in both versions
LSE_ATOL = 1e-4
# one reduced-gpt2m train step in bf16, kernel path vs plain path: the
# two round attention outputs and gradients to bf16 at other places; the
# loss to 1e-2 relative, each leaf to a relative L2 error of 0.05 with a
# floor of 1e-3 of the largest gradient (the key bias's gradient is 0 in
# exact arithmetic, so both hold rounding noise there)
TRAIN_LOSS_RTOL, TRAIN_LEAF_REL, TRAIN_LEAF_FLOOR = 1e-2, 0.05, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,causal,window", [
    (1, 16, 16, 16, True, 0), (1, 257, 16, 16, True, 0),
    (4, 128, 16, 16, True, 0), (2, 200, 4, 2, True, 0),
    (1, 300, 4, 4, True, 64), (2, 77, 4, 2, False, 0)])
def test_flash_kernel_matches_plain(cuda_device, B, S, H, KV, causal,
                                    window):
    g = torch.Generator(device=cuda_device).manual_seed(S)
    q, k, v = (torch.randn((B, S, h, 64), generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (H, KV, KV))
    before = tfa.flash_attention_cuda.launches
    got = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_cuda.launches == before + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(8, 64, 32), (1, 257, 4)])
def test_flash_kernel_head_dim_80(cuda_device, B, S, H):
    """zamba2's shared attention: head_dim 2560 / 32 = 80."""
    g = torch.Generator(device=cuda_device).manual_seed(B * S)
    q, k, v = (torch.randn((B, S, H, 80), generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    got = tfa.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dk,dv,B,S,H", [
    (96, 64, 8, 64, 40), (96, 64, 1, 257, 4),
    (192, 128, 8, 64, 16), (192, 128, 1, 257, 4)])
def test_flash_kernel_split_head_dims(cuda_device, dk, dv, B, S, H):
    """Multi-head Latent Attention's pairs, q and k of dk over v of dv
    (MiniCPM3 (96, 64), DeepSeek-V2 (192, 128)): output [B, S, H, dv] and
    the logsumexp, scaled by 1/sqrt(dk), against the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(dk + S)
    q, k = (torch.randn((B, S, H, dk), generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((B, S, H, dv), generator=g, device=cuda_device).to(
        torch.bfloat16)
    got, lse = tfa.flash_attention_cuda(q, k, v, causal=True,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, dv)
    want, want_lse = tfa.flash_attention_plain(q, k, v, causal=True,
                                               return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_ATOL)


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_dims(cuda_device):
    """Head dims kernel A is not built for raise: 112 (96 is since
    phi-3-vision), and q and k of 96 over v of 128."""
    x = torch.zeros((1, 8, 2, 112), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_attention_cuda(x, x, x)
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    v = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match=r"\(96, 128\)"):
        tfa.flash_attention_cuda(q, q, v)


def _scan_close(got, want):
    torch.testing.assert_close(got, want, rtol=SCAN_RTOL, atol=SCAN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,ds", [(8, 64, 8192, 16), (1, 257, 512, 8),
                                       (2, 5, 300, 16)])
def test_mamba1_kernel_matches_plain(cuda_device, B, S, di, ds):
    """Kernel 4 from a non-zero h0, with B and C as strided slices of one
    projection (as an fp32 model hands them); di = 300 leaves a partial
    block."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    dev = cuda_device
    x = torch.randn((B, S, di), generator=g, device=dev)
    dt = torch.rand((B, S, di), generator=g, device=dev) * 0.5
    bc = torch.randn((B, S, 2 * ds + 3), generator=g, device=dev)
    b_s, c_s = bc[..., 3:3 + ds], bc[..., 3 + ds:]
    A = -torch.exp(torch.randn((di, ds), generator=g, device=dev) * 0.5)
    h0 = torch.randn((B, di, ds), generator=g, device=dev)
    before = tms.mamba1_scan_cuda.launches
    y, h = tms.mamba1_scan_cuda(x, dt, b_s, c_s, A, h0)
    torch.cuda.synchronize()
    assert tms.mamba1_scan_cuda.launches == before + 1
    wy, wh = tms.mamba1_scan_plain(x, dt, b_s, c_s, A, h0)
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,dt_scale", [
    (8, 64, 80, 64, 64, 64, 0.1), (1, 257, 80, 64, 64, 64, 0.1),
    (2, 37, 4, 64, 64, 16, 0.5), (1, 128, 80, 64, 64, 64, 4.0)])
def test_ssd_kernel_matches_plain(cuda_device, B, S, nh, hd, ds, chunk,
                                  dt_scale):
    """Kernel 3 from a non-zero h0, reading x, B and C as strided views
    of one conv output (as an fp32 model hands them; a bf16 model's
    ``.float()`` hands contiguous copies).  dt_scale 4 with A down to -16
    makes in-chunk log-decays of thousands: an exp before the mask would
    overflow and give NaN, and an fp32 cumsum would cost ~1e-3 of
    relative error in the decays."""
    g = torch.Generator(device=cuda_device).manual_seed(S + nh)
    dev = cuda_device
    xbc = torch.randn((B, S, nh * hd + 2 * ds), generator=g, device=dev)
    xh = xbc[..., :nh * hd].reshape(B, S, nh, hd)
    b_s, c_s = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:]
    dt = torch.rand((B, S, nh), generator=g, device=dev) * dt_scale
    a = -torch.linspace(1.0, 16.0, nh, device=dev)
    h0 = torch.randn((B, nh, hd, ds), generator=g, device=dev)
    y, h = tms.ssd_scan_cuda(xh, dt, b_s, c_s, a, h0, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    wy, wh = tms.ssd_scan_plain(xh, dt, b_s, c_s, a, h0)
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,Sk", [(16, 16, 1024), (4, 2, 77)])
def test_int8kv_kernel_matches_plain(cuda_device, H, KV, Sk):
    g = torch.Generator(device=cuda_device).manual_seed(Sk)
    B = 8
    q = torch.randn((B, 1, H, 64), generator=g, device=cuda_device)
    kq, ks = tq.quantize(torch.randn((B, Sk, KV, 64), generator=g,
                                     device=cuda_device), block=64)
    vq, vs = tq.quantize(torch.randn((B, Sk, KV, 64), generator=g,
                                     device=cuda_device), block=64)
    fill = torch.as_tensor(np.linspace(1, Sk, B).astype(int),
                           device=cuda_device)
    valid = torch.arange(Sk, device=cuda_device)[None] < fill[:, None]
    args = (q.to(torch.bfloat16), kq, ks[..., 0].contiguous(), vq,
            vs[..., 0].contiguous(), valid)
    got = tq.int8kv_attention_cuda(*args)
    torch.cuda.synchronize()
    want = tq.int8kv_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)


# kernel 5 vs its plain version: the same exact int32 partials and fp32
# accumulation order; only FMA contraction differs, relative to the
# largest output; a rerun gives the same bits (no split-K, no atomics).
# Shapes: the reference's dequant test, the micro-bench's blocks, a
# ragged shape, gpt2m's down projection (K = 4096) at 1 sequence, the
# micro-bench's wide size, and N = 288 and 160, not multiples of the
# kernel's 128-column tile (at blocks 96, a 96-deep K block inside its
# 128-deep stages)
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,blk", [
    (64, 96, 64, 32), (128, 128, 128, 64), (70, 100, 50, 32),
    (192, 192, 192, 64), (1000, 1000, 1000, 128), (1024, 4096, 1024, 128),
    (96, 160, 224, 96), (4096, 4096, 4096, 64), (384, 480, 288, 96),
    (256, 256, 160, 32)])
def test_int8_matmul_kernel_matches_plain(cuda_device, M, K, N, blk):
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=cuda_device)
    w = torch.randn((K, N), generator=g, device=cuda_device)
    x[:blk, :blk] = 0.0                      # an all-zero tile, scale 1.0
    blocks = dict(block_m=blk, block_k=blk, block_n=blk)
    before = tq.int8_matmul_cuda.launches
    got = ops.int8_matmul(x, w, **blocks)
    torch.cuda.synchronize()
    assert tq.int8_matmul_cuda.launches == before + 1
    xq, xs, wq, ws = ops.int8_operands(x, w, **blocks)
    want = tq.int8_matmul_plain(xq, xs, wq, ws, **blocks)[:M, :N]
    assert got.shape == (M, N)
    assert torch.equal(ops.int8_matmul(x, w, **blocks), got)
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    fp32 = x.double() @ w.double()
    assert float(torch.linalg.norm(got.double() - fp32)
                 / torch.linalg.norm(fp32)) < 0.02


@pytest.mark.cuda
def test_int8_matmul_kernel_refuses_bad_blocks(cuda_device):
    xq = torch.zeros((64, 64), dtype=torch.int8, device=cuda_device)
    s = torch.ones((2, 2), device=cuda_device)
    with pytest.raises(ValueError, match="blocks in"):
        tq.int8_matmul_cuda(xq, s, xq, s, block_m=32, block_k=48,
                            block_n=32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_model_kernel_path_matches_plain_path(cuda_device, kv_dtype):
    """Reduced gpt2m in bf16: prefill + two decode steps through the
    kernels against the same model with ``use_kernels=False``."""
    cfg = get_config("gpt2m").reduced()
    fast = Model(cfg, device=cuda_device)
    plain = Model(cfg, device=cuda_device, use_kernels=False)
    params = fast.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(4, 400, (3, 21), device=cuda_device)
    ops.reset_launch_counts()
    logits, fed = {}, []
    for name, m in (("fast", fast), ("plain", plain)):
        cache = m.init_cache(3, 32, kv_dtype=kv_dtype)
        out, cache = m.prefill(params, {"tokens": tokens}, cache)
        steps = [out]
        for i in range(2):
            if name == "fast":   # both paths decode the same tokens
                fed.append(out.argmax(-1)[:, None])
            out, cache = m.decode_step(params, cache, fed[i])
            steps.append(out)
        logits[name] = torch.stack(steps)
    counts = ops.launch_counts()
    assert counts["flash_attn_fwd"] == cfg.n_layers
    assert counts["int8kv_decode"] == (2 * cfg.n_layers
                                       if kv_dtype == "int8" else 0)
    # bf16 activations through two layers: logits of O(1) agree to a
    # few bf16 ulps
    torch.testing.assert_close(logits["fast"], logits["plain"], rtol=0,
                               atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernels", [
    ("falcon-mamba-7b", ("mamba1_scan",)),
    ("zamba2-2.7b", ("ssd_scan", "flash_attn_fwd"))])
def test_ssm_model_kernel_path_matches_plain_path(cuda_device, arch,
                                                  kernels):
    """Reduced falcon-mamba and zamba2 in bf16: prefill + two decode
    steps through the kernels against the same model with
    ``use_kernels=False`` (the reference's chunked scans).  zamba2 keeps
    its served SSM head (head_dim 64, d_state 64), the one shape kernel 3
    takes, with the reduced chunk of 16, so that the 37-token prompt
    carries the state across chunks."""
    cfg = get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=64, d_state=64))
    fast = Model(cfg, device=cuda_device)
    plain = Model(cfg, device=cuda_device, use_kernels=False)
    params = fast.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(4, 400, (3, 37), device=cuda_device)
    ops.reset_launch_counts()
    logits, fed = {}, []
    for name, m in (("fast", fast), ("plain", plain)):
        cache = m.init_cache(3, 48)
        out, cache = m.prefill(params, {"tokens": tokens}, cache)
        steps = [out]
        for i in range(2):
            if name == "fast":
                fed.append(out.argmax(-1)[:, None])
            out, cache = m.decode_step(params, cache, fed[i])
            steps.append(out)
        logits[name] = torch.stack(steps)
    counts = ops.launch_counts()
    for k in kernels:
        assert counts[k] > 0, counts
    torch.testing.assert_close(logits["fast"], logits["plain"], rtol=0,
                               atol=5e-2)


def _bwd_inputs(device, B, S, H, KV, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=g, device=device)
            .to(torch.bfloat16) for h in (H, KV, KV, H)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (1, 37, 4, 4, 64, True, 0), (2, 257, 4, 2, 64, True, 0),
    (1, 257, 4, 4, 80, True, 0), (1, 37, 4, 2, 80, True, 16),
    (1, 257, 2, 2, 64, True, 64), (2, 37, 4, 2, 64, False, 0),
    (8, 1024, 16, 16, 64, True, 0)])
def test_flash_backward_kernel_matches_plain(cuda_device, B, S, H, KV, D,
                                             causal, window):
    q, k, v, do = _bwd_inputs(cuda_device, B, S, H, KV, D, seed=S + D)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    before = tfa.flash_attention_bwd_cuda.launches
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_cuda.launches == before + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_RTOL * float(b.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 257, 4, 2, 64, 0), (2, 130, 32, 32, 80, 0), (1, 300, 4, 4, 64, 64)])
def test_flash_kernel_lse_matches_plain(cuda_device, B, S, H, KV, D,
                                        window):
    q, k, v, _ = _bwd_inputs(cuda_device, B, S, H, KV, D, seed=B * S)
    o, lse = tfa.flash_attention_cuda(q, k, v, causal=True, window=window,
                                      return_lse=True)
    o_serving = tfa.flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    # asking for the logsumexp changes nothing in the output
    torch.testing.assert_close(o, o_serving, rtol=0, atol=0)
    _, want = tfa.flash_attention_plain(q, k, v, causal=True, window=window,
                                        return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=LSE_ATOL)


@pytest.mark.cuda
def test_flash_backward_kernel_refuses_bad_operands(cuda_device):
    q, k, v, do = _bwd_inputs(cuda_device, 1, 16, 2, 2, 64, seed=1)
    o, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="D in"):
        z = torch.zeros((1, 16, 2, 112), dtype=torch.bfloat16,
                        device=cuda_device)
        tfa.flash_attention_bwd_cuda(z, z, z, z, z, lse)
    # 96 has a forward (phi-3-vision) and no backward yet
    with pytest.raises(NotImplementedError, match="queue 2, item 7"):
        z = torch.zeros((1, 16, 2, 96), dtype=torch.bfloat16,
                        device=cuda_device)
        tfa.flash_attention_bwd_cuda(z, z, z, z, z, lse)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention_bwd_cuda(q.float(), k, v, o, do, lse)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse[:, :, :8])
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(q.cpu(), k, v, o, do, lse)


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain_path(cuda_device):
    """One reduced-gpt2m train step in bf16 (its loss and launches, then
    every gradient leaf) through kernel A and its backward, against
    ``use_kernels=False`` (autograd through the plain attention)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.convert import flatten
    from repro_torch.core.steps import build_train_step
    from repro_torch.optim import init_adamw

    cfg = get_config("gpt2m").reduced()
    fast = Model(cfg, device=cuda_device)
    plain = Model(cfg, device=cuda_device, use_kernels=False)
    params = fast.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (4, 128)),
             "labels": rng.integers(4, cfg.vocab_size, (4, 128))}
    out = {}
    ops.reset_launch_counts()
    for name, m in (("fast", fast), ("plain", plain)):
        step = build_train_step(m, TrainConfig())
        _, _, metrics = step(params, init_adamw(params), batch)
        out[name] = float(metrics["loss"])
        if name == "fast":
            counts = ops.launch_counts()
            # remat: each layer's forward runs twice, its backward once
            assert counts["flash_attn_fwd"] == 2 * cfg.n_layers, counts
            assert counts["flash_attn_bwd"] == cfg.n_layers, counts
    assert abs(out["fast"] - out["plain"]) \
        <= TRAIN_LOSS_RTOL * abs(out["plain"])
    from repro_torch.core.steps import value_and_grad
    grads = {name: flatten(value_and_grad(lambda p, b: m.loss(p, b), params,
                                          batch)[2])
             for name, m in (("fast", fast), ("plain", plain))}
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    for key, want in grads["plain"].items():
        got = grads["fast"][key]
        norm = max(float(want.norm()),
                   TRAIN_LEAF_FLOOR * top * want.numel() ** 0.5)
        assert float((got - want).norm()) / norm < TRAIN_LEAF_REL, key


# ------------------------------------------------------------------ #
# slice 5: kernel 6 (RMSNorm), kernels A and B at head_dim 128, the
# gradient guard, and reduced llama3.2 and phi3.5-MoE through the kernels

def _bf16_ulp(x):
    """One bf16 ulp of each entry of an fp32 tensor (8 significant
    bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(8, 3072), (257, 4096), (512, 2560),
                                    (5, 64), (3, 100)])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, d, dtype):
    """Kernel 6 against its plain version on the same inputs: fp32 within
    1e-5 relative to the output's scale (the mean of squares sums in
    another order, rsqrtf is within 2 ulps); bf16 within one ulp of the
    value (the output's rounding may fall either side).  d = 100 takes
    the element-load path."""
    from repro_torch.kernels import rmsnorm as trn

    g = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=g, device=cuda_device) * 3
         + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    before = trn.rmsnorm_cuda.launches
    got = trn.rmsnorm_cuda(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert trn.rmsnorm_cuda.launches == before + 1
    want = trn.rmsnorm_plain(x, w, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        assert bool((err <= _bf16_ulp(want.float())).all())


@pytest.mark.cuda
def test_rmsnorm_kernel_takes_a_strided_row_view(cuda_device):
    """The head normalises ``x[:, last:last + 1]`` of a [B, S, d] tensor:
    rows one stride apart, read in place."""
    from repro_torch.kernels import rmsnorm as trn

    x = torch.randn((4, 9, 3072), device=cuda_device).to(torch.bfloat16)
    w = torch.rand((3072,), device=cuda_device) + 0.5
    sl = x[:, 6:7]
    got = trn.rmsnorm_cuda(sl, w)
    torch.cuda.synchronize()
    want = trn.rmsnorm_plain(sl, w)
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp(want.float())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV", [(8, 64, 24, 8), (1, 257, 24, 8),
                                      (8, 64, 32, 8), (1, 257, 32, 8),
                                      (2, 100, 4, 4)])
def test_flash_kernel_head_dim_128(cuda_device, B, S, H, KV):
    """llama3.2-3b (24 heads over 8, group 3) and phi3.5-MoE (32 over 8,
    group 4) at head_dim 128: kernel A's forward against its plain
    version, and its logsumexp."""
    g = torch.Generator(device=cuda_device).manual_seed(B * S + H)
    q, k, v = (torch.randn((B, S, h, 128), generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (H, KV, KV))
    got, lse = tfa.flash_attention_cuda(q, k, v, causal=True,
                                        return_lse=True)
    torch.cuda.synchronize()
    want, wlse = tfa.flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=LSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV", [(8, 640, 32, 32), (1, 577, 32, 32),
                                      (1, 257, 4, 2)])
def test_flash_kernel_head_dim_96(cuda_device, B, S, H, KV):
    """phi-3-vision-4.2b (32 heads of 96, MHA) at its Engine prefill of
    576 patches and 64 tokens, a ragged prefill, and grouped-query:
    kernel A at (96, 96) against its plain version, and its
    logsumexp."""
    g = torch.Generator(device=cuda_device).manual_seed(B * S + H + 96)
    q, k, v = (torch.randn((B, S, h, 96), generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (H, KV, KV))
    got, lse = tfa.flash_attention_cuda(q, k, v, causal=True,
                                        return_lse=True)
    torch.cuda.synchronize()
    want, wlse = tfa.flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=LSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,Sk", [(24, 8, 1024), (32, 8, 1024),
                                     (4, 1, 77)])
def test_int8kv_kernel_head_dim_128(cuda_device, H, KV, Sk):
    g = torch.Generator(device=cuda_device).manual_seed(Sk + H)
    B = 8
    q = torch.randn((B, 1, H, 128), generator=g, device=cuda_device)
    kq, ks = tq.quantize(torch.randn((B, Sk, KV, 128), generator=g,
                                     device=cuda_device), block=128)
    vq, vs = tq.quantize(torch.randn((B, Sk, KV, 128), generator=g,
                                     device=cuda_device), block=128)
    fill = torch.as_tensor(np.linspace(1, Sk, B).astype(int),
                           device=cuda_device)
    valid = torch.arange(Sk, device=cuda_device)[None] < fill[:, None]
    args = (q.to(torch.bfloat16), kq, ks[..., 0].contiguous(), vq,
            vs[..., 0].contiguous(), valid)
    got = tq.int8kv_attention_cuda(*args)
    torch.cuda.synchronize()
    want = tq.int8kv_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)


@pytest.mark.cuda
def test_kernels_without_backward_refuse_gradients(cuda_device):
    """On real CUDA tensors: every wrapper whose kernel has no backward
    raises when a gradient is being taken, and runs under no_grad;
    kernel A refuses training at head_dim 128."""
    dev = cuda_device

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev).to(dtype).requires_grad_(True)

    kq = torch.zeros((1, 4, 1, 64), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 4, 1), device=dev)
    valid = torch.ones((1, 4), dtype=torch.bool, device=dev)
    calls = {
        "rmsnorm": lambda: ops.rmsnorm(r(3, 64),
                                       torch.ones(64, device=dev)),
        "flash_attention_int8kv": lambda: ops.flash_attention_int8kv(
            r(1, 1, 2, 64, dtype=torch.bfloat16), kq, sc, kq, sc, valid),
        "mamba1_scan": lambda: ops.mamba1_scan(
            r(1, 4, 8), torch.rand(1, 4, 8, device=dev),
            torch.randn(1, 4, 8, device=dev), torch.randn(1, 4, 8, device=dev),
            -torch.ones(8, 8, device=dev), torch.zeros(1, 8, 8, device=dev)),
        "int8_matmul": lambda: ops.int8_matmul(
            r(32, 32), torch.randn(32, 32, device=dev), block_m=32,
            block_k=32, block_n=32),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}.*ROADMAP"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    q = r(1, 16, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.flash_attention(q, q, q)


def _slice5_cfg(arch):
    """Reduced llama3.2 (6 heads over 2: group 3) or phi3.5-MoE (4 heads
    over 1: group 4), at the full models' head_dim of 128."""
    cfg = get_config(arch).reduced()
    heads = (6, 2) if cfg.family == "dense" else (4, 1)
    return dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1],
                               head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_slice5_model_kernel_path_matches_plain_path(cuda_device, arch,
                                                     kv_dtype):
    """Reduced llama3.2 and phi3.5-MoE in bf16 at head_dim 128: prefill +
    two decode steps through kernels 6, A and (int8 KV) B against the
    same model with ``use_kernels=False``."""
    cfg = _slice5_cfg(arch)
    fast = Model(cfg, device=cuda_device)
    plain = Model(cfg, device=cuda_device, use_kernels=False)
    params = fast.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.randint(4, 400, (3, 21), device=cuda_device)
    ops.reset_launch_counts()
    logits, fed = {}, []
    for name, m in (("fast", fast), ("plain", plain)):
        cache = m.init_cache(3, 32, kv_dtype=kv_dtype)
        out, cache = m.prefill(params, {"tokens": tokens}, cache)
        steps = [out]
        for i in range(2):
            if name == "fast":
                fed.append(out.argmax(-1)[:, None])
            out, cache = m.decode_step(params, cache, fed[i])
            steps.append(out)
        logits[name] = torch.stack(steps)
    counts = ops.launch_counts()
    L = cfg.n_layers
    assert counts["flash_attn_fwd"] == L
    assert counts["rmsnorm"] == 3 * (2 * L + 1)
    assert counts["int8kv_decode"] == (2 * L if kv_dtype == "int8" else 0)
    torch.testing.assert_close(logits["fast"], logits["plain"], rtol=0,
                               atol=5e-2)


# Kernel A on the tensor cores: the shapes of the training and serving
# paths, ragged and windowed masks, views of a fused projection, and the
# backward's reruns.  The kernels round P (and, in the backward, dS) to
# bf16 for the products, within the same BF16_ATOL and BWD_RTOL as above.

def _flash_check(q, k, v, causal, window):
    got, lse = tfa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    torch.cuda.synchronize()
    want, wlse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window, return_lse=True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=LSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    pytest.param(8, 1024, 16, 16, 64, True, 0, id="gpt2m-train"),
    pytest.param(2, 1024, 24, 8, 128, True, 0, id="d128-s1024"),
    pytest.param(3, 77, 4, 2, 64, True, 0, id="ragged77"),
    pytest.param(1, 257, 8, 8, 80, True, 0, id="ragged257-d80"),
    pytest.param(1, 257, 6, 2, 128, True, 64, id="ragged257-d128-window64"),
    pytest.param(2, 300, 4, 4, 64, True, 64, id="window64"),
    pytest.param(2, 77, 4, 2, 64, False, 0, id="noncausal77"),
    pytest.param(1, 257, 8, 8, 80, False, 0, id="noncausal257-d80"),
    pytest.param(1, 130, 6, 2, 128, False, 0, id="noncausal130-d128")])
def test_flash_kernel_tensor_core_shapes(cuda_device, B, S, H, KV, D, causal,
                                         window):
    g = torch.Generator(device=cuda_device).manual_seed(S * D + H)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (H, KV, KV))
    _flash_check(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 96, 128])
def test_flash_kernel_reads_views_of_a_fused_projection(cuda_device, D):
    """q, k and v as strided views of one [B, S, 3, H, D] tensor, read in
    place: the kernel's output equals that of contiguous copies."""
    B, S, H = 2, 200, 4
    g = torch.Generator(device=cuda_device).manual_seed(D)
    qkv = torch.randn((B, S, 3, H, D), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _flash_check(q, k, v, True, 0)
    got = tfa.flash_attention_cuda(q, k, v, causal=True)
    same = tfa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, same)


@pytest.mark.cuda
def test_flash_kernel_refuses_unaligned_views(cuda_device):
    x = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention_cuda(*(x[..., 4:] for _ in range(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,window", [(2, 257, 32, 8, 0),
                                             (1, 300, 8, 2, 64)])
def test_flash_backward_kernel_head_dim_80_gqa(cuda_device, B, S, H, KV,
                                               window):
    """The backward at zamba2's head_dim 80 with grouped-query heads
    (groups of 4): dK and dV sum the group's query heads."""
    q, k, v, do = _bwd_inputs(cuda_device, B, S, H, KV, 80, seed=S + H)
    o, lse = tfa.flash_attention_cuda(q, k, v, window=window,
                                      return_lse=True)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= BWD_RTOL * float(b.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D", [(8, 1024, 16, 16, 64),
                                        (1, 257, 8, 2, 80)])
def test_flash_backward_kernel_reruns_bit_equal(cuda_device, B, S, H, KV, D):
    """No atomics: two runs on the same inputs give the same bits."""
    q, k, v, do = _bwd_inputs(cuda_device, B, S, H, KV, D, seed=3)
    o, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True)
    first = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    second = tfa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# kernel B as flash-decoding over whole GQA groups (splits of Sk, tiles
# with no live key skipped, splits merged in order) and kernel 6 with the
# row in registers (a CTA per row)

def _decode_mask(kind, B, Sk, g, device):
    """[B, Sk] key validity: ``dead`` (no row has a live key), ``last``
    (each row's last slot alone), ``random`` (non-prefix rows of rising
    density; row 0 has no live key when B > 1)."""
    if kind == "random":
        dens = torch.linspace(0.1, 0.9, B, device=device)[:, None]
        valid = torch.rand((B, Sk), generator=g, device=device) < dens
        if B > 1:
            valid[0] = False
        return valid
    valid = torch.zeros((B, Sk), dtype=torch.bool, device=device)
    if kind == "last":
        valid[:, -1] = True
    return valid


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["dead", "last", "random"])
@pytest.mark.parametrize("Sk", [1, 77, 104, 296, 1024])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
def test_int8kv_kernel_split_k_masks(cuda_device, group, D, B, Sk, mask):
    """Kernel B against its plain version at head_dim 64, 96
    (phi-3-vision: 24 dim quads over 10 key phases) and 128, at GQA
    groups 1 (gpt2m, phi-3-vision), 3 (llama3.2) and 4 (phi3.5-MoE),
    over 2 kv heads, at the engines'
    cache sizes and 1024 slots (cut in 2 splits on an H100), with rows
    that have no live key (the plain version averages their values), a
    lone live slot at the end, and random non-prefix masks; a rerun gives
    the same bits."""
    KV = 2
    H = group * KV
    g = torch.Generator(device=cuda_device).manual_seed(Sk * 7 + B + group)
    q = torch.randn((B, 1, H, D), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    kq, ks = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    vq, vs = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    args = (q, kq, ks[..., 0].contiguous(), vq, vs[..., 0].contiguous(),
            _decode_mask(mask, B, Sk, g, cuda_device))
    before = tq.int8kv_attention_cuda.launches
    got = tq.int8kv_attention_cuda(*args)
    again = tq.int8kv_attention_cuda(*args)
    torch.cuda.synchronize()
    assert tq.int8kv_attention_cuda.launches == before + 2
    want = tq.int8kv_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["prefix", "dead", "random"])
@pytest.mark.parametrize("tiles_a_split", [1, 2, 3])
def test_int8kv_kernel_forced_splits(cuda_device, monkeypatch, tiles_a_split,
                                     mask):
    """Kernel B with Sk = 1024 forced into splits of 1, 2 or 3 tiles (16,
    8 and 6 splits, the last shorter): most splits of a partly filled
    row hold no live key and must add nothing in the merge, and a row
    with no live key must still average all its values across splits."""
    B, KV, H, D, Sk = 4, 8, 24, 128, 1024
    kps = tiles_a_split * tq.KEY_TILE
    monkeypatch.setattr(tq, "int8kv_splits",
                        lambda *_: (-(-Sk // kps), kps))
    g = torch.Generator(device=cuda_device).manual_seed(tiles_a_split)
    q = torch.randn((B, 1, H, D), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    kq, ks = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    vq, vs = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    if mask == "prefix":
        fill = torch.tensor([17, 100, 290, 1024], device=cuda_device)
        valid = torch.arange(Sk, device=cuda_device)[None] < fill[:, None]
    else:
        valid = _decode_mask("random", B, Sk, g, cuda_device)
        if mask == "dead":
            valid[:] = False
    args = (q, kq, ks[..., 0].contiguous(), vq, vs[..., 0].contiguous(),
            valid)
    got = tq.int8kv_attention_cuda(*args)
    again = tq.int8kv_attention_cuda(*args)
    torch.cuda.synchronize()
    want = tq.int8kv_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ATOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [2560, 3072, 4096])
@pytest.mark.parametrize("rows", [1, 8, 33, 257, 512, 4096])
def test_rmsnorm_kernel_row_counts(cuda_device, rows, d, dtype):
    """Kernel 6 at decode row counts (1, 8, 33) and prefill ones (257,
    512, 4096; at 4096 rows an H100's grid holds fewer CTAs than rows,
    which then walk the rows), at the served widths: fp32 within 1e-5 of
    the largest output, bf16 within one ulp; a rerun gives the same
    bits."""
    from repro_torch.kernels import rmsnorm as trn

    g = torch.Generator(device=cuda_device).manual_seed(rows * 3 + d)
    x = (torch.randn((rows, d), generator=g, device=cuda_device) * 3
         + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    got = trn.rmsnorm_cuda(x, w, eps=1e-5)
    again = trn.rmsnorm_cuda(x, w, eps=1e-5)
    torch.cuda.synchronize()
    want = trn.rmsnorm_plain(x, w, 1e-5)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        assert bool((err <= _bf16_ulp(want.float())).all())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 300])
@pytest.mark.parametrize("d", [3072, 8192])
def test_rmsnorm_kernel_strided_rows(cuda_device, rows, d):
    """Rows two widths apart (``x[:, 1]`` of [rows, 2, d]), read in place
    at 8 and 300 rows, at llama3.2's width and at the widest a CTA holds
    (where an H100's grid holds 264 CTAs, so 300 rows are walked)."""
    from repro_torch.kernels import rmsnorm as trn

    x = torch.randn((rows, 2, d), device=cuda_device).to(torch.bfloat16)
    w = torch.rand((d,), device=cuda_device) + 0.5
    sl = x[:, 1]
    got = trn.rmsnorm_cuda(sl, w)
    torch.cuda.synchronize()
    want = trn.rmsnorm_plain(sl, w)
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp(want.float())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [6144, 8192, 12290, 16384, 32768])
@pytest.mark.parametrize("rows", [1, 8, 300])
def test_rmsnorm_kernel_wide_rows(cuda_device, rows, d, dtype):
    """Rows past the served widths, up to MAX_D (32768): CTAs of 768 and
    1024 threads, 8 elements each, then 2 groups of 8 a thread (12290 on
    single elements, llama3-405b's 16384 on vectors) and 4 (32768); the
    same gates."""
    from repro_torch.kernels import rmsnorm as trn

    g = torch.Generator(device=cuda_device).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=g, device=cuda_device) * 3
         + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    got = trn.rmsnorm_cuda(x, w, eps=1e-5)
    torch.cuda.synchronize()
    want = trn.rmsnorm_plain(x, w, 1e-5)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * float(want.abs().max())
    else:
        assert bool((err <= _bf16_ulp(want.float())).all())


def _ssd_inputs(B, S, nh, dt_scale, seed, dev):
    """zamba2's SSM head (64 columns, 64 states) from a non-zero h0, x, B
    and C as strided views of one conv output."""
    hd = ds = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn((B, S, nh * hd + 2 * ds), generator=g, device=dev)
    xh = xbc[..., :nh * hd].reshape(B, S, nh, hd)
    b_s, c_s = xbc[..., nh * hd:nh * hd + ds], xbc[..., nh * hd + ds:]
    dt = torch.rand((B, S, nh), generator=g, device=dev) * dt_scale
    a = -torch.linspace(1.0, 16.0, nh, device=dev)
    h0 = torch.randn((B, nh, hd, ds), generator=g, device=dev)
    return xh, dt, b_s, c_s, a, h0


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [1, 16, 63, 65, 136, 257])
@pytest.mark.parametrize("B", [1, 8])
def test_ssd_kernel_forced_plans(cuda_device, monkeypatch, B, S, chunk,
                                 stages):
    """Kernel 3 at zamba2's 80 heads with each of ``ssd_plan``'s choices,
    one or two stages, forced, over whole, partial and single-row chunks
    of 16 and 64; within the scan tolerance of the plain version, finite,
    and a rerun gives the same bits."""
    nh = 80
    monkeypatch.setattr(tms, "ssd_plan", lambda *_: stages)
    args = _ssd_inputs(B, S, nh, 0.1, S * 3 + B, cuda_device)
    y, h = tms.ssd_scan_cuda(*args, chunk=chunk)
    y2, h2 = tms.ssd_scan_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    wy, wh = tms.ssd_scan_plain(*args)
    _scan_close(y, wy)
    _scan_close(h, wh)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [1, 2])
def test_ssd_kernel_large_decays_each_staging(cuda_device, monkeypatch,
                                              stages):
    """dt up to 4 with A down to -16 (in-chunk log-decays of thousands)
    over two chunks, staged in one or two stages: masked before the
    exponential, s in fp64."""
    B, S, nh = 1, 128, 80
    monkeypatch.setattr(tms, "ssd_plan", lambda *_: stages)
    args = _ssd_inputs(B, S, nh, 4.0, 16 * stages, cuda_device)
    y, h = tms.ssd_scan_cuda(*args, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    wy, wh = tms.ssd_scan_plain(*args)
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", tms.MAMBA1_LANES)
@pytest.mark.parametrize("di", [300, 8192])
@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("S", [1, 16, 257])
@pytest.mark.parametrize("B", [1, 8])
def test_mamba1_kernel_forced_lanes(cuda_device, monkeypatch, B, S, ds, di,
                                    lanes):
    """Kernel 4 with each of ``mamba1_plan``'s lanes a channel forced
    (tiles of 32 or 64 steps; a partial channel block at di = 300), from
    a non-zero h0 with B and C as strided slices of one projection;
    within the scan tolerance of the plain version, and a rerun gives the
    same bits."""
    monkeypatch.setattr(tms, "mamba1_plan", lambda *_: lanes)
    g = torch.Generator(device=cuda_device).manual_seed(S + di + lanes)
    dev = cuda_device
    x = torch.randn((B, S, di), generator=g, device=dev)
    dt = torch.rand((B, S, di), generator=g, device=dev) * 0.5
    bc = torch.randn((B, S, 2 * ds + 3), generator=g, device=dev)
    b_s, c_s = bc[..., 3:3 + ds], bc[..., 3 + ds:]
    A = -torch.exp(torch.randn((di, ds), generator=g, device=dev) * 0.5)
    h0 = torch.randn((B, di, ds), generator=g, device=dev)
    args = (x, dt, b_s, c_s, A, h0)
    y, h = tms.mamba1_scan_cuda(*args)
    y2, h2 = tms.mamba1_scan_cuda(*args)
    torch.cuda.synchronize()
    wy, wh = tms.mamba1_scan_plain(*args)
    _scan_close(y, wy)
    _scan_close(h, wh)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_mamba1_kernel_unaligned_rows(cuda_device):
    """x and dt views that start one float past a 16-byte boundary: the
    wrapper copies them for the kernel's 16-byte copies, with the same
    results."""
    B, S, di, ds = 2, 40, 256, 16
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((B * S * di + 1,), generator=g, device=dev)[1:] \
        .view(B, S, di)
    dt = (torch.rand((B * S * di + 1,), generator=g, device=dev)[1:] * 0.3) \
        .view(B, S, di)
    b_s = torch.randn((B, S, ds), generator=g, device=dev)
    c_s = torch.randn((B, S, ds), generator=g, device=dev)
    A = -torch.exp(torch.randn((di, ds), generator=g, device=dev) * 0.5)
    h0 = torch.randn((B, di, ds), generator=g, device=dev)
    y, h = tms.mamba1_scan_cuda(x, dt, b_s, c_s, A, h0)
    torch.cuda.synchronize()
    wy, wh = tms.mamba1_scan_plain(x, dt, b_s, c_s, A, h0)
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
def test_ssd_kernel_unaligned_views(cuda_device):
    """x, B and C views whose rows are off 16-byte boundaries (one float
    in, odd row strides): the wrapper copies them for the kernel's bulk
    row copies, with the same results."""
    B, S, nh, hd, ds = 2, 70, 4, 64, 64
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(11)
    xbc = torch.randn((B, S, 1 + nh * hd + 2 * ds + 1), generator=g,
                      device=dev)
    xh = xbc[..., 1:1 + nh * hd].reshape(B, S, nh, hd)
    b_s = xbc[..., 1 + nh * hd:1 + nh * hd + ds]
    c_s = xbc[..., 1 + nh * hd + ds:1 + nh * hd + 2 * ds]
    dt = torch.rand((B, S, nh), generator=g, device=dev) * 0.3
    a = -torch.linspace(1.0, 16.0, nh, device=dev)
    h0 = torch.randn((B, nh, hd, ds), generator=g, device=dev)
    y, h = tms.ssd_scan_cuda(xh, dt, b_s, c_s, a, h0, chunk=64)
    torch.cuda.synchronize()
    wy, wh = tms.ssd_scan_plain(xh, dt, b_s, c_s, a, h0)
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,split", [("1f1b", None),
                                            ("interleaved", (2, 1))])
def test_pipeshard_step_on_card(cuda_device, schedule, split):
    """One reduced-gpt2m pipeshard step on a (1, 1, 1) staged mesh over
    NCCL (a world of one, made in-process): kernel A 2·L·m forward and
    L·m backward launches (remat), the loss within 1e-2 of the one-device
    step's, no send at one stage."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.optim import init_adamw

    cfg = dataclasses.replace(get_config("gpt2m").reduced(), n_layers=3)
    tcfg = TrainConfig(microbatches=2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64))
    batch = {k: torch.as_tensor(tokens, device=cuda_device)
             for k in ("tokens", "labels")}

    def fresh(model):
        return model.init(torch.Generator(device="cuda").manual_seed(0))

    model = Model(cfg, device="cuda")
    params = fresh(model)
    _, _, want = build_train_step(model, tcfg)(params, init_adamw(params),
                                               batch)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1,
                                  stage_layers=split, schedule=schedule)
        model = Model(cfg, device="cuda")
        step = build_train_step(model, tcfg, plan="pipeshard", mesh=mesh,
                                stage_layers=split, schedule=schedule)
        params = step.shard_params(fresh(model))
        ops.reset_launch_counts()
        sharding.reset_collective_counts()
        _, _, got = step(params, step.init_opt_state(), batch)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert sharding.collective_counts()["send"]["calls"] == 0
    finally:
        dist.destroy_process_group()
    L, m = cfg.n_layers, tcfg.microbatches
    assert counts["flash_attn_fwd"] == 2 * L * m
    assert counts["flash_attn_bwd"] == L * m
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["dead", "last", "random"])
@pytest.mark.parametrize("tiles_a_split", [0, 1, 3])
@pytest.mark.parametrize("D,group", [(64, 1), (128, 3)])
def test_int8kv_kernel_lse(cuda_device, monkeypatch, D, group, tiles_a_split,
                           mask):
    """Kernel B's log-sum-exp of each (row, head)'s live scores against
    the plain version's, with one split (``tiles_a_split`` 0: the
    planner's, one split at 296 slots) and forced splits of 1 and 3
    tiles (the merge writes it): -inf on a row with no live key, the
    output the same bits as without the lse."""
    B, KV, Sk = 4, 2, 296
    H = group * KV
    if tiles_a_split:
        kps = tiles_a_split * tq.KEY_TILE
        monkeypatch.setattr(tq, "int8kv_splits",
                            lambda *_: (-(-Sk // kps), kps))
    g = torch.Generator(device=cuda_device).manual_seed(D + tiles_a_split)
    q = torch.randn((B, 1, H, D), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    kq, ks = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    vq, vs = tq.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device=cuda_device), block=D)
    args = (q, kq, ks[..., 0].contiguous(), vq, vs[..., 0].contiguous(),
            _decode_mask(mask, B, Sk, g, cuda_device))
    o, lse = tq.int8kv_attention_cuda(*args, with_lse=True)
    plain = tq.int8kv_attention_cuda(*args)
    want_o, want = tq.int8kv_attention_plain(*args, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, plain)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0,
                               atol=BF16_ATOL)
    dead = ~args[-1].any(-1)
    assert torch.isneginf(lse[dead]).all()
    assert torch.isfinite(lse[~dead]).all()
    torch.testing.assert_close(lse[~dead], want[~dead], rtol=0,
                               atol=LSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_engine_under_shard_at_a_world_of_one_matches_one_device(
        cuda_device, kv_dtype):
    """Reduced gpt2m through ``Engine`` under shard on an NCCL world of
    one (the merge of one block, kernel B with its lse for the int8
    cache): the one-device engine's tokens, kernel A once a layer a
    prefill and kernel B once a layer a decode step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Engine

    cfg = get_config("gpt2m").reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(4, cfg.vocab_size, (4, 16))}
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    want = Engine(model, batch_size=4, max_len=32,
                  kv_dtype=kv_dtype).generate(params, batch, 6)["tokens"]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        eng = Engine(model, batch_size=4, max_len=32, kv_dtype=kv_dtype,
                     plan="shard",
                     mesh=make_host_mesh((1, 1, 1), ("pod", "data", "model")))
        ops.reset_launch_counts()
        got = eng.generate(eng.shard_params(params), batch, 6)["tokens"]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    assert counts["flash_attn_fwd"] == cfg.n_layers
    assert counts["int8kv_decode"] == \
        (cfg.n_layers * 5 if kv_dtype == "int8" else 0)
