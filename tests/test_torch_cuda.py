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
def test_flash_kernel_refuses_other_head_dims(cuda_device):
    q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_attention_cuda(q, q, q)


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
# largest output.  Shapes: the reference's dequant test, the micro-bench's
# blocks, a ragged shape, gpt2m's down projection (K = 4096) at 1 sequence
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,blk", [
    (64, 96, 64, 32), (128, 128, 128, 64), (70, 100, 50, 32),
    (192, 192, 192, 64), (1000, 1000, 1000, 128), (1024, 4096, 1024, 128),
    (96, 160, 224, 96)])
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
