"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card.  Every test here is marked ``cuda`` and skips without a
card; this file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.models import Model  # noqa: E402

# bf16 in and out: the kernel and the plain version both accumulate in
# fp32 and round once to bf16, so they differ by about one bf16 ulp of
# O(1) outputs (2^-8) plus summation order.
BF16_ATOL = 2e-2


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
