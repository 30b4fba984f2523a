"""Kernels of the PyTorch port against the JAX reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions to the reference's Pallas kernels (in
interpret mode), its direct oracles and its jnp ``chunked_attention``,
on the same numpy inputs, in fp32.  ``test_torch_cuda.py`` holds the
CUDA kernels to these plain versions on a card.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quantized as jq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

# fp32 on both sides; the sums run in other orders (chunked online
# softmax vs materialized scores), so agreement is to fp32 rounding of
# O(1) values over a few hundred terms.
ATOL = 2e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# (B, Sq, H, KV, causal, window): ragged lengths, GQA group 2, a window
FLASH_CASES = [
    pytest.param(2, 37, 4, 4, True, 0, id="causal-ragged37"),
    pytest.param(1, 64, 4, 2, True, 0, id="causal-gqa2"),
    pytest.param(2, 50, 4, 4, True, 16, id="causal-window16"),
    pytest.param(1, 40, 4, 2, False, 0, id="noncausal-pad40-gqa2"),
]


@pytest.mark.parametrize("B,S,H,KV,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference(B, S, H, KV, causal, window):
    """Kernel A's plain version (small chunks, so the online softmax
    crosses chunk edges) against the Pallas kernel in interpret mode
    (16-wide blocks: S pads, so the kernel's key pad mask is live), the jnp
    ``chunked_attention`` and the direct oracle."""
    rng = np.random.default_rng(S + 7 * H + KV)
    q, k, v = (_rand(rng, (B, S, h, 64)) for h in (H, KV, KV))
    got = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, q_chunk=16, k_chunk=24)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, block_q=16, block_k=16,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
    direct = jref.attention_ref(*(jnp.asarray(x.transpose(0, 2, 1, 3))
                                  for x in (q, k, v)),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(direct).transpose(0, 2, 1, 3),
                               atol=ATOL)
    if causal:   # the jnp path applies the window only under causal
        chunked = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, q_chunk=16,
                            k_chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(chunked),
                                   atol=ATOL)


def test_flash_plain_with_positions_matches_chunked():
    """Explicit (offset) positions take the position mask of the jnp
    path; the plain version keeps it."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, (2, 20, 4, 64)) for _ in range(3))
    pos = np.broadcast_to(np.arange(20, dtype=np.int32)[None] + 5, (2, 20))
    want = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_positions=jnp.asarray(pos),
                     kv_positions=jnp.asarray(pos), window=6)
    got = tfa.flash_attention_plain(_t(q), _t(k), _t(v), window=6,
                                    q_positions=_t(pos),
                                    kv_positions=_t(pos), q_chunk=8,
                                    k_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_port_attention_ref_matches_reference_ref(causal, window):
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, (2, 4, 9, 64)), _rand(rng, (2, 2, 9, 64)), \
        _rand(rng, (2, 2, 9, 64))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window)
    got = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ops_flash_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(9)
    q, k, v = (_t(_rand(rng, (1, 33, 4, 64))) for _ in range(3))
    tops.reset_launch_counts()
    got = tops.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    counts = tops.launch_counts()
    assert set(counts) == {"flash_attn_fwd", "flash_attn_bwd",
                           "int8kv_decode", "ssd_scan", "mamba1_scan",
                           "int8_matmul", "rmsnorm"}
    assert not any(counts.values())


def test_ops_reject_other_devices():
    """A tensor on neither the CPU, a card nor the meta device (where the
    dry run takes each kernel's shape rule) has no version to run: a
    stand-in on an XLA device, which this build cannot allocate."""
    from types import SimpleNamespace
    q = SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.flash_attention(q, q, q)


# ------------------------------------------------------------------ #
# int8 quantization: bit-equal with the reference
@pytest.mark.parametrize("shape,block,axis", [
    ((3, 17, 4, 64), 64, -1),       # the KV cache's per-(token, head) use
    ((6, 70), 32, -1),               # ragged last block
    ((40, 3, 5), 16, 0),             # a non-last axis
])
def test_quantize_bit_equal(shape, block, axis):
    rng = np.random.default_rng(len(shape) * block)
    x = _rand(rng, shape) * 3.0
    flat = x.reshape(-1)
    flat[:block] = 0.0                                  # an all-zero block
    flat[block:block + 8] = np.float32(0.5) * np.arange(8)  # round-half ties
    x = flat.reshape(shape)
    jq, js = jops.quantize(jnp.asarray(x), block=block, axis=axis)
    tq_, ts = tq.quantize(_t(x), block=block, axis=axis)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jops.dequantize(jq, js, block=block, axis=axis)
    td = tq.dequantize(tq_, ts, block=block, axis=axis)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _int8_inputs(rng, B, Sq, H, KV, Sk, fill):
    q = _rand(rng, (B, Sq, H, 64))
    kq, ks = jops.quantize(jnp.asarray(_rand(rng, (B, Sk, KV, 64))),
                           block=64)
    vq, vs = jops.quantize(jnp.asarray(_rand(rng, (B, Sk, KV, 64))),
                           block=64)
    valid = np.arange(Sk)[None, :] < np.asarray(fill)[:, None]
    return (q, np.asarray(kq), np.asarray(ks)[..., 0], np.asarray(vq),
            np.asarray(vs)[..., 0], valid)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_int8kv_plain_matches_reference(H, KV):
    """Kernel B's plain version against the Pallas int8-KV kernel in
    interpret mode (as the reference's decode calls it: causal=False,
    block_q=8) with a partly filled ``valid`` mask per row, and against
    the dequantize-then-attend oracle."""
    rng = np.random.default_rng(H * 10 + KV)
    q, kq, ks, vq, vs, valid = _int8_inputs(rng, 3, 1, H, KV, 40,
                                            fill=[40, 17, 1])
    want = jops.flash_attention_int8kv(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), valid=jnp.asarray(valid, jnp.float32),
        causal=False, block_q=8, interpret=True)
    got = tq.int8kv_attention_plain(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                    _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    oracle = tref.int8kv_attention_ref(
        _t(q).transpose(1, 2), _t(kq).transpose(1, 2),
        _t(ks).transpose(1, 2), _t(vq).transpose(1, 2),
        _t(vs).transpose(1, 2), _t(valid))
    np.testing.assert_allclose(got.numpy(),
                               oracle.transpose(1, 2).numpy(), atol=ATOL)
    # the masked tail is really out: row 2 sees key 0 alone
    np.testing.assert_allclose(
        got.numpy()[2, 0, :2],
        (vq[2, 0, :KV].astype(np.float32)
         * vs[2, 0, :KV, None]).repeat(H // KV, axis=0)[:2], atol=ATOL)


# ------------------------------------------------------------------ #
# kernel 5: the blocked int8 matmul
@pytest.mark.parametrize("M,K,br,bc", [(64, 96, 32, 32), (128, 256, 64, 128),
                                       (192, 128, 96, 32)])
def test_quantize_blocks_bit_equal(M, K, br, bc):
    """Payloads and scales bit-equal to the reference's
    ``quantize_blocks``, with an all-zero tile (scale 1.0), round-half
    ties and magnitudes far from 1."""
    rng = np.random.default_rng(M + K)
    x = _rand(rng, (M, K)) * np.float32(10.0 ** rng.uniform(-3, 3))
    x[:br, :bc] = 0.0
    x[br, :8] = np.float32(0.5) * np.arange(8)
    jqx, jsx = jq.quantize_blocks(jnp.asarray(x), br, bc)
    tqx, tsx = tq.quantize_blocks(_t(x), br, bc)
    assert tqx.dtype == torch.int8 and tsx.dtype == torch.float32
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    assert tsx[0, 0] == 1.0


# (M, K, N, block): the reference's dequant test, the micro-bench's
# blocks, and a ragged shape whose every axis pads
MM_CASES = [(64, 96, 64, 32), (128, 128, 128, 64), (70, 100, 50, 32)]


@pytest.mark.parametrize("M,K,N,blk", MM_CASES)
def test_int8_matmul_matches_reference(M, K, N, blk):
    """``ops.int8_matmul`` on CPU tensors (the plain version) against the
    reference's Pallas kernel in interpret mode, within the reference's
    own envelope, and within its 2% Frobenius gate of the fp32 product."""
    rng = np.random.default_rng(2 + M)
    x, w = _rand(rng, (M, K)), _rand(rng, (K, N))
    blocks = dict(block_m=blk, block_k=blk, block_n=blk)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True, **blocks))
    tops.reset_launch_counts()
    got = tops.int8_matmul(_t(x), _t(w), **blocks)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert tops.launch_counts()["int8_matmul"] == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    fp32 = tref.matmul_ref(_t(x), _t(w)).numpy()
    assert np.linalg.norm(got.numpy() - fp32) / np.linalg.norm(fp32) < 0.02


def test_int8_matmul_plain_dequantizes_per_k_block():
    """The plain version equals the quantized operands dequantized tile
    by tile and multiplied in fp32: scales apply per K block, not once
    at the end (the reference's explicit-dequant test)."""
    rng = np.random.default_rng(3)
    x, w = _t(_rand(rng, (64, 96))), _t(_rand(rng, (96, 64)))
    xq, xs = tq.quantize_blocks(x, 32, 32)
    wq, ws = tq.quantize_blocks(w, 32, 32)
    got = tq.int8_matmul_plain(xq, xs, wq, ws, block_m=32, block_k=32,
                               block_n=32)
    xd = xq.float().reshape(2, 32, 3, 32) * xs[:, None, :, None]
    wd = wq.float().reshape(3, 32, 2, 32) * ws[:, None, :, None]
    want = xd.reshape(64, 96) @ wd.reshape(96, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("blocks", [dict(block_m=16), dict(block_k=48),
                                    dict(block_n=256), dict(block_m=0)])
def test_int8_matmul_rejects_other_blocks(blocks):
    x = torch.zeros((64, 64))
    with pytest.raises(ValueError, match="blocks in"):
        tops.int8_matmul(x, x, **blocks)
    with pytest.raises(ValueError, match="blocks in"):
        tq.int8_matmul_cuda(x.to(torch.int8), x, x.to(torch.int8), x,
                            **{"block_m": 32, "block_k": 32, "block_n": 32,
                               **blocks})


def test_int8_matmul_cuda_refuses_cpu_tensors():
    xq = torch.zeros((32, 32), dtype=torch.int8)
    s = torch.ones((1, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.int8_matmul_cuda(xq, s, xq, s, block_m=32, block_k=32,
                            block_n=32)


def test_int8_matmul_promotion_identity_is_exact():
    """Kernel 5 turns each K block's int32 partial v into fp32 with an
    integer add and an fp32 add, not a conversion:
    ``__int_as_float(v + 0x4B400000) - 12582912.0f``.  For every v a
    partial can take, |v| <= 127 * 127 * 128 (blocks of up to 128), that
    is v as fp32 bit for bit; just past |v| = 2^22 it is not.  The two
    constants are read from the kernel's source."""
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    magic_i = int(re.search(r"MAGIC_I = (0x[0-9A-Fa-f]+);", src).group(1), 16)
    magic_f = float(re.search(r"MAGIC_F = ([0-9.]+)f;", src).group(1))

    def promote(v):
        bits = (v + magic_i).to(torch.int32)
        return bits.view(torch.float32) - torch.tensor(magic_f)

    lim = 127 * 127 * 128
    v = torch.arange(-lim, lim + 1, dtype=torch.int32)
    got = promote(v)
    assert torch.equal(got.view(torch.int32), v.float().view(torch.int32))
    past = torch.tensor([2 ** 22 + 1, -(2 ** 22) - 1], dtype=torch.int32)
    assert not (promote(past) == past.float()).any()


# ------------------------------------------------------------------ #
# kernel 6: the row RMSNorm

def _bf16_ulp(x):
    """One bf16 ulp of each entry of an fp32 array (8 significant bits;
    zero and subnormals take the smallest normal's ulp)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(257, 64), (257, 3072), (3, 64)])
def test_rmsnorm_plain_matches_reference(rows, d, dtype):
    """The port's ``rmsnorm`` (``models/layers.rmsnorm``, kernel 6's plain
    twin) and ``ops.rmsnorm`` on CPU tensors against the reference's
    Pallas kernel in interpret mode (257 rows: not a multiple of its
    256-row blocks, so it pads) and ``ref.rmsnorm_ref``, from the same
    inputs: within 1e-5 in fp32 (the mean of squares sums in other
    orders), within one bf16 ulp of the value in bf16 (the rounding of
    the output can fall on either side of an fp32 difference)."""
    rng = np.random.default_rng(rows + d)
    x = (_rand(rng, (rows, d)) * 3.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * _rand(rng, (d,))).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    want = {"pallas": jops.rmsnorm(jx, jnp.asarray(w), eps=1e-5,
                                   interpret=True),
            "ref": jref.rmsnorm_ref(jx, jnp.asarray(w), eps=1e-5)}
    tops.reset_launch_counts()
    got = {"plain": tlayers.rmsnorm(tx, _t(w), 1e-5),
           "ops": tops.rmsnorm(tx, _t(w), eps=1e-5),
           "port ref": tref.rmsnorm_ref(tx, _t(w), eps=1e-5)}
    assert tops.launch_counts()["rmsnorm"] == 0
    assert tlayers.rmsnorm is trn.rmsnorm_plain
    for gname, g in got.items():
        assert g.dtype == tx.dtype and g.shape == tx.shape, gname
        gf = g.float().numpy()
        for wname, wv in want.items():
            wf = np.asarray(wv.astype(jnp.float32))
            tol = 1e-5 if dtype == "float32" else _bf16_ulp(wf)
            assert np.all(np.abs(gf - wf) <= tol), (gname, wname)


def test_apply_norm_routes_rmsnorm_through_ops():
    """``use_kernels`` sends RMSNorm through ``ops.rmsnorm`` (on the CPU,
    the plain version: the same values); LayerNorm keeps its own path."""
    rng = np.random.default_rng(11)
    x = _t(_rand(rng, (2, 5, 64)))
    p = {"scale": _t(1.0 + _rand(rng, (64,))), "bias": _t(_rand(rng, (64,)))}
    calls = []
    orig = tops.rmsnorm

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tops.rmsnorm = spy
    try:
        got = tlayers.apply_norm(x, p, "rmsnorm", 1e-5, use_kernels=True)
        plain = tlayers.apply_norm(x, p, "rmsnorm", 1e-5)
        ln = tlayers.apply_norm(x, p, "layernorm", 1e-5, use_kernels=True)
    finally:
        tops.rmsnorm = orig
    assert len(calls) == 1
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    torch.testing.assert_close(
        ln, tlayers.layernorm(x, p["scale"], p["bias"]), rtol=0, atol=0)


def test_rmsnorm_cuda_refuses_cpu_tensors():
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm_cuda(x, torch.ones(64))


# ------------------------------------------------------------------ #
# kernels without a backward refuse a gradient on the card

def _no_backward_calls():
    """(name, stub target, call) for every wrapper whose CUDA kernel has
    no backward, at tiny shapes; each call is made with grad-requiring
    inputs."""
    def r(*shape):
        return torch.randn(*shape, requires_grad=True)
    kq = torch.zeros((1, 4, 1, 64), dtype=torch.int8)
    sc = torch.ones((1, 4, 1))
    valid = torch.ones((1, 4), dtype=torch.bool)
    return [
        ("rmsnorm", (trn, "rmsnorm_cuda"),
         lambda: tops.rmsnorm(r(3, 64), torch.ones(64))),
        ("rmsnorm", (trn, "rmsnorm_cuda"),
         lambda: tops.rmsnorm(torch.randn(3, 64), r(64))),
        ("flash_attention_int8kv", (tq, "int8kv_attention_cuda"),
         lambda: tops.flash_attention_int8kv(r(1, 1, 2, 64), kq, sc, kq, sc,
                                             valid)),
        ("mamba1_scan", (tms, "mamba1_scan_cuda"),
         lambda: tops.mamba1_scan(r(1, 4, 8), torch.rand(1, 4, 8),
                                  torch.randn(1, 4, 2), torch.randn(1, 4, 2),
                                  -torch.ones(8, 2), torch.zeros(1, 8, 2))),
        ("ssd_scan", (tms, "ssd_scan_cuda"),
         lambda: tops.ssd_scan(torch.randn(1, 4, 2, 8), r(1, 4, 2),
                               torch.randn(1, 4, 2), torch.randn(1, 4, 2),
                               -torch.ones(2), torch.zeros(1, 2, 8, 2),
                               chunk=4)),
        ("int8_matmul", (tq, "int8_matmul_cuda"),
         lambda: tops.int8_matmul(r(32, 32), torch.randn(32, 32),
                                  block_m=32, block_k=32, block_n=32)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernels_without_backward_refuse_gradients_on_card(monkeypatch,
                                                           case):
    """On the card, a wrapper whose kernel has no backward raises when a
    gradient is being taken of any of its inputs (the kernel's output
    would carry none: the scans' would quietly cut every gradient through
    an SSM layer), naming the ROADMAP item; under ``no_grad`` it launches.
    Shown on the CPU by taking the card's branch (``_on_card`` patched
    to True) with the kernel replaced by a stub."""
    name, (mod, attr), call = _no_backward_calls()[case]
    launched = []

    def stub(*a, **k):
        launched.append(attr)
        return torch.zeros((64, 64))

    monkeypatch.setattr(tops, "_on_card", lambda x: True)
    monkeypatch.setattr(mod, attr, stub)
    with pytest.raises(RuntimeError, match=f"{name}.*ROADMAP queue 2, "
                                           f"item 7"):
        call()
    assert not launched
    with torch.no_grad():
        call()
    assert launched == [attr]


def test_flash_backward_refuses_head_dim_128():
    """Kernel A's forward is built for head_dim 128 and for MLA's split
    head dims, its backward is not: a training run at those on the card
    is refused before the forward, naming the ROADMAP item, instead of
    reaching a template that was never instantiated."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2, item 7"):
        tfa.check_backward_head_dim(128)
    for dk, dv in ((96, 64), (192, 128), (64, 80)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 2, item 7"):
            tfa.check_backward_head_dim(dk, dv)
    for D in tfa.BWD_HEAD_DIMS:
        tfa.check_backward_head_dim(D)
        tfa.check_backward_head_dim(D, D)
    assert {(D, D) for D in tfa.BWD_HEAD_DIMS} < set(tfa.FWD_HEAD_DIMS)
    assert (128, 128) in tfa.FWD_HEAD_DIMS and 128 in tq.HEAD_DIMS
    assert {(96, 64), (192, 128)} < set(tfa.FWD_HEAD_DIMS)


# Kernel A's CUDA sources cannot be compiled here; these read them.
BF16_MMA = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"


def _source_with_headers(name):
    """The text of ``csrc/<name>`` and of the local headers it includes."""
    text = (_build.CSRC / name).read_text()
    for header in re.findall(r'#include "([^"]+)"', text):
        text += (_build.CSRC / header).read_text()
    return text


def _calls_in_kernel(text, kernel):
    """The body of ``__global__`` function ``kernel`` in ``text``."""
    start = text.index(f"\n{kernel}(")
    end = text.find("__global__", start)
    return text[start:end if end > 0 else len(text)]


def test_flash_backward_source_has_no_atomics():
    """Kernel A's backward sums without atomics, so reruns give the same
    bits; the shared header adds none either."""
    text = _source_with_headers("flash_attn_bwd.cu")
    assert "atomicAdd" not in text and "atom." not in text


@pytest.mark.parametrize("source,kernel,products", [
    ("flash_attn_fwd.cu", "flash_fwd_kernel", 6),
    ("flash_attn_bwd.cu", "bwd_dkdv_kernel", 10),
    ("flash_attn_bwd.cu", "bwd_dq_kernel", 6)])
def test_flash_sources_multiply_on_tensor_cores(source, kernel, products):
    """Every product of kernel A (forward: Q K^T and P V, the latter with
    P as a hi + lo pair; dK/dV: K Q^T, V dO^T, P^T dO, and dS^T Q with
    dS as a hi + lo pair; dQ: Q K^T, dO V^T, dS K) is a bf16 mma.sync
    with fp32 accumulators, two 8-wide tiles a call site, and no fp32
    fmaf loop is left in those kernels."""
    assert BF16_MMA in _source_with_headers(source)
    body = _calls_in_kernel((_build.CSRC / source).read_text(), kernel)
    assert body.count("mma_bf16(") == products
    assert "fmaf(" not in body
