"""Kernels of the PyTorch port against the JAX reference.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions to the reference's Pallas kernels (in
interpret mode), its direct oracles and its jnp ``chunked_attention``,
on the same numpy inputs, in fp32.  ``test_torch_cuda.py`` holds the
CUDA kernels to these plain versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

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
    assert set(counts) == {"flash_attn_fwd", "int8kv_decode", "ssd_scan",
                           "mamba1_scan"}
    assert not any(counts.values())


def test_ops_reject_other_devices():
    q = torch.zeros((1, 4, 4, 64), device="meta")
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
