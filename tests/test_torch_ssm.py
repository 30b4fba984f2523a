"""The PyTorch port's SSM path against the JAX package, in fp32.

Kernels 3 (SSD) and 4 (Mamba1): on the CPU each wrapper runs its plain
sequential version; these tests hold those, from zero and from a filled
state ``h0``, to the reference's Pallas kernels (interpret mode), its
sequential oracles and its jnp chunked scans, at lengths that are not a
multiple of the chunk, and through an SSD case whose unmasked ``exp``
would overflow.  Then the falcon-mamba model (reduced): forward,
prefill and cache, decode, both engines and the slot steps.
``test_torch_cuda.py`` holds the CUDA kernels to the plain versions on a
card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ssm_parity as parity  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

# fp32 recurrences of a few dozen steps over O(1) states, summed in other
# orders (sequential, chunked block decomposition, log-step prefix
# scan): agreement to a few fp32 ulps of the largest state
ATOL = 2e-5
# the overflow-prone SSD case: its in-chunk log-decay sums reach ~ -1000,
# where fp32 spacing is 6.1e-5, so the chunked forms' exp(s_i - s_j)
# carry relative errors of ~1e-4 that the sequential form does not
OVERFLOW_RTOL = 1e-3


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mamba1_inputs(rng, B, S, di, ds):
    x = _rand(rng, (B, S, di))
    dt = np.abs(_rand(rng, (B, S, di), 0.5)).astype(np.float32)
    b_s, c_s = _rand(rng, (B, S, ds)), _rand(rng, (B, S, ds))
    A = -np.exp(_rand(rng, (di, ds), 0.5)).astype(np.float32)
    return x, dt, b_s, c_s, A


def _ssd_inputs(rng, B, S, nh, hd, ds, dt_scale=0.5):
    xh = _rand(rng, (B, S, nh, hd))
    dt = np.abs(_rand(rng, (B, S, nh), dt_scale)).astype(np.float32)
    b_s, c_s = _rand(rng, (B, S, ds)), _rand(rng, (B, S, ds))
    a = -np.linspace(1.0, 16.0, nh).astype(np.float32)   # zamba2's A
    return xh, dt, b_s, c_s, a


@pytest.mark.parametrize("B,S,di,ds", [(2, 37, 48, 8), (1, 20, 32, 16)])
def test_mamba1_plain_matches_reference(B, S, di, ds):
    """Kernel 4's plain version from h0 = 0 against the Pallas kernel in
    interpret mode (S pads to its chunk of 16) and the sequential
    oracle; the port's oracle twin against the reference's."""
    rng = np.random.default_rng(S * di)
    x, dt, b_s, c_s, A = _mamba1_inputs(rng, B, S, di, ds)
    h0 = torch.zeros((B, di, ds))
    y, h = tms.mamba1_scan_plain(_t(x), _t(dt), _t(b_s), _t(c_s), _t(A), h0)
    jy, jh = jops.mamba1_scan(*(jnp.asarray(v) for v in (x, dt, b_s, c_s,
                                                          A)),
                              chunk=16, interpret=True)
    ry, rh = jref.mamba1_ref(*(jnp.asarray(v) for v in (x, dt, b_s, c_s,
                                                         A)))
    for name, (wy, wh) in (("pallas", (jy, jh)), ("oracle", (ry, rh))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=ATOL,
                                   err_msg=name)
    ty, th = tref.mamba1_ref(_t(x), _t(dt), _t(b_s), _t(c_s), _t(A))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=ATOL)


@pytest.mark.parametrize("B,S,nh,hd,ds", [(2, 37, 4, 32, 8),
                                          (1, 20, 2, 16, 16)])
def test_ssd_plain_matches_reference(B, S, nh, hd, ds):
    """Kernel 3's plain version (model layout) from h0 = 0 against the
    Pallas kernel in interpret mode (chunk 16, S padded) and the
    sequential oracle; the port's oracle twin against the reference's."""
    rng = np.random.default_rng(S * nh + hd)
    xh, dt, b_s, c_s, a = _ssd_inputs(rng, B, S, nh, hd, ds)
    h0 = torch.zeros((B, nh, hd, ds))
    y, h = tms.ssd_scan_plain(_t(xh), _t(dt), _t(b_s), _t(c_s), _t(a), h0)
    jy, jh = jops.ssd_scan(*(jnp.asarray(v) for v in (xh, dt, b_s, c_s, a)),
                           chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
    tr = (xh.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), b_s, c_s, a)
    ry, rh = jref.ssd_ref(*(jnp.asarray(v) for v in tr))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(ry).transpose(0, 2, 1, 3),
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=ATOL)
    ty, th = tref.ssd_ref(*(_t(v) for v in tr))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=ATOL)


def test_mamba1_from_h0_matches_jnp_inner():
    """From a filled state: the port's ``_mamba1_inner`` through the ops
    wrapper (plain scan on the CPU) and through its port of the
    reference's chunked prefix scan, against the reference's jnp
    ``_mamba1_inner`` (projections, scan, D skip and gate)."""
    cfg = dataclasses.replace(jconfigs.get_config("falcon-mamba-7b")
                              .reduced(), dtype="float32")
    p = jax.tree.map(np.asarray, jssm.init_mamba1(jax.random.key(2), cfg))
    di, ds = cfg.d_inner, cfg.ssm.d_state
    rng = np.random.default_rng(21)
    x_conv, z = _rand(rng, (2, 37, di)), _rand(rng, (2, 37, di))
    h0 = _rand(rng, (2, di, ds))
    wy, wh = jssm._mamba1_inner(jnp.asarray(x_conv), jnp.asarray(z),
                                jax.tree.map(jnp.asarray, p), cfg,
                                jnp.asarray(h0), chunk=cfg.ssm.chunk)
    tp = {k: _t(v) for k, v in p.items()}
    for use_kernels in (True, False):
        y, h = tssm._mamba1_inner(_t(x_conv), _t(z), tp, cfg, _t(h0),
                                  cfg.ssm.chunk, use_kernels=use_kernels)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=ATOL)


@pytest.mark.parametrize("dt_scale", [0.5, 8.0], ids=["plain", "overflow"])
def test_ssd_from_h0_matches_jnp_chunk_scan(dt_scale):
    """From a filled state, against the reference's jnp
    ``_ssd_chunk_scan``: the ops wrapper (plain scan on the CPU) and the
    port's chunked scan.  With dt ~ 8 and A down to -16 a chunk of 16
    sums to ~ -1000, so ``exp(s_i - s_j)`` of the upper triangle
    overflows to inf: the port masks before the exponential and must
    give no NaN."""
    B, S, nh, hd, ds = 2, 37, 4, 32, 8
    rng = np.random.default_rng(int(dt_scale * 10))
    xh, dt, b_s, c_s, a = _ssd_inputs(rng, B, S, nh, hd, ds, dt_scale)
    h0 = _rand(rng, (B, nh, hd, ds))
    wy, wh = jssm._ssd_chunk_scan(*(jnp.asarray(v) for v in (xh, dt, b_s,
                                                              c_s, a, h0)),
                                  chunk=16)
    args = tuple(_t(v) for v in (xh, dt, b_s, c_s, a, h0))
    rtol = OVERFLOW_RTOL if dt_scale > 1 else 0.0
    for name, (y, h) in (("plain", tops.ssd_scan(*args, chunk=16)),
                         ("chunked", tssm._ssd_chunk_scan(*args, chunk=16))):
        assert torch.isfinite(y).all() and torch.isfinite(h).all(), name
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL,
                                   rtol=rtol, err_msg=name)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=ATOL,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("kernel,hd,ds,chunk,match", [
    ("ssd", 32, 8, 16, "head_dim, d_state"),
    ("ssd", 64, 64, 128, "chunk in"),
    ("mamba1", 0, 4, 0, "d_state in")])
def test_scan_kernels_refuse_unsupported_shapes(kernel, hd, ds, chunk,
                                                match):
    """The CUDA wrappers refuse a shape their kernels were not built for
    before they look at the device (kernel 3 takes zamba2's head_dim 64
    and d_state 64 with a chunk up to 64; kernel 4 d_state 8 or 16)."""
    B, S = 1, 5
    b_s = torch.zeros((B, S, ds))
    if kernel == "ssd":
        xh, dt = torch.zeros((B, S, 2, hd)), torch.zeros((B, S, 2))
        with pytest.raises(ValueError, match=match):
            tms.ssd_scan_cuda(xh, dt, b_s, b_s, torch.zeros(2),
                              torch.zeros((B, 2, hd, ds)), chunk=chunk)
    else:
        x = torch.zeros((B, S, 8))
        with pytest.raises(ValueError, match=match):
            tms.mamba1_scan_cuda(x, x, b_s, b_s, torch.zeros((8, ds)),
                                 torch.zeros((B, 8, ds)))


# ------------------------------------------------------------------ #
# falcon-mamba (reduced, fp32) against the JAX model
@pytest.fixture(scope="module")
def pair():
    return parity.Pair("falcon-mamba-7b")


def test_param_tree_matches_reference(pair):
    parity.check_param_tree(pair)


def test_forward_logits_match_reference(pair):
    parity.check_forward(pair)


@pytest.mark.parametrize("S", [1, 2, 3, 37])
def test_prefill_cache_and_decode_match_reference(pair, S):
    """S = 1, 2 and 3 are shorter than d_conv - 1 = 3 or equal to it:
    the conv state keeps zeros of the initial state."""
    parity.check_prefill_and_decode(pair, S)


def test_prefill_continues_from_a_filled_state(pair):
    """A second prefill starts from the cache the first one filled (the
    scan's h0), as the reference's does."""
    toks = parity.tokens(5, (2, 23))
    jc = pair.jm.init_cache(2, 8)
    tc = pair.tm.init_cache(2, 8)
    for part in (toks[:, :9], toks[:, 9:]):
        jl, jc = pair.jpre(pair.jp, {"tokens": jnp.asarray(part)}, jc)
        tl, tc = pair.tm.prefill(pair.tp, {"tokens": part}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=parity.LOGIT_ATOL)
    parity.assert_caches_close(tc, jc, "second prefill")


def test_engines_match_reference_greedy_tokens(pair):
    parity.check_engines(pair)


def test_slot_steps_on_the_ssm_cache(pair):
    parity.check_slot_steps(pair)


def test_int8_kv_refused(pair):
    parity.check_int8_refused(pair)
