"""The PyTorch port's training math against the JAX reference, on the
CPU: kernel A's backward (its plain version and the autograd Function
that the card runs with the kernels), the model's loss and gradients on
a reduced gpt2m, AdamW and the learning-rate schedules.  Inputs are made
from a seed with numpy and handed to both packages.

Tolerances and why:

* attention gradients, fp32: the plain backward recomputes P from the
  forward's logsumexp, where XLA differentiates the reference's online
  softmax; both sum in fp32 over at most 257 keys, in other orders, so
  they agree to ~1e-6 of the largest gradient.  ``ATTN_RTOL`` (1e-5 of
  it) leaves headroom.
* model loss and gradients, fp32, two layers: matmuls and reductions
  sum in other orders; the loss agrees to ~1e-7 relative and each
  gradient leaf to ~1e-6 of its largest entry.  ``LOSS_RTOL`` 1e-5,
  ``GRAD_RTOL`` 1e-4 of the leaf's largest entry.  The key bias's
  gradient is 0 in exact arithmetic (it shifts all of a row's scores
  alike), so both sides hold rounding noise of ~1e-9 there: a leaf's
  scale has a floor of ``LEAF_FLOOR`` (1e-3) of the model's largest
  gradient entry.
* bf16 compute over fp32 params: the two frameworks round to bf16 at
  other places (the reference casts the embedding table before the
  gather and scatter-adds its gradient in bf16; the port gathers in
  fp32), so each leaf is held to a relative L2 error of ``BF16_REL``
  (against the same floored scale) and the loss to ``BF16_LOSS_RTOL``,
  a few bf16 ulps (2^-8 = 0.4%).
* AdamW and the schedules, fp32: the same operations in the same order,
  but XLA may contract a product and a sum into one FMA, and ``b **
  step``, the cosine and the square root may round apart in the last
  ulp; values agree to ~1.5e-6 relative after three steps (a few ulps of
  2^-23), held to ``OPT_RTOL`` = 1e-5.  A moment entry that nearly
  cancels (``b1 m + (1 - b1) g``) keeps the absolute error of its
  operands, so entries are also allowed ``OPT_RTOL`` of the leaf's
  largest value.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core.steps import value_and_grad  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

ATTN_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_FLOOR = 1e-3
BF16_REL = 0.05
BF16_LOSS_RTOL = 1e-2
OPT_RTOL = 1e-5

# (B, S, H, KV, D, causal, window): ragged S (37, 257), both head dims,
# GQA H=4 over KV=2, a window under causal, and one non-causal case
ATTN_CASES = [
    (1, 37, 4, 4, 64, True, 0),
    (2, 257, 4, 2, 64, True, 0),
    (1, 257, 4, 4, 80, True, 0),
    (1, 37, 4, 2, 80, True, 16),
    (1, 257, 2, 2, 64, True, 64),
    (2, 37, 4, 2, 64, False, 0),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small, and the suite runs several workers on
    a few cores: PyTorch's intra-op threads would contend for them far
    longer than the work takes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    do = rng.standard_normal((B, S, H, D), np.float32)
    return q, k, v, do


def _reference_grads(q, k, v, do, causal, window):
    """jax.grad (a VJP) of the reference's jnp chunked attention."""
    def f(q, k, v):
        return chunked_attention(q, k, v, causal=causal, window=window)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _autograd_grads(fn, q, k, v, do):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in ts]


def _assert_grads(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=ATTN_RTOL * np.abs(w).max(),
            err_msg=f"{what} {name}")


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", ATTN_CASES)
def test_flash_backward_plain_matches_autograd_and_reference(
        B, S, H, KV, D, causal, window):
    q, k, v, do = _attn_inputs(B, S, H, KV, D, seed=S + H + D)
    ts = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = tfa.flash_attention_plain(*ts[:3], causal=causal, window=window,
                                       return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    got = [g.numpy() for g in tfa.flash_attention_bwd_plain(
        *ts[:3], o, ts[3], lse, causal=causal, window=window, q_chunk=100)]
    autograd = _autograd_grads(
        lambda q, k, v: tfa.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window), q, k, v, do)
    _assert_grads(got, autograd, "plain backward vs autograd")
    _assert_grads(got, _reference_grads(q, k, v, do, causal, window),
                  "plain backward vs jax.grad(chunked_attention)")


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", ATTN_CASES[:4])
def test_flash_function_on_cpu_matches_reference(B, S, H, KV, D, causal,
                                                 window):
    """The autograd Function the card runs, wired to the plain versions
    on CPU tensors: output, and gradients through ``ops``."""
    q, k, v, do = _attn_inputs(B, S, H, KV, D, seed=7 * S + D)
    got = _autograd_grads(
        lambda q, k, v: tops.flash_attention(q, k, v, causal=causal,
                                             window=window), q, k, v, do)
    _assert_grads(got, _reference_grads(q, k, v, do, causal, window),
                  "Function vs jax.grad(chunked_attention)")
    _assert_grads(got, _autograd_grads(
        lambda q, k, v: tfa.flash_attention_plain(q, k, v, causal=causal,
                                                  window=window), q, k, v, do),
        "Function vs autograd of the plain attention")
    with torch.no_grad():
        out = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_flash_lse_is_the_row_logsumexp():
    q, k, v, _ = _attn_inputs(1, 37, 4, 2, 64, seed=3)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    _, lse = tfa.flash_attention_plain(*ts, causal=True, window=8,
                                       return_lse=True, q_chunk=16,
                                       k_chunk=16)
    s = torch.einsum("bqhd,bkhd->bhqk", ts[0],
                     ts[1].repeat_interleave(2, dim=2)) / 8.0
    i = torch.arange(37)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 8)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ #
# the model's loss and gradients

def _model_pair(dtype):
    jcfg = dataclasses.replace(jconfigs.get_config("gpt2m").reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config("gpt2m").reduced(),
                               dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, TModel(tcfg, device="cpu"), tp


@pytest.fixture(scope="module")
def fp32_pair():
    return _model_pair("float32")


def _batch(vocab, B=2, S=33, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, (B, S), np.int32)
    labels = rng.integers(4, vocab, (B, S), np.int32)
    labels[0, 5:9] = -1                     # masked positions
    return {"tokens": tokens, "labels": labels}


def _compare_loss_and_grads(jm, jp, tm, tp, batch, remat, *, bf16=False):
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=remat), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, remat=remat), tp, batch)
    rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    for key in ("ce", "zloss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=rtol, err_msg=key)
    jflat = convert.flatten(jax.tree.map(np.asarray, jg))
    tflat = {k: v.numpy() for k, v in convert.flatten(tg).items()}
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        assert tflat[key].dtype == np.float32, key
    _assert_leaves(tflat, jflat, bf16=bf16)


def _assert_leaves(got, want, *, bf16=False):
    top = max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if bf16:
            norm = max(np.linalg.norm(w), LEAF_FLOOR * top * np.sqrt(w.size))
            rel = float(np.linalg.norm(g - w) / norm)
            assert rel < BF16_REL, (key, rel)
        else:
            scale = max(np.abs(w).max(), LEAF_FLOOR * top)
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                       err_msg=key)


@pytest.mark.parametrize("remat", [True, False])
def test_model_loss_and_grads_match_reference_fp32(fp32_pair, remat):
    jm, jp, tm, tp = fp32_pair
    _compare_loss_and_grads(jm, jp, tm, tp, _batch(jm.cfg.vocab_size), remat)


def test_model_loss_and_grads_match_reference_bf16():
    jm, jp, tm, tp = _model_pair("bfloat16")
    _compare_loss_and_grads(jm, jp, tm, tp, _batch(jm.cfg.vocab_size, seed=1),
                            True, bf16=True)


def test_kernel_flag_paths_agree_on_cpu(fp32_pair):
    """``use_kernels`` (the autograd Function, plain versions on the CPU)
    against ``use_kernels=False`` (autograd through the plain attention):
    the gradient parity gate of the kernel path, on the CPU."""
    _, _, tm, tp = fp32_pair
    plain = TModel(tm.cfg, device="cpu", use_kernels=False)
    batch = _batch(tm.cfg.vocab_size, seed=2)
    l1, _, g1 = value_and_grad(lambda p, b: tm.loss(p, b), tp, batch)
    l2, _, g2 = value_and_grad(lambda p, b: plain.loss(p, b), tp, batch)
    np.testing.assert_allclose(float(l1), float(l2), rtol=LOSS_RTOL)
    _assert_leaves({k: v.numpy() for k, v in convert.flatten(g1).items()},
                   {k: v.numpy() for k, v in convert.flatten(g2).items()})


def test_lm_loss_masks_and_counts():
    from repro.models.model import lm_loss as jlm_loss
    from repro_torch.models.model import lm_loss as tlm_loss

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 50), np.float32) * 3
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[1, 2:] = -1
    cfg = tconfigs.get_config("gpt2m").reduced()
    jcfg = jconfigs.get_config("gpt2m").reduced()
    aux = np.float32(0.25)
    tl, tm = tlm_loss(cfg, torch.from_numpy(logits), {"labels": labels},
                      torch.tensor(aux))
    jl, jm = jlm_loss(jcfg, jnp.asarray(logits), {"labels": labels},
                      jnp.asarray(aux))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert float(tm["tokens"]) == 8 + 1


# ------------------------------------------------------------------ #
# optimizer and schedule

def _opt_tree(rng):
    """Leaves under decay and no-decay keys, as the model has them."""
    shapes = {"embed": {"table": (11, 8)},
              "final_norm": {"scale": (8,), "bias": (8,)},
              "layers": {"attn": {"wq": (2, 8, 2, 4), "bq": (2, 2, 4)},
                         "norm1": {"scale": (2, 8)},
                         "mlp": {"w_up": (2, 8, 16), "b_up": (2, 16)}}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return convert.params_from_numpy(t)


_jadamw = jax.jit(joptim.adamw_update, static_argnums=(3,))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_adamw_three_steps_match_reference(grad_scale):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    tcfg, jcfg = TrainConfig(warmup_steps=2), JTrainConfig(warmup_steps=2)
    jp, tp = _jtree(params), _ttree(params)
    jst, tst = joptim.init_adamw(jp), toptim.init_adamw(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: x * grad_scale, _opt_tree(rng))
        jlr = joptim.lr_at(jst.step, jcfg)
        tlr = toptim.lr_at(tst.step, tcfg)
        jp, jst, jstats = _jadamw(_jtree(g), jst, jp, jcfg, jlr)
        tp, tst, tstats = toptim.adamw_update(_ttree(g), tst, tp, tcfg, tlr)
        assert int(tst.step) == int(jst.step) == step + 1
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                                   rtol=OPT_RTOL)
        for name, jt, tt in (("params", jp, tp), ("m", jst.m, tst.m),
                             ("v", jst.v, tst.v)):
            jf = convert.flatten(jax.tree.map(np.asarray, jt))
            tf = convert.flatten(tt)
            for key, want in jf.items():
                np.testing.assert_allclose(
                    tf[key].numpy(), want, rtol=OPT_RTOL,
                    atol=OPT_RTOL * np.abs(want).max(),
                    err_msg=f"step {step} {name}/{key}")


def test_decay_mask_matches_reference():
    from repro.optim.adamw import _decay_mask as jmask
    from repro_torch.optim.adamw import _decay_mask as tmask

    params = _opt_tree(np.random.default_rng(0))
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    got = {"/".join(p.key for p in path): tmask("/".join(p.key for p in path))
           for path, _ in paths}
    want = {"/".join(p.key for p in path): jmask(path) for path, _ in paths}
    assert got == want
    assert not got["layers/norm1/scale"] and got["layers/attn/wq"]


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=40,
              schedule=schedule)
    tcfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    steps = np.arange(0, 46, dtype=np.int32)
    got = np.array([float(toptim.lr_at(torch.tensor(s), tcfg))
                    for s in steps])
    want = np.array([float(joptim.lr_at(jnp.asarray(s), jcfg))
                     for s in steps])
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL)
    assert got[0] < got[6] and got[-1] <= got[7]


def test_train_config_matches_reference():
    t, j = TrainConfig(), JTrainConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
