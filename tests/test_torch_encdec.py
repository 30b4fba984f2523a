"""The PyTorch port's encoder-decoder family (whisper-small) against the
JAX reference, on the CPU: the config and its parameter count, the init
tree, kernel A's plain version and its backward run non-causal at
unequal lengths (the cross-attention's shape) against the reference's
``chunked_attention`` and its Pallas wrapper in interpret mode and
against ``jax.grad``, the encoder's output, forward logits, ``Model.loss``
and every gradient leaf, prefill and decode logits with the
cross-attention cache, the greedy tokens of the port's ``Engine``
against the reference's, the refusals (an int8 cache,
``ContinuousEngine``, the training launcher), and every plan at a gloo
world of one against the reference.  Weights are
the reference's, carried across by ``repro_torch.convert``; inputs are
made with numpy from a seed.  Reduced config (2 encoder and 2 decoder
layers, 32 frames, d_model 256, 4 heads of 64), fp32 unless said.

Tolerances: the attention functions hold one fp32 algorithm in two
frameworks, sums in other orders, to ``ATTN_ATOL`` 1e-5 on outputs and
gradients of O(1); the encoder's output to 1e-5; logits of O(1) through
four layers to ``LOGIT_ATOL`` 1e-4; the loss to 1e-5 relative; each
gradient leaf to 1e-4 of its largest entry, floored at 1e-3 of the
model's largest gradient (the ``bk`` rule of ROADMAP queue 3: a key
bias's gradient is zero in exact arithmetic, the cross-attention's
too).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core.plans import PLANS  # noqa: E402
from repro_torch.core.steps import build_train_step  # noqa: E402
from repro_torch.core.steps import value_and_grad  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import trains_through_kernels  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine  # noqa: E402

ARCH = "whisper-small"
ATTN_ATOL = 1e-5
ENC_ATOL = 1e-5
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_FLOOR = 1e-3
# (B, Sq, Sk, H, KV, D): the reduced cross-attention (8 text tokens over
# 32 frames), and lengths that are multiples of neither the port's
# chunks nor the Pallas wrapper's blocks, grouped-query
ATTN_SHAPES = ((2, 8, 32, 4, 4, 64), (1, 24, 40, 4, 2, 64))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and several test workers on a few cores: one
    intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(get_config, **overrides):
    return dataclasses.replace(get_config(ARCH).reduced(), **overrides)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params), fp32, the port's
    weights converted from the JAX ones."""
    jm = JModel(_config(jconfigs.get_config, dtype="float32"))
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    tm = TModel(_config(tconfigs.get_config, dtype="float32"), device="cpu")
    return jm, jp, tm, tp


def _frames(cfg, B, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq_len, cfg.d_model)) * 0.02).astype(np.float32)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, cfg.vocab_size, (B, S), np.int32)
    labels = rng.integers(4, cfg.vocab_size, (B, S), np.int32)
    labels[0, 5:9] = -1                     # masked positions
    return {"tokens": tokens, "labels": labels,
            "frames": _frames(cfg, B, seed + 1)}


def _jbatch(batch):
    return jax.tree.map(jnp.asarray, batch)


# ------------------------------------------------------------------ #
# the config

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    t, j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()
    assert (t.n_enc_layers, t.enc_seq_len) == ((2, 32) if reduced
                                                else (12, 1500))
    assert t.head_dim == 64 and t.family == "encdec"


def test_full_size_and_kernels():
    """277.9 M parameters; heads of 64, so training runs through kernel A
    and its backward on the card; the VLM, the family ported after it,
    is in the registry too."""
    cfg = tconfigs.get_config(ARCH)
    assert cfg.param_count() == 277_883_136
    assert (cfg.head_dim, cfg.head_dim) in tfa.FWD_HEAD_DIMS
    assert cfg.head_dim in tfa.BWD_HEAD_DIMS
    assert trains_through_kernels(cfg)
    assert tconfigs.get_config("phi-3-vision-4.2b").family == "vlm"


def test_init_tree_matches_reference(pair):
    """The port's own init makes the reference's keys (the decoder
    block's ``norm1``, ``self_attn``, ``norm2``, ``cross_attn``,
    ``norm3``, ``mlp``; the encoder's ``layers``, ``norm`` and
    ``pos/table``), shapes and laws."""
    jm, jp, tm, tp = pair
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(tm.init(torch.Generator().manual_seed(0)))
    assert sorted(jflat) == sorted(tflat)
    assert "encoder/pos/table" in tflat and "layers/cross_attn/bk" in tflat
    for key, ref in jflat.items():
        got = tflat[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert abs(got.std() / ref.std() - 1) < 0.1, key
    carried = convert.flatten(tp)
    for key, ref in jflat.items():
        np.testing.assert_array_equal(carried[key].numpy(), ref, err_msg=key)


# ------------------------------------------------------------------ #
# kernel A's plain version, non-causal at Sq != Sk

def _qkvd(shape, seed):
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                  (B, Sq, H, D)))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_noncausal_attention_matches_reference(shape):
    """The port's plain version against the reference's jnp
    ``chunked_attention`` (chunks smaller than the lengths, so the
    reference pads the keys and masks them) and against its Pallas
    wrapper in interpret mode, which pads Sk to its block and passes the
    key-validity mask."""
    q, k, v, _ = _qkvd(shape, 0)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=False, q_chunk=8, k_chunk=16)
    want = jax.jit(lambda q, k, v: jattn.chunked_attention(
        q, k, v, causal=False, q_chunk=8, k_chunk=16))(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL)
    pallas = jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=False, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               atol=ATTN_ATOL)
    whole = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=False)
    np.testing.assert_allclose(whole.numpy(), got.numpy(), atol=ATTN_ATOL)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_noncausal_backward_matches_jax_grad(shape):
    """dQ, dK, dV of ``sum(o * do)``: the plain backward from the plain
    forward's lse, and autograd through ``FlashAttention`` (the route a
    training step takes), against ``jax.grad`` of the reference's
    ``chunked_attention(causal=False)``."""
    q, k, v, do = _qkvd(shape, 1)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, causal=False, q_chunk=8,
                                    k_chunk=16)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=False,
                                       return_lse=True)
    direct = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                           causal=False, q_chunk=16)
    live = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tops.flash_attention(*live, causal=False)
    (out * tdo).sum().backward()
    for name, a, b, w in zip(("dq", "dk", "dv"), direct,
                             [t.grad for t in live], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   atol=ATTN_ATOL, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(w),
                                   atol=ATTN_ATOL, err_msg=name)


def test_backward_reads_the_output_in_fp32_for_keys_with_a_common_part():
    """Over keys and values that share a large common part (an encoder's
    output, as the cross-attention reads it) that part cancels out of dQ
    only where the backward's D = rowsum(dO * O) equals sum_j P_ij dP_ij
    closely.  ``FlashAttention`` keeps the forward's output in fp32 for
    D: its bf16 gradients stay within 1e-2 of the largest (the tolerance
    the card holds kernel A's backward to, for bf16 outputs and sums in
    another order) of autograd through the fp32 forward, where D from
    the bf16 output would put dQ off by more than its own size."""
    rng = np.random.default_rng(8)
    B, Sq, Sk, H, D = 1, 64, 1500, 2, 64

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    q = bf16(rng.standard_normal((B, Sq, H, D)) * 0.3)
    k = bf16(rng.standard_normal(D) * 4.0
             + rng.standard_normal((B, Sk, H, D)) * 0.05)
    v = bf16(rng.standard_normal(D) * 4.0
             + rng.standard_normal((B, Sk, H, D)))
    do = bf16(rng.standard_normal((B, Sq, H, D)))
    exact = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        tfa.flash_attention_plain(*exact, causal=False), exact, do.float())
    live = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(tops.flash_attention(*live, causal=False),
                              live, do)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=False,
                                       return_lse=True)
    dq_bf16_o = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                              causal=False)[0]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.abs().max())
        assert float((g.float() - w).abs().max()) <= 1e-2 * scale, name
    assert float((dq_bf16_o.float() - want[0]).abs().max()) > \
        float(want[0].abs().max())


# ------------------------------------------------------------------ #
# the model

def test_encoder_output_matches_reference(pair):
    jm, jp, tm, tp = pair
    frames = _frames(tm.cfg, 2, seed=3)
    want = jax.jit(jm._encode)(jp, {"frames": jnp.asarray(frames)})
    got = tm._encode(tp, {"frames": frames})
    assert tuple(got.shape) == (2, tm.cfg.enc_seq_len, tm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL)


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    batch = _batch(tm.cfg, S=19)
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jp, _jbatch(batch))
    got = tm.forward(tp, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


def test_loss_and_grads_match_reference(pair):
    """``Model.loss`` with remat and every gradient leaf, the encoder's
    and both attentions' (biases included), against
    ``jax.grad(Model.loss)``."""
    jm, jp, tm, tp = pair
    batch = _batch(tm.cfg)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=True), has_aux=True))(
        jp, _jbatch(batch))
    tloss, tmet, tg = value_and_grad(lambda p, b: tm.loss(p, b, remat=True),
                                     tp, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for key in ("ce", "zloss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    jflat = convert.flatten(jax.tree.map(np.asarray, jg))
    tflat = {k: v.numpy() for k, v in convert.flatten(tg).items()}
    assert sorted(jflat) == sorted(tflat)
    top = max(np.abs(w).max() for w in jflat.values())
    for key, want in jflat.items():
        scale = max(np.abs(want).max(), LEAF_FLOOR * top)
        np.testing.assert_allclose(tflat[key], want, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=key)
    for key in ("encoder/layers/attn/wq", "encoder/pos/table",
                "layers/cross_attn/wk", "layers/cross_attn/wq"):
        assert np.abs(tflat[key]).max() > 0, key


def test_encoder_runs_once_a_pass_under_remat(pair, monkeypatch):
    """A forward and backward with remat runs each encoder layer once: a
    decoder layer's recompute reads the saved encoder output."""
    _, _, tm, tp = pair
    calls = []
    real = tblocks.encoder_block_forward

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tblocks, "encoder_block_forward", counted)
    live = {k: v.clone().requires_grad_(True)
            for k, v in convert.flatten(tp).items()}
    loss, _ = tm.loss(convert.unflatten(live), _batch(tm.cfg), remat=True)
    loss.backward()
    assert len(calls) == tm.cfg.n_enc_layers
    assert live["encoder/layers/mlp/w_up"].grad.abs().max() > 0


def test_prefill_decode_and_cross_cache_match_reference(pair):
    """Prefill logits and four decode steps fed the reference's greedy
    tokens, the greedy tokens equal, and the port's ``Engine`` gives
    them too; the cache's ``cross_k`` and ``cross_v`` (filled at
    prefill, read by every decode step) and the self-attention's ring
    against the reference's."""
    jm, jp, tm, tp = pair
    B, S, cap = 2, 11, 24
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(4, 400, (B, S), np.int32),
             "frames": _frames(tm.cfg, B, seed=5)}
    jl, jc = jax.jit(lambda p, b, c: jm.prefill(p, b, c))(
        jp, _jbatch(batch), jm.init_cache(B, cap))
    cache = tm.init_cache(B, cap)
    assert tuple(cache["cross_k"].shape) == (
        tm.cfg.n_layers, B, tm.cfg.enc_seq_len, tm.cfg.n_heads,
        tm.cfg.head_dim)
    tl, tc = tm.prefill(tp, batch, cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for leaf in ("cross_k", "cross_v"):
        assert tc[leaf].abs().max() > 0, leaf
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   atol=ENC_ATOL, err_msg=leaf)
    jdec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    greedy = []
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        greedy.append(tok)
        np.testing.assert_array_equal(
            torch.argmax(tl, -1).numpy(), tok[:, 0], err_msg=f"step {step}")
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(tc["self"].index.numpy(),
                                  np.asarray(jc["self"].index))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(getattr(tc["self"], leaf).numpy(),
                                   np.asarray(getattr(jc["self"], leaf)),
                                   atol=ENC_ATOL, err_msg=leaf)
    got = Engine(tm, batch_size=B, max_len=cap, device="cpu").generate(
        tp, batch, n_tokens=len(greedy))["tokens"]
    np.testing.assert_array_equal(got, np.concatenate(greedy, 1))


def test_serve_launcher_makes_frames():
    """``launch/serve.py`` serves the family on the CPU, with frames of
    its own from the prompts' generator."""
    from repro_torch.launch import serve as tserve

    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)


# ------------------------------------------------------------------ #
# refusals: what the reference cannot run either, and the plans

def test_int8_cache_is_refused(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="family 'encdec'"):
        tm.init_cache(2, 16, kv_dtype="int8")
    batch = {"tokens": np.ones((2, 4), np.int64),
             "frames": _frames(tm.cfg, 2)}
    with pytest.raises(ValueError, match="family 'encdec'"):
        Engine(tm, batch_size=2, max_len=16, kv_dtype="int8",
               device="cpu").generate(tp, batch, n_tokens=2)


def test_continuous_engine_and_train_launcher_are_refused(pair):
    """Continuous batching serves token-only prompts, and the training
    launcher's Loader feeds tokens alone, as in the reference."""
    from repro_torch.launch import train as ttrain

    _, _, tm, _ = pair
    with pytest.raises(NotImplementedError, match="modality extras"):
        ContinuousEngine(tm, slots=2, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--steps", "1", "--seq", "16", "--batch", "2"])


@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of one rank in this process: its flat mesh and its
    staged mesh of one stage."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    axes = ("pod", "data", "model")
    yield {"flat": make_host_mesh((1, 1, 1), axes),
           "staged": make_pipeline_mesh((1, 1, 1), axes, 1)}
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_every_plan_raises_naming_item_14(pair, one_rank, plan):
    """Every plan trains and serves the encoder-decoder (named for the
    refusal it held until the family ran under the plans: ROADMAP queue
    1, item 14, done).  At a gloo world of one, the step-1 loss of
    ``build_train_step`` under the plan (pipeshard: two microbatches)
    is the reference's ``Model.loss`` within ``LOSS_RTOL``, and the
    ``Engine`` under the plan (``ServePlan``) gives the reference's
    greedy tokens: the one-device ``Engine``'s, held to them above."""
    jm, jp, tm, tp = pair
    mesh = one_rank["staged" if PLANS[plan].pipeline else "flat"]
    batch = _batch(tm.cfg, B=4, seed=6)
    step = build_train_step(tm, TrainConfig(microbatches=2), plan=plan,
                            mesh=mesh)
    loss, metrics, _ = step.grads(step.shard_params(tp), batch)
    want, _ = jax.jit(jm.loss)(jp, _jbatch(batch))
    assert float(loss) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert float(metrics["tokens"]) == (batch["labels"][:, 1:] >= 0).sum()
    prompts = {"tokens": batch["tokens"][:, :9], "frames": batch["frames"]}
    one = Engine(tm, batch_size=4, max_len=16, device="cpu")
    eng = Engine(tm, batch_size=4, max_len=16, device="cpu", plan=plan,
                 mesh=mesh)
    np.testing.assert_array_equal(
        eng.generate(eng.shard_params(tp), prompts, n_tokens=5)["tokens"],
        one.generate(tp, prompts, n_tokens=5)["tokens"])
    assert tuple(eng._init_cache(4)["cross_k"].shape) == (
        tm.cfg.n_layers, 4, tm.cfg.enc_seq_len, tm.cfg.n_heads,
        tm.cfg.head_dim)
    assert build_train_step(tm, TrainConfig(), plan=None) is not None
