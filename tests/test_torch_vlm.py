"""The PyTorch port's vision-language family (phi-3-vision-4.2b) against
the JAX reference, on the CPU: the config and its parameter count, the
init tree with the projector, forward logits over the ``[patches; text]``
sequence, ``Model.loss`` with the patch offset and every gradient leaf
(and ``grad_accum``'s microbatches, the patches cut with their rows),
prefill and decode logits with both caches (the int8 one through the
reference's Pallas int8-KV wrapper in interpret mode, the reference's
decode path off a TPU), the greedy tokens of the port's ``Engine``
against the reference's, the projector's plan specs against the
reference's, kernel B's thread map at head_dim 96, and the refusals
(``ContinuousEngine``, the training launcher, a cache short of the
patches).  The plan worlds of the family run in the existing worker
spawns (``tests/torch_plan_family_worker.py``,
``tests/torch_serve_family_worker.py``).

Weights are the reference's, carried across by ``repro_torch.convert``;
inputs are made with numpy from a seed.  Two variants of the reduced
config (2 layers, 8 patches of 64 features, fp32): "hd64" as
``reduced()`` gives it (d_model 256, 4 heads of 64), and "hd96" with the
full model's head width (d_model 384, 4 heads of 96), the shape kernels
A and B are instantiated at for it.

Tolerances (those of ``test_torch_encdec.py``): logits of O(1) through
two layers to ``LOGIT_ATOL`` 1e-4 (one fp32 algorithm in two
frameworks, sums in other orders); with the int8 cache a payload entry
may round to the neighbouring int8 step in one framework, which moves a
decode logit by ~1e-4, so decode logits to ``INT8_DECODE_ATOL`` 1e-3
(as ``test_torch_llama.py``); the loss to 1e-5 relative; each gradient
leaf to 1e-4 of its largest entry, floored at 1e-3 of the model's
largest gradient (the ``bk`` rule of ROADMAP queue 3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.core.sharding import _path_str  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core.steps import value_and_grad  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import trains_through_kernels  # noqa: E402
from repro_torch.models.model import lm_loss as tlm_loss  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine  # noqa: E402

ARCH = "phi-3-vision-4.2b"
LOGIT_ATOL = 1e-4
INT8_DECODE_ATOL = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_FLOOR = 1e-3
VARIANTS = {"hd64": {}, "hd96": {"d_model": 384, "head_dim": 96}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and several test workers on a few cores: one
    intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(get_config, variant, **overrides):
    return dataclasses.replace(get_config(ARCH).reduced(),
                               **VARIANTS[variant], **overrides)


_PAIRS = {}


def pair_of(variant):
    """(JAX model, JAX params, port model, port params) of a variant in
    fp32, the port's weights converted from the JAX ones; built once per
    module."""
    if variant not in _PAIRS:
        jm = JModel(_config(jconfigs.get_config, variant, dtype="float32"))
        jp = jax.jit(jm.init)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        tm = TModel(_config(tconfigs.get_config, variant, dtype="float32"),
                    device="cpu")
        _PAIRS[variant] = jm, jp, tm, tp
    return _PAIRS[variant]


def _patches(cfg, B, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patches, cfg.vision_dim)) * 0.02).astype(np.float32)


def _batch(cfg, B=2, S=13, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, cfg.vocab_size, (B, S), np.int32)
    labels = rng.integers(4, cfg.vocab_size, (B, S), np.int32)
    labels[0, 3:6] = -1                     # masked positions
    return {"tokens": tokens, "labels": labels,
            "patch_embeds": _patches(cfg, B, seed + 1)}


def _jbatch(batch):
    return jax.tree.map(jnp.asarray, batch)


# ------------------------------------------------------------------ #
# the config

@pytest.mark.parametrize("variant", [None, "hd64", "hd96"])
def test_config_matches_reference(variant):
    """Every field (``vision_dim`` and ``n_patches`` among them) and the
    parameter count with the projector's term, at full size and for both
    reduced variants; ``reduced()`` keeps 8 patches of 64 features."""
    if variant is None:
        t, j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    else:
        t = _config(tconfigs.get_config, variant)
        j = _config(jconfigs.get_config, variant)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()
    assert t.family == "vlm"
    assert (t.vision_dim, t.n_patches) == ((1024, 576) if variant is None
                                           else (64, 8))


def test_full_size_and_kernels():
    """~3.83 B parameters, 12.6 M of them the projector's; heads of 96,
    for which kernel A has its (96, 96) forward and kernel B its head_dim
    96, and no backward, so the launchers train it through the plain
    versions (as llama3.2 and phi4-mini with RMSNorm)."""
    cfg = tconfigs.get_config(ARCH)
    assert cfg.param_count() == 3_833_662_464
    assert cfg.param_count() - dataclasses.replace(
        cfg, family="dense").param_count() == 1024 * 3072 + 3072 * 3072
    assert cfg.head_dim == 96 and cfg.n_kv_heads == cfg.n_heads == 32
    assert (96, 96) in tfa.FWD_HEAD_DIMS and 96 in tq.HEAD_DIMS
    assert 96 not in tfa.BWD_HEAD_DIMS
    assert not trains_through_kernels(cfg)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_tree_matches_reference(variant):
    """The port's own init makes the reference's keys (the dense block's
    and ``projector/w1`` [vision_dim, d], ``projector/w2`` [d, d]),
    shapes and laws (truncated normal at 1/sqrt(fan in)); ``convert``
    carries the reference's values across exactly."""
    jm, jp, tm, tp = pair_of(variant)
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(tm.init(torch.Generator().manual_seed(0)))
    assert sorted(jflat) == sorted(tflat)
    cfg = tm.cfg
    assert tuple(tflat["projector/w1"].shape) == (cfg.vision_dim,
                                                  cfg.d_model)
    assert tuple(tflat["projector/w2"].shape) == (cfg.d_model, cfg.d_model)
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
# the model

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_reference(variant):
    """Logits over the P patches and the text, [B, P + S, V]."""
    jm, jp, tm, tp = pair_of(variant)
    batch = _batch(tm.cfg, S=11)
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jp, _jbatch(batch))
    got = tm.forward(tp, batch)
    assert tuple(got.shape) == (2, tm.cfg.n_patches + 11,
                                tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_reference(variant):
    """``Model.loss`` with remat (text token i scored at position P + i -
    1, no label shift, the denominator the text's live labels) and every
    gradient leaf, the projector's included, against
    ``jax.grad(Model.loss)``."""
    jm, jp, tm, tp = pair_of(variant)
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
    assert float(tmet["tokens"]) == (batch["labels"] >= 0).sum()
    jflat = convert.flatten(jax.tree.map(np.asarray, jg))
    tflat = {k: v.numpy() for k, v in convert.flatten(tg).items()}
    assert sorted(jflat) == sorted(tflat)
    top = max(np.abs(w).max() for w in jflat.values())
    for key, want in jflat.items():
        scale = max(np.abs(want).max(), LEAF_FLOOR * top)
        np.testing.assert_allclose(tflat[key], want, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=key)
    for key in ("projector/w1", "projector/w2"):
        assert np.abs(tflat[key]).max() > 0, key


def test_grad_accum_cuts_the_patches_with_the_rows():
    """``grad_accum`` cuts every leaf of the batch, the patches with
    their rows: on a batch without masked labels (each microbatch holds
    the same token count) two accumulated microbatches give the whole
    batch's loss and gradients."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.steps import _grad_fn

    _, _, tm, tp = pair_of("hd64")
    batch = _batch(tm.cfg, B=4)
    batch["labels"] = batch["tokens"]
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = [_grad_fn(tm, TrainConfig(grad_accum=a),
                     lambda p, b: tm.loss(p, b, remat=False))(tp, batch)
            for a in (1, 2)]
    (whole, _, gw), (accum, _, ga) = runs
    np.testing.assert_allclose(float(accum), float(whole), rtol=LOSS_RTOL)
    gw, ga = convert.flatten(gw), convert.flatten(ga)
    top = max(float(g.abs().max()) for g in gw.values())
    for key, want in gw.items():
        scale = max(float(want.abs().max()), LEAF_FLOOR * top)
        assert float((ga[key] - want).abs().max()) <= GRAD_RTOL * scale, key


def test_lm_loss_offset_matches_reference():
    """``lm_loss`` alone on logits over [patches; text] with labels a
    third masked: the reference's ``logits[:, P - 1:-1]`` against the
    labels whole, a different number from the shifted text loss."""
    cfg = tconfigs.get_config(ARCH).reduced()
    rng = np.random.default_rng(5)
    B, P, S, V = 3, cfg.n_patches, 7, cfg.vocab_size
    logits = rng.standard_normal((B, P + S, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -1
    batch = {"labels": labels, "patch_embeds": _patches(cfg, B)}
    zero = torch.zeros(())
    got, gmet = tlm_loss(cfg, torch.from_numpy(logits), batch, zero)
    want, wmet = jlm_loss(jconfigs.get_config(ARCH).reduced(),
                          jnp.asarray(logits), _jbatch(batch), 0.0)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert float(gmet["tokens"]) == float(wmet["tokens"]) == \
        (labels >= 0).sum()
    dense = dataclasses.replace(cfg, family="dense")
    text, _ = tlm_loss(dense, torch.from_numpy(logits[:, P:]), batch, zero)
    assert abs(float(text) - float(got)) > 1e-3


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_reference(variant, kv_dtype):
    """Prefill logits over [patches; prompt] and four decode steps fed
    the reference's greedy tokens, the cache's ring index at P + S plus
    the steps, and (fp32) its k/v, against the JAX model; the int8 cache
    decodes through the reference's Pallas int8-KV wrapper in interpret
    mode."""
    jm, jp, tm, tp = pair_of(variant)
    B, S = 2, 9
    cap = tm.cfg.n_patches + S + 8
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(4, 400, (B, S), np.int32),
             "patch_embeds": _patches(tm.cfg, B, seed=6)}
    jl, jc = jax.jit(lambda p, b, c: jm.prefill(p, b, c))(
        jp, _jbatch(batch), jm.init_cache(B, cap, kv_dtype=kv_dtype))
    tl, tc = tm.prefill(tp, batch, tm.init_cache(B, cap, kv_dtype=kv_dtype))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
    assert int(tc.index[0]) == tm.cfg.n_patches + S
    jdec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    atol = INT8_DECODE_ATOL if kv_dtype == "int8" else LOGIT_ATOL
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   err_msg=f"decode step {step}")
    np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
    if kv_dtype == "fp32":
        for leaf in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, leaf).numpy(),
                                       np.asarray(getattr(jc, leaf)),
                                       atol=LOGIT_ATOL, err_msg=leaf)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_matches_reference_greedy_tokens(variant, kv_dtype):
    """The port's ``Engine`` and the reference's, each with a cache of P
    + prompt + new tokens (+ 8), give the same greedy tokens."""
    from repro.core.plans import get_plan
    from repro.launch.mesh import make_host_mesh
    from repro.serve import Engine as JEngine

    jm, jp, tm, tp = pair_of(variant)
    B, S, n = 3, 6, 5
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(4, 400, (B, S), np.int32),
             "patch_embeds": _patches(tm.cfg, B, seed=8)}
    cap = tm.cfg.n_patches + S + n + 8
    mesh = make_host_mesh((1, 1), ("data", "model"))
    want = JEngine(jm, get_plan("data"), mesh, batch_size=B, max_len=cap,
                   kv_dtype=kv_dtype).generate(jp, _jbatch(batch),
                                               n_tokens=n)["tokens"]
    got = Engine(tm, batch_size=B, max_len=cap, kv_dtype=kv_dtype,
                 device="cpu").generate(tp, batch, n_tokens=n)["tokens"]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_refuses_a_cache_short_of_the_patches():
    """The prefill fills the P patches and the prompt: a cache sized for
    the prompt and the new tokens alone is refused before it would wrap
    its ring; one of P + prompt + new tokens - 1 positions serves."""
    _, _, tm, tp = pair_of("hd64")
    batch = {"tokens": np.ones((2, 6), np.int64),
             "patch_embeds": _patches(tm.cfg, 2)}
    eng = Engine(tm, batch_size=2, max_len=6 + 4, device="cpu")
    with pytest.raises(ValueError, match="cannot hold 8 patches"):
        eng.generate(tp, batch, n_tokens=4)
    ok = Engine(tm, batch_size=2, max_len=tm.cfg.n_patches + 6 + 3,
                device="cpu").generate(tp, batch, n_tokens=4)
    assert ok["tokens"].shape == (2, 4)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_serve_launcher_makes_patches(kv):
    """``launch/serve.py`` serves the family on the CPU with patch
    embeddings of its own from the prompts' generator, its cache sized
    for the patches too."""
    from repro_torch.launch import serve as tserve

    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--kv-dtype", kv])
    assert out["tokens"].shape == (2, 3)


# ------------------------------------------------------------------ #
# the plans' specs and kernel B's thread map

def _ref_specs(tree):
    from jax.sharding import PartitionSpec as P
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("plan", sorted(tplans.PLANS))
def test_param_and_optimizer_specs_equal_reference(plan):
    """Every leaf's param and optimizer specs, the projector's among
    them (whole on the model axis: ``residual`` maps to none; cut over
    the data axes by fsdp and zero's optimizer state), equal the
    reference's on meshes that cut the model and data axes, and staged
    for pipeshard."""
    jcfg = _config(jconfigs.get_config, "hd96")
    tcfg = _config(tconfigs.get_config, "hd96")
    jshapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0)))
    tshapes = TModel(tcfg, device="cpu").init(torch.Generator(),
                                              device="meta")
    jp, tp = jplans.PLANS[plan], tplans.PLANS[plan]
    axes = tpipe.STAGED_AXES if tp.pipeline else ("pod", "data", "model")
    for shape in ((1, 2, 2), (2, 2, 2)):
        jm, tm = jplans.MeshSpec.of(shape, axes), \
            tplans.MeshSpec.of(shape, axes)
        got = convert.flatten(tp.param_specs(tshapes, tcfg, tm))
        assert got == _ref_specs(jp.param_specs(jshapes, jcfg, jm)), shape
        assert convert.flatten(tp.opt_specs(tshapes, tcfg, tm)) == \
            _ref_specs(jp.opt_specs(jshapes, jcfg, jm)), shape
        assert "model" not in str(got["projector/w1"]) + \
            str(got["projector/w2"])


@pytest.mark.parametrize("D", [64, 96, 128])
def test_int8kv_thread_map_covers_each_key_and_dim_once(D):
    """Kernel B's thread map (``csrc/int8kv_attn.cu``, ``Layout``), in
    Python: 256 threads; scores by (key, quarter), a quarter D/4 bytes
    in 16-byte chunks (8-byte at D = 96, on 8-byte boundaries), a
    half-warp's reads on distinct banks; P.V by (dim quad, key phase),
    D/4 quads over NT / (D/4) phases, phase p the keys p, p + NP, ... of
    the 64-key tile.  Every (key, dim) of a tile is scored once and
    accumulated once, and no thread past the last phase takes a key."""
    NT, TILE = 256, 64
    RS = D + 16 if D == 128 else D
    CW = 16 if D % 64 == 0 else 8
    NQ = D // 4
    NP = NT // NQ
    KPP = -(-TILE // NP)
    assert (NP, KPP) == {64: (16, 4), 96: (10, 7), 128: (8, 8)}[D]
    scored = np.zeros((TILE, D), int)
    banks = {}
    for tid in range(NT):
        kj, sub = tid >> 2, tid & 3
        for u in range(D // 4 // CW):
            at = sub * (D // 4) + u * CW
            assert at % CW == 0
            scored[kj, at:at + CW] += 1
            if CW == 8 and u == 0:
                banks.setdefault(tid // 16, []).extend(
                    (kj * RS + at) // 4 % 32 + w for w in range(2))
    for b in banks.values():
        assert len(set(b)) == len(b)
    summed = np.zeros((TILE, D), int)
    for tid in range(NT):
        dq, kp = tid % NQ, tid // NQ
        if kp >= NP:
            continue
        for k in range(KPP):
            j = kp + NP * k
            if j >= TILE:
                break
            summed[j, 4 * dq:4 * dq + 4] += 1
    assert (scored == 1).all() and (summed == 1).all()


# ------------------------------------------------------------------ #
# refusals: what the reference cannot run either

def test_continuous_engine_and_train_launcher_are_refused():
    """Continuous batching serves token-only prompts, and the training
    launcher's Loader feeds tokens alone, as in the reference."""
    from repro_torch.launch import train as ttrain

    _, _, tm, _ = pair_of("hd64")
    with pytest.raises(NotImplementedError, match="modality extras"):
        ContinuousEngine(tm, slots=2, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="patch_embeds"):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--steps", "1", "--seq", "16", "--batch", "2"])
