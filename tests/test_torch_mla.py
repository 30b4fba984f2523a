"""The PyTorch port's Multi-head Latent Attention models (minicpm3-4b,
dense, and deepseek-v2-236b, MoE) and the two dense configs that reuse
llama3.2's blocks (phi4-mini-3.8b, llama3-405b) against the JAX
reference, on the CPU, from the reference's own weights carried across
by ``repro_torch.convert``: the configs and parameter counts, the init
trees, forward, prefill and decode logits, the latent cache (a prompt
longer than the ring included), the greedy tokens of the port's
``Engine`` against the JAX ``Engine``, the port's ``ContinuousEngine``
bit-identical to its ``Engine`` on the reference's contract, one
training step's loss and gradients against ``jax.grad``, the refusal
of an int8 cache, and every plan at a gloo world of one against one
device.  Reduced configs, fp32 unless said.

Cases beyond the reduced configs: ``reduced()`` sets ``q_lora_rank`` to
0, so "minicpm3-qlora" restores a low-rank query (24) to reach ``w_dq``
and ``q_norm``; it forces top-2 routing, so "deepseek-top6" routes six of
eight experts at a capacity factor of 2.0 >= E / k (no drops) to reach
the ordered combine, its routing choices compared first.

Tolerances as in ``test_torch_llama.py`` and ``test_torch_moe.py``:
fp32 logits of O(1) through two layers agree to ~1e-6 (sums in other
orders), held to ``LOGIT_ATOL`` 1e-4; the MoE layer to ``MOE_ATOL``
1e-5; the loss to 1e-5 relative and each gradient leaf to 1e-4 of its
largest entry, with a floor of 1e-3 of the model's largest gradient.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.steps import value_and_grad  # noqa: E402
from repro_torch.kernels.flash_attention import FWD_HEAD_DIMS  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_plan_worker as plan_worker  # noqa: E402

LOGIT_ATOL = 1e-4
MOE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_FLOOR = 1e-3
PROMPT_LENS = (5, 9, 9)
MAX_NEW = 4
NEW_ARCHS = ("minicpm3-4b", "deepseek-v2-236b", "phi4-mini-3.8b",
             "llama3-405b")
# case -> (arch, changes to its reduced config)
CASES = {
    "minicpm3": ("minicpm3-4b", {}),
    "minicpm3-qlora": ("minicpm3-4b", {"q_lora_rank": 24}),
    "deepseek": ("deepseek-v2-236b", {}),
    "deepseek-top6": ("deepseek-v2-236b", {"n_experts": 8, "top_k": 6}),
    "phi4-mini": ("phi4-mini-3.8b", {}),
    "llama3-405b": ("llama3-405b", {}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and several test workers on a few cores: one
    intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(get_config, case, **overrides):
    arch, change = CASES[case]
    cfg = get_config(arch).reduced()
    kw = dict(overrides)
    if "q_lora_rank" in change:
        kw["mla"] = dataclasses.replace(cfg.mla,
                                        q_lora_rank=change["q_lora_rank"])
    if "top_k" in change:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=change["n_experts"], top_k=change["top_k"],
            capacity_factor=2.0)
    return dataclasses.replace(cfg, **kw)


def _pair(case, **overrides):
    """(JAX model, JAX params, port model, port params) of a case, the
    port's weights converted from the JAX ones."""
    jm = JModel(_config(jconfigs.get_config, case, **overrides))
    jp = jm.init(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    tm = TModel(_config(tconfigs.get_config, case, **overrides),
                device="cpu")
    return jm, jp, tm, tp


_PAIRS = {}


def pair_of(case):
    """The fp32 pair of a case, built once per module."""
    if case not in _PAIRS:
        _PAIRS[case] = _pair(case, dtype="float32")
    return _PAIRS[case]


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    """Field for field (the MLA and MoE sub-configs as dicts: two classes
    each), and both parameter counts."""
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert _asdict(getattr(t, f.name)) == _asdict(getattr(j, f.name)), \
            f.name
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.mla is None) == (arch in ("phi4-mini-3.8b", "llama3-405b"))


def test_registry_holds_the_new_configs_and_refuses_the_rest():
    """The new configs are registered, and with the VLM every config of
    the reference's registry; the rest (unknown names) raise."""
    for arch in NEW_ARCHS:
        assert tconfigs.get_config(arch).name == arch
    assert sorted(tconfigs.ARCH_CONFIGS) == sorted(jconfigs.ARCH_CONFIGS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("phi-3-vision")


def test_full_size_split_head_dims():
    """The (Dk, Dv) pairs kernel A is built for at full size: nope + rope
    over v."""
    for arch, pair in (("minicpm3-4b", (96, 64)),
                       ("deepseek-v2-236b", (192, 128))):
        m = tconfigs.get_config(arch).mla
        assert (m.nope_head_dim + m.rope_head_dim, m.v_head_dim) == pair
        assert pair in FWD_HEAD_DIMS


@pytest.mark.parametrize("case", ["minicpm3-qlora", "deepseek-top6"])
def test_init_shapes_and_laws_match_reference(case):
    """The port's own init makes the reference's MLA (and MoE) keys,
    shapes and laws: truncated normal at the same std, norms ones."""
    jm, jp, tm, _ = pair_of(case)
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(tm.init(torch.Generator().manual_seed(0)))
    assert sorted(jflat) == sorted(tflat)
    for key, ref in jflat.items():
        got = tflat[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert abs(got.std() / ref.std() - 1) < 0.05, key
            assert np.abs(got).max() <= 3 * ref.std() * 1.1, key


@pytest.mark.parametrize("case", ["minicpm3-qlora", "deepseek-top6"])
def test_params_carry_across_exactly(case):
    """``convert`` maps the reference's MLA and DeepSeek trees by path:
    every leaf equal, the MLA leaves where ``core.sharding`` names
    them."""
    jm, jp, tm, tp = pair_of(case)
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(tp)
    assert sorted(jflat) == sorted(tflat)
    for key, ref in jflat.items():
        np.testing.assert_array_equal(tflat[key].numpy(), ref, err_msg=key)
    cfg = tm.cfg
    m, L, H = cfg.mla, cfg.n_layers, cfg.n_heads
    q_in = m.q_lora_rank or cfg.d_model
    want = {"w_uq": (L, q_in, H, m.nope_head_dim + m.rope_head_dim),
            "w_dkv": (L, cfg.d_model, m.kv_lora_rank),
            "kv_norm": (L, m.kv_lora_rank),
            "w_kr": (L, cfg.d_model, m.rope_head_dim),
            "w_uk": (L, H, m.kv_lora_rank, m.nope_head_dim),
            "w_uv": (L, H, m.kv_lora_rank, m.v_head_dim),
            "wo": (L, H, m.v_head_dim, cfg.d_model)}
    if m.q_lora_rank:
        want.update(w_dq=(L, cfg.d_model, m.q_lora_rank),
                    q_norm=(L, m.q_lora_rank))
    assert {k for k in tflat if k.startswith("layers/mla/")} == \
        {f"layers/mla/{leaf}" for leaf in want}
    for leaf, shape in want.items():
        assert tuple(tflat[f"layers/mla/{leaf}"].shape) == shape, leaf
    assert not any(k.startswith("layers/attn/") for k in tflat)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_reference(case):
    """Forward logits, and ``Model.loss`` (with the MoE aux) against the
    reference's ``lm_loss`` of its own logits and aux."""
    from repro.models.model import lm_loss as jlm_loss

    jm, jp, tm, tp = pair_of(case)
    batch = _batch(400, S=19)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(batch["tokens"])},
                            remat=False)
    got = tm.forward(tp, {"tokens": batch["tokens"]})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    jloss, _ = jlm_loss(jm.cfg, want, jax.tree.map(jnp.asarray, batch), jaux)
    tloss, _ = tm.loss(tp, batch, remat=False)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def _prefill_and_decode(case, B, S, cap, steps=4, seed=1):
    """Prefill logits, then ``steps`` decode steps fed the reference's
    greedy tokens, against the JAX model; returns both final caches."""
    jm, jp, tm, tp = pair_of(case)
    toks = np.random.default_rng(seed).integers(4, 400, (B, S), np.int32)
    jl, jc = jax.jit(lambda p, b, c: jm.prefill(p, b, c))(
        jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(B, cap))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.init_cache(B, cap))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    jdec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
    return tc, jc


@pytest.mark.parametrize("case", [c for c in CASES if c != "llama3-405b"])
def test_prefill_and_decode_match_reference(case):
    """Prefill and four decode steps (llama3-405b's reduced blocks are
    phi4-mini's but for rope theta and the untied head: its forward
    logits above cover it)."""
    tc, jc = _prefill_and_decode(case, B=2, S=11, cap=24)
    if CASES[case][0] in ("minicpm3-4b", "deepseek-v2-236b"):
        assert isinstance(tc, tattn.MLACache)
        for leaf in ("c_kv", "k_rope"):
            np.testing.assert_allclose(getattr(tc, leaf).numpy(),
                                       np.asarray(getattr(jc, leaf)),
                                       atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("case", ["minicpm3", "deepseek-top6"])
def test_prefill_longer_than_the_cache_rolls_the_ring(case):
    """A prompt of 21 tokens into a ring of 8 slots keeps its last 8 in
    slot = pos % 8 layout, as the reference rolls them; decode then
    overwrites the oldest."""
    tc, jc = _prefill_and_decode(case, B=2, S=21, cap=8, steps=3, seed=2)
    assert tc.c_kv.shape[2] == 8
    np.testing.assert_allclose(tc.c_kv.numpy(), np.asarray(jc.c_kv),
                               atol=1e-5)
    np.testing.assert_allclose(tc.k_rope.numpy(), np.asarray(jc.k_rope),
                               atol=1e-5)


def test_latent_cache_is_compressed():
    """``tests/test_models.py``'s MLA cache contract on the port: stacked
    [L, B, S, R] latent and [L, B, S, rope] key, smaller than a full
    K/V cache; the per-slot cache widens the index to [L, B]."""
    tm = TModel(tconfigs.get_config("minicpm3-4b").reduced(), device="cpu")
    cfg = tm.cfg
    cache = tm.init_cache(2, 64)
    assert tuple(cache.c_kv.shape) == (cfg.n_layers, 2, 64,
                                       cfg.mla.kv_lora_rank)
    assert tuple(cache.k_rope.shape) == (cfg.n_layers, 2, 64,
                                         cfg.mla.rope_head_dim)
    assert cache.c_kv.shape[-1] + cache.k_rope.shape[-1] \
        < 2 * cfg.n_kv_heads * cfg.head_dim
    assert tuple(tm.init_slot_cache(3, 16).index.shape) == (cfg.n_layers, 3)


def test_int8_cache_is_refused():
    tm = TModel(tconfigs.get_config("deepseek-v2-236b").reduced(),
                device="cpu")
    with pytest.raises(ValueError, match="with MLA"):
        tm.init_cache(2, 16, kv_dtype="int8")
    with pytest.raises(ValueError, match="with MLA"):
        Engine(tm, batch_size=2, max_len=16, kv_dtype="int8",
               device="cpu").generate(
            tm.init(torch.Generator().manual_seed(0)),
            {"tokens": np.ones((2, 4), np.int64)}, n_tokens=2)


def test_top6_moe_layer_routes_and_combines_as_reference():
    """Layer 0's MoE at top-6 of 8 experts on [2, 32, d] tokens: the
    routing choices equal the reference's, then output and aux within
    ``MOE_ATOL``; the ordered combine gives the same bits on a rerun."""
    jm, jp, tm, tp = pair_of("deepseek-top6")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    tl = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 32, tm.cfg.d_model)).astype(np.float32)
    T = x.shape[0] * x.shape[1]
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jl["router"],
                            axis=-1)
    _, jchoice = jax.lax.top_k(jprobs, 6)
    _, _, tchoice = tmoe.route(torch.from_numpy(x.reshape(T, -1)), tl,
                               tm.cfg)
    np.testing.assert_array_equal(tchoice.numpy(), np.asarray(jchoice))
    want, jaux = jax.jit(lambda x, p: jmoe._moe_forward_impl(x, p, jm.cfg))(
        jnp.asarray(x), jl)
    got, taux = tmoe.moe_forward(torch.from_numpy(x), tl, tm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=MOE_ATOL)
    again, _ = tmoe.moe_forward(torch.from_numpy(x), tl, tm.cfg)
    assert torch.equal(got, again)


def _batch(vocab, B=2, S=33, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, (B, S), np.int32)
    labels = rng.integers(4, vocab, (B, S), np.int32)
    labels[0, 5:9] = -1                     # masked positions
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("case", ["minicpm3-qlora", "deepseek-top6"])
def test_loss_and_grads_match_reference(case):
    """``Model.loss`` (with the MoE aux) and every gradient leaf, the
    MLA leaves included, against ``jax.grad(Model.loss)``."""
    jm, jp, tm, tp = pair_of(case)
    batch = _batch(jm.cfg.vocab_size)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=True), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tg = value_and_grad(lambda p, b: tm.loss(p, b, remat=True),
                                     tp, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for key in ("ce", "aux", "zloss", "accuracy", "tokens"):
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
    for key in tflat:
        if key.startswith("layers/mla/"):
            assert np.abs(tflat[key]).max() > 0, key


def _fixed_tokens(make_engine, params, prompts, max_new):
    """Greedy tokens per prompt from fixed-batch engines, one per prompt
    length (a batch shares its prompt length)."""
    groups, out = {}, {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    for idxs in groups.values():
        res = make_engine(len(idxs)).generate(
            params, {"tokens": np.stack([prompts[i] for i in idxs])},
            n_tokens=max_new)
        for row, i in enumerate(idxs):
            out[i] = res["tokens"][row]
    return out


@pytest.mark.parametrize("case", ["minicpm3-qlora", "deepseek"])
def test_engine_matches_reference_greedy_tokens(case):
    from repro.core.plans import get_plan
    from repro.launch.mesh import make_host_mesh
    from repro.serve import Engine as JEngine

    jm, jp, tm, tp = pair_of(case)
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in PROMPT_LENS]
    mesh = make_host_mesh((1, 1), ("data", "model"))
    ref = _fixed_tokens(
        lambda b: JEngine(jm, get_plan("data"), mesh, batch_size=b,
                          max_len=32), jp, prompts, MAX_NEW)
    got = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=32, device="cpu"), tp,
        prompts, MAX_NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"request {i}")


def test_continuous_bit_exact_vs_fixed():
    """The reference's contract (``tests/test_serving.py``: vocab 512, its
    bf16 compute) on the port's reduced minicpm3 with a low-rank query:
    per-request greedy tokens of ``ContinuousEngine`` (mixed prompt
    lengths, slot churn, bucketed prefill into the latent cache, per-slot
    indices) equal the fixed-batch ``Engine``'s bit for bit."""
    _, _, tm, tp = _pair("minicpm3-qlora", vocab_size=512)
    assert tm.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in (5, 9, 9, 13, 5, 7)]
    max_new = 6
    ref = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=64, device="cpu"), tp,
        prompts, max_new)
    ce = ContinuousEngine(tm, slots=3, max_len=64, buckets=(8, 16, 32),
                          device="cpu")
    res = ce.run(tp, [Request(i, p) for i, p in enumerate(prompts)],
                 max_new=max_new)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res["outputs"][i], ref[i],
                                      err_msg=f"request {i} diverged")
    st = res["stats"]
    assert st.n_tokens == max_new * len(prompts)
    assert 0 < st.mean_occupancy <= 3 and len(st.ttft_s) == len(prompts)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b"])
@pytest.mark.parametrize("plan", ["data", "shard", "fsdp", "pipeshard"])
def test_mla_under_a_plan_raises_naming_its_item(arch, plan):
    """MLA runs under every plan since ROADMAP queue 1, item 13: at a
    gloo world of one, training (``build_train_step``) gives one device's
    losses over two steps, bit for bit under the flat plans, and serving
    (``ServePlan``, which both engines build under a plan) gives one
    device's greedy tokens.  The gloo worlds of several ranks hold the
    cuts (``test_torch_plan_families.py``, ``test_torch_pipeline.py``,
    ``test_torch_serve_families.py``).  (Named for the refusal it held
    until then.)"""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype="float32")
    got, want, same = plan_worker.steps_at_world_of_one(cfg, plan)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    if plan != "pipeshard":
        assert got == want and same
    model = TModel(cfg, device="cpu")
    params = plan_worker.init_params(model)
    prompts = {"tokens": np.random.default_rng(3).integers(4, 400, (3, 9))}
    with plan_worker.world_of_one():
        eng = Engine(model, batch_size=3, max_len=32, device="cpu",
                     plan=plan, mesh=plan_worker.mesh_of_one(plan))
        tokens = eng.generate(eng.shard_params(params), prompts,
                              MAX_NEW)["tokens"]
    one = Engine(model, batch_size=3, max_len=32, device="cpu")
    np.testing.assert_array_equal(
        tokens, one.generate(params, prompts, MAX_NEW)["tokens"])


def test_dense_configs_without_mla_are_not_refused_by_plans():
    """phi4-mini and llama3-405b are llama3.2's blocks, which every plan
    runs (``test_torch_plans.py``): under shard at a gloo world of one
    two steps repeat one device's bits."""
    for arch in ("phi4-mini-3.8b", "llama3-405b"):
        cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                  dtype="float32")
        got, want, same = plan_worker.steps_at_world_of_one(cfg, "shard")
        assert got == want and same, arch
