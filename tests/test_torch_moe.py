"""The PyTorch port's MoE family (phi3.5-moe-42b-a6.6b) against the JAX
reference, on the CPU, from the reference's own weights carried across
by ``repro_torch.convert``: the configs, the MoE layer (routing choices
first, then output and aux, with and without dropped tokens), the model's
loss with its aux and every gradient leaf against ``jax.grad``, and the
greedy tokens of both engines for both KV dtypes.  Reduced config, fp32.

Tolerances and why:

* the MoE layer, fp32: the router, expert products and scatters sum in
  other orders, so outputs of O(1) agree to ~1e-6; ``MOE_ATOL`` 1e-5.
  The routing choices are integers and must be equal: were one to flip
  on a near tie, the outputs would differ by O(1), not by rounding.
* loss and gradients, fp32, two layers: as ``test_torch_train.py``
  (``LOSS_RTOL`` 1e-5; ``GRAD_RTOL`` 1e-4 of the leaf's largest entry,
  with a floor of ``LEAF_FLOOR`` of the model's largest gradient for
  leaves that are rounding noise in exact arithmetic).
"""
import dataclasses

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
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
MOE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_FLOOR = 1e-3
PROMPT_LENS = (5, 9, 9, 14)
MAX_NEW = 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and several test workers on a few cores: one
    intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): reduced
    phi3.5-MoE in fp32, the port's weights converted from the JAX ones."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                               dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, TModel(tcfg, device="cpu"), tp


@pytest.mark.parametrize("reduced", [False, True])
def test_moe_config_matches_reference(reduced):
    t, j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "moe":            # two MoEConfig classes
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.head_dim == (64 if reduced else 128)


def test_moe_params_convert_with_stacked_expert_keys(pair):
    """The reference's MoE keys map onto the port's layout: the stacked
    ``[L, E, ...]`` expert weights, the router and an untied lm_head;
    the port's own init makes the same keys and shapes."""
    jm, jp, tm, tp = pair
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(tp)
    cfg = tm.cfg
    L, E, d = cfg.n_layers, cfg.moe.n_experts, cfg.d_model
    f = cfg.moe.expert_d_ff
    assert tuple(tflat["layers/moe/router"].shape) == (L, d, E)
    assert tuple(tflat["layers/moe/w_gate"].shape) == (L, E, d, f)
    assert tuple(tflat["layers/moe/w_up"].shape) == (L, E, d, f)
    assert tuple(tflat["layers/moe/w_down"].shape) == (L, E, f, d)
    assert "lm_head/table" in tflat and not cfg.tie_embeddings
    for key, ref in jflat.items():
        np.testing.assert_array_equal(tflat[key].numpy(), ref, err_msg=key)
    mine = convert.flatten(tm.init(torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} \
        == {k: v.shape for k, v in jflat.items()}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("capacity_factor,drops", [(2.0, False),
                                                   (0.5, True)])
def test_moe_layer_matches_reference(pair, capacity_factor, drops):
    """Layer 0's MoE on [2, 32, d] tokens: the routing choices equal the
    reference's, then output and aux within ``MOE_ATOL``.  A capacity
    factor of 0.5 gives a capacity of 17 slots for 32 choices an expert
    on average, so tokens are dropped; 2.0 drops none."""
    jm, jp, tm, tp = pair
    jcfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(tm.cfg, moe=dataclasses.replace(
        tm.cfg.moe, capacity_factor=capacity_factor))
    jl = _layer0(jp["layers"]["moe"])
    tl = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    T = x.shape[0] * x.shape[1]

    # routing first: the reference's router, written out as in
    # _moe_forward_impl, against the port's
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jl["router"],
                            axis=-1)
    _, jchoice = jax.lax.top_k(jprobs, jcfg.moe.top_k)
    _, _, tchoice = tmoe.route(torch.from_numpy(x.reshape(T, -1)), tl, tcfg)
    np.testing.assert_array_equal(tchoice.numpy(), np.asarray(jchoice))
    per_expert = np.bincount(np.asarray(jchoice).ravel(),
                             minlength=jcfg.moe.n_experts)
    cap = min(max(int(capacity_factor * T * 2 / jcfg.moe.n_experts) + 1,
                  min(T, 16)), T)
    assert (per_expert.max() > cap) == drops, (per_expert, cap)

    want, jaux = jmoe._moe_forward_impl(jnp.asarray(x), jl, jcfg)
    got, taux = tmoe.moe_forward(torch.from_numpy(x), tl, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=MOE_ATOL)


def _batch(vocab, B=2, S=33, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, (B, S), np.int32)
    labels = rng.integers(4, vocab, (B, S), np.int32)
    labels[0, 5:9] = -1                     # masked positions
    return {"tokens": tokens, "labels": labels}


def test_moe_loss_and_grads_match_reference(pair):
    """``Model.loss`` with the summed aux, and every gradient leaf (the
    router's and the experts' included), against
    ``jax.grad(Model.loss)``: the ROADMAP item-10 gate for MoE."""
    jm, jp, tm, tp = pair
    batch = _batch(jm.cfg.vocab_size)
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=True), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    tloss, tmet, tg = value_and_grad(lambda p, b: tm.loss(p, b, remat=True),
                                     tp, batch)
    assert float(jmet["aux"]) > 0
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
    assert np.abs(tflat["layers/moe/router"]).max() > 0


def _by_length(prompts):
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    return groups


def _fixed_tokens(make_engine, params, prompts):
    out = {}
    for n, idxs in _by_length(prompts).items():
        res = make_engine(len(idxs)).generate(
            params, {"tokens": np.stack([prompts[i] for i in idxs])},
            n_tokens=MAX_NEW)
        for row, i in enumerate(idxs):
            out[i] = res["tokens"][row]
    return out


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_moe_engines_match_reference_greedy_tokens(pair, kv_dtype):
    """Greedy tokens of the port's ``Engine`` and ``ContinuousEngine``
    (bucketed prefill: the pad tokens take part in routing, as in the
    reference) equal the JAX engines'."""
    from repro.core.plans import get_plan
    from repro.launch.mesh import make_host_mesh
    from repro.serve import ContinuousEngine as JContinuous
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest

    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in PROMPT_LENS]
    mesh = make_host_mesh((1, 1), ("data", "model"))
    plan = get_plan("data")
    ref = _fixed_tokens(
        lambda b: JEngine(jm, plan, mesh, batch_size=b, max_len=32,
                          kv_dtype=kv_dtype), jp, prompts)
    fixed = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=32, kv_dtype=kv_dtype,
                         device="cpu"), tp, prompts)
    jres = JContinuous(jm, plan, mesh, slots=2, max_len=32, buckets=(8, 16),
                       kv_dtype=kv_dtype).run(
        jp, [JRequest(i, p) for i, p in enumerate(prompts)],
        max_new=MAX_NEW)
    tres = ContinuousEngine(tm, slots=2, max_len=32, buckets=(8, 16),
                            kv_dtype=kv_dtype, device="cpu").run(
        tp, [Request(i, p) for i, p in enumerate(prompts)], max_new=MAX_NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(fixed[i], ref[i],
                                      err_msg=f"fixed, request {i}")
        np.testing.assert_array_equal(tres["outputs"][i],
                                      jres["outputs"][i],
                                      err_msg=f"continuous, request {i}")


CAPACITY = 1.25                 # phi3.5-MoE's own; the reduced config's 2.0


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_moe_continuous_matches_reference_when_experts_drop(pair, kv_dtype,
                                                            monkeypatch):
    """At capacity factor 1.25 a prefill of 32 or 64 tokens of
    repetitive text (a few tokens repeated, which route alike) overflows
    an expert, and the prompts' own tokens are dropped, not only a pad
    tail (the stable sort keeps the earliest tokens, so dropping pads
    alone could change nothing); the port's ``ContinuousEngine`` still
    gives the reference ``ContinuousEngine``'s greedy tokens.  (Which
    tokens drop depends on the batch a token shares, so neither engine
    promises ``Engine``'s tokens here.)"""
    from repro.core.plans import get_plan
    from repro.launch.mesh import make_host_mesh
    from repro.serve import ContinuousEngine as JContinuous
    from repro.serve import Request as JRequest

    jm, jp, tm, tp = pair
    jcfg = dataclasses.replace(jm.cfg, moe=dataclasses.replace(
        jm.cfg.moe, capacity_factor=CAPACITY))
    tcfg = dataclasses.replace(tm.cfg, moe=dataclasses.replace(
        tm.cfg.moe, capacity_factor=CAPACITY))
    overflowed = []
    real_route = tmoe.route

    def route(xf, params, cfg):
        probs, gates, choices = real_route(xf, params, cfg)
        m, T = cfg.moe, xf.shape[0]
        cap = min(max(int(m.capacity_factor * T * m.top_k / m.n_experts)
                      + 1, min(T, 16)), T)
        if T > 16:                  # a prefill, all of it prompt tokens
            load = torch.bincount(choices.reshape(-1),
                                  minlength=m.n_experts)
            overflowed.append(int(load.max()) > cap)
        return probs, gates, choices

    monkeypatch.setattr(tmoe, "route", route)
    rng = np.random.default_rng(11)
    # lengths equal to the buckets, so no pad token takes part
    prompts = [np.resize(rng.integers(4, 400, (period,)), n).astype(np.int32)
               for period, n in ((1, 64), (2, 32), (3, 64), (5, 32))]
    kw = dict(slots=2, max_len=72, buckets=(32, 64), kv_dtype=kv_dtype)
    jres = JContinuous(JModel(jcfg), get_plan("data"),
                       make_host_mesh((1, 1), ("data", "model")), **kw).run(
        jp, [JRequest(i, p) for i, p in enumerate(prompts)],
        max_new=MAX_NEW)
    tres = ContinuousEngine(TModel(tcfg, device="cpu"), device="cpu",
                            **kw).run(
        tp, [Request(i, p) for i, p in enumerate(prompts)], max_new=MAX_NEW)
    assert any(overflowed), "no expert overflowed: the test sees no drop"
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tres["outputs"][i],
                                      jres["outputs"][i],
                                      err_msg=f"request {i}")
