"""The PyTorch port's llama3.2-3b against the JAX reference, on the CPU,
from the reference's own weights carried across by ``repro_torch.convert``:
the configs, forward, prefill and decode logits (RMSNorm, SwiGLU, RoPE
and GQA), the greedy tokens of the port's ``Engine`` against the JAX
``Engine`` for both KV dtypes, and the port's ``ContinuousEngine``
bit-identical to its fixed-batch ``Engine`` on the reference's own
continuous-batching contract (``tests/test_serving.py``: reduced llama,
vocab 512, bf16).  Reduced config, fp32 unless said.

Tolerances as in ``test_torch_model.py``: fp32 logits of O(1) through
two layers agree to ~1e-5 (sums in other orders), held to
``LOGIT_ATOL`` 1e-4; with an int8 KV cache a payload entry may round to
the neighbouring int8 step in one framework, which moves a decode logit
by ~1e-4, held to ``INT8_DECODE_ATOL`` 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.serve import ContinuousEngine, Engine, Request  # noqa: E402

ARCH = "llama3.2-3b"
LOGIT_ATOL = 1e-4
INT8_DECODE_ATOL = 1e-3
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


def _pair(**overrides):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                               **overrides)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                               **overrides)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, TModel(tcfg, device="cpu"), tp


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params): reduced
    llama3.2-3b in fp32."""
    return _pair(dtype="float32")


@pytest.mark.parametrize("reduced", [False, True])
def test_llama_config_matches_reference(reduced):
    t, j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count()
    # the full model: GQA, 24 heads of 128 over 8 KV heads (group 3)
    assert (t.head_dim, t.n_heads // t.n_kv_heads) == \
        ((64, 1) if reduced else (128, 3))


def test_llama_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(4, 400, (2, 19), np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    got = tm.forward(tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_llama_prefill_and_decode_match_reference(pair, kv_dtype):
    """Prefill logits, then four decode steps fed the reference's greedy
    tokens, against the JAX model."""
    jm, jp, tm, tp = pair
    B, S, cap = 2, 11, 24
    toks = np.random.default_rng(1).integers(4, 400, (B, S), np.int32)
    jl, jc = jax.jit(lambda p, b, c: jm.prefill(p, b, c))(
        jp, {"tokens": jnp.asarray(toks)},
        jm.init_cache(B, cap, kv_dtype=kv_dtype))
    tl, tc = tm.prefill(tp, {"tokens": toks},
                        tm.init_cache(B, cap, kv_dtype=kv_dtype))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    jdec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    atol = INT8_DECODE_ATOL if kv_dtype == "int8" else LOGIT_ATOL
    for step in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))


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


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_llama_engine_matches_reference_greedy_tokens(pair, kv_dtype):
    from repro.core.plans import get_plan
    from repro.launch.mesh import make_host_mesh
    from repro.serve import Engine as JEngine

    jm, jp, tm, tp = pair
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in PROMPT_LENS]
    mesh = make_host_mesh((1, 1), ("data", "model"))
    ref = _fixed_tokens(
        lambda b: JEngine(jm, get_plan("data"), mesh, batch_size=b,
                          max_len=32, kv_dtype=kv_dtype), jp, prompts,
        MAX_NEW)
    got = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=32, kv_dtype=kv_dtype,
                         device="cpu"), tp, prompts, MAX_NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"request {i}")


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_llama_continuous_bit_exact_vs_fixed(kv_dtype):
    """The reference's contract (``tests/test_serving.py``, reduced llama
    at vocab 512 in its bf16 compute) on the port: per-request greedy
    tokens of ``ContinuousEngine`` (mixed prompt lengths, slot churn,
    bucketed prefill) equal the fixed-batch ``Engine``'s bit for bit."""
    _, _, tm, tp = _pair(vocab_size=512)
    assert tm.compute_dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in (5, 9, 9, 13, 5, 7)]
    max_new = 6
    ref = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=64, kv_dtype=kv_dtype,
                         device="cpu"), tp, prompts, max_new)
    ce = ContinuousEngine(tm, slots=3, max_len=64, buckets=(8, 16, 32),
                          kv_dtype=kv_dtype, device="cpu")
    res = ce.run(tp, [Request(i, p) for i, p in enumerate(prompts)],
                 max_new=max_new)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(res["outputs"][i], ref[i],
                                      err_msg=f"request {i} diverged")
    st = res["stats"]
    assert st.n_tokens == max_new * len(prompts)
    assert 0 < st.mean_occupancy <= 3 and len(st.ttft_s) == len(prompts)
