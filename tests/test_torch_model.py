"""The PyTorch port's dense model against the JAX reference, from the
reference's own weights (carried across by ``repro_torch.convert``), on
a reduced gpt2m in fp32: configs (the SSM and hybrid ones too), forward
and prefill logits, cache contents, four decode steps for both KV
dtypes, per-slot decode, and checkpoint loading."""
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

# fp32 on both sides through two layers: matmuls and softmaxes sum in
# other orders, so logits of O(1) agree to ~1e-5; 1e-4 leaves headroom
# for the decode steps, which feed cached k/v back in.
LOGIT_ATOL = 1e-4
# int8 KV: k/v agree only to fp32 rounding, so now and then one payload
# entry rounds to the neighbouring int8 step in one framework (seen: 1 of
# 45056 in the prefill below).  One step moves a key by its scale
# (absmax/127, ~1% of the key) and a decode logit by ~1e-4; 1e-3 bounds a
# few such flips.
INT8_DECODE_ATOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) on one set of
    weights: reduced gpt2m, fp32 compute."""
    jcfg = dataclasses.replace(jconfigs.get_config("gpt2m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("gpt2m").reduced(),
                               dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = TModel(tcfg, device="cpu")
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


@pytest.mark.parametrize("name", ["gpt2m", "gpt2L", "gpt2l",
                                  "falcon-mamba-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(name, reduced):
    t, j = tconfigs.get_config(name), jconfigs.get_config(name)
    if reduced:
        t, j = t.reduced(), j.reduced()
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "ssm" and got is not None:   # two SSMConfig classes
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    if name.startswith("gpt2") or reduced:
        assert t.head_dim == 64
    if name == "zamba2-2.7b" and not reduced:
        assert t.head_dim == 80       # the shared attention's: 2560 / 32


def test_other_families_raise():
    """The port's registry holds every architecture of the reference's
    (the vision-language one last); an unknown one raises."""
    assert sorted(tconfigs.ARCH_CONFIGS) == sorted(jconfigs.ARCH_CONFIGS)
    assert tconfigs.get_config("phi-3-vision-4.2b").family == "vlm"
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def test_init_shapes_and_laws_match_reference(pair):
    jm, jp, tm, tp = pair
    mine = tm.init(torch.Generator().manual_seed(0))
    jflat = convert.flatten(jax.tree.map(np.asarray, jp))
    tflat = convert.flatten(mine)
    assert sorted(jflat) == sorted(tflat)
    for key, ref in jflat.items():
        got = tflat[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        # same law: truncated normal at the same std (zeros/ones equal)
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            assert abs(got.std() / ref.std() - 1) < 0.05, key
            assert np.abs(got).max() <= 3 * ref.std() * 1.1, key


def test_flat_and_nested_conversion_agree(pair):
    _, jp, _, tp = pair
    flat = convert.flatten(jax.tree.map(np.asarray, jp))
    assert "layers/attn/wq" in flat and "embed/table" in flat
    again = convert.flatten(convert.params_from_numpy(flat))
    for k, v in convert.flatten(tp).items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(4, 400, (2, 19), np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    got = tm.forward(tp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


def _cache_np(cache):
    return {f: np.asarray(getattr(cache, f)) for f in cache._fields}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_prefill_cache_and_decode_match_reference(pair, kv_dtype):
    """Prefill logits and cache, then four greedy decode steps (the
    reference's tokens fed to both), against the JAX model."""
    jm, jp, tm, tp = pair
    B, S, cap = 2, 11, 24
    toks = np.random.default_rng(1).integers(4, 400, (B, S), np.int32)
    jpre = jax.jit(lambda p, b, c: jm.prefill(p, b, c))
    jdec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)},
                  jm.init_cache(B, cap, kv_dtype=kv_dtype))
    tl, tc = tm.prefill(tp, {"tokens": toks},
                        tm.init_cache(B, cap, kv_dtype=kv_dtype))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    jcn, tcn = _cache_np(jc), _cache_np(tc)
    assert set(jcn) == set(tcn)
    np.testing.assert_array_equal(tcn["index"], jcn["index"])
    if kv_dtype == "int8":
        # k/v agree to fp32 rounding, so a payload may sit one step
        # across a rounding edge; the dequantized cache agrees closely
        for n in ("k", "v"):
            tq, ts = tcn[f"{n}_q"], tcn[f"{n}_scale"]
            jq, js = jcn[f"{n}_q"], jcn[f"{n}_scale"]
            np.testing.assert_allclose(
                tq.astype(np.float32) * ts[..., None],
                jq.astype(np.float32) * js[..., None], atol=2 * js.max())
            assert np.mean(tq != jq) < 1e-3
            np.testing.assert_allclose(ts, js, rtol=1e-5)
    else:
        for n in ("k", "v"):
            np.testing.assert_allclose(tcn[n], jcn[n], atol=1e-5)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for step in range(4):
        jl, jc = jdec(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl), err_msg=f"decode step {step}",
            atol=INT8_DECODE_ATOL if kv_dtype == "int8" else LOGIT_ATOL)
        np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_ring_prefill_past_capacity_matches_reference(pair):
    """A window smaller than the prompt: the ring keeps the newest
    ``cap`` tokens in slot = pos % cap order, as the reference does."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(2).integers(4, 400, (1, 13), np.int32)
    jl, jc = jax.jit(lambda p, b, c: jm.prefill(p, b, c, window=8))(
        jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 32, window=8))
    tl, tc = tm.prefill(tp, {"tokens": toks}, tm.init_cache(1, 32, window=8),
                        window=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
    np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))


def test_slot_cache_decode_matches_reference(pair):
    """Per-slot [B] indices (continuous batching): each row appends at
    its own position and reads its own learned position."""
    jm, jp, tm, tp = pair
    B, cap = 3, 16
    rng = np.random.default_rng(4)
    jc = jm.init_slot_cache(B, cap, kv_dtype="int8")
    tc = tm.init_slot_cache(B, cap, kv_dtype="int8")
    assert tuple(tc.index.shape) == tuple(jc.index.shape) == (2, B)
    fill = np.array([3, 0, 7], np.int32)
    jc = jc._replace(index=jnp.broadcast_to(jnp.asarray(fill), (2, B)))
    tc = tc._replace(index=torch.from_numpy(fill).expand(2, B).clone())
    for step in range(2):
        tok = rng.integers(4, 400, (B, 1), np.int32)
        jl, jc = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))(
            jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=INT8_DECODE_ATOL)
        np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))


def test_reference_checkpoint_loads(pair, tmp_path):
    from repro.train.checkpoint import save_checkpoint

    _, jp, _, tp = pair
    path = save_checkpoint(str(tmp_path), 3, jp, n_files=3)
    got = convert.load_checkpoint(path)
    tflat = convert.flatten(tp)
    for k, v in convert.flatten(got).items():
        torch.testing.assert_close(v, tflat[k], rtol=0, atol=0)
    assert sorted(convert.flatten(got)) == sorted(tflat)
    # a truncated shard fails its checksum loudly
    shard = tmp_path / "step_00000003" / "params_00.npz"
    shard.write_bytes(shard.read_bytes()[:-7])
    with pytest.raises(ValueError, match="sha256"):
        convert.load_checkpoint(path)
