"""Parity checks of the PyTorch port's SSM (falcon-mamba) and hybrid
(zamba2) families against the JAX package, shared by
``test_torch_ssm.py`` and ``test_torch_hybrid.py``.

Both sides run a reduced config in fp32 from the JAX package's weights,
carried across by ``repro_torch.convert``.  On the CPU the port's default
path (``use_kernels=True``) runs the scans' plain sequential versions;
``use_kernels=False`` runs its ports of the reference's chunked scans.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine, Engine, Request
from repro_torch.serve.steps import decode_slots_step, insert_step

# fp32 on both sides through two layers.  The scans sum in other orders
# (sequential recurrence, log-step prefix scan, chunked block
# decomposition), and so do the matmuls; logits of O(1) agree to ~1e-5,
# and 1e-4 leaves headroom for decode steps that feed the state back in.
LOGIT_ATOL = 1e-4
# cache contents: O(1) states after a handful of fp32 steps
STATE_ATOL = 1e-5
PROMPT_LENS = (5, 9, 9, 14)
MAX_NEW = 5


class Pair:
    """(JAX model, JAX params, port model, port params, mesh) on one set
    of weights, reduced ``arch`` in fp32, with jitted JAX steps."""

    def __init__(self, arch: str):
        from repro.launch.mesh import make_host_mesh

        self.arch = arch
        jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                   dtype="float32")
        self.jm = JModel(jcfg)
        self.mesh = make_host_mesh((1, 1), ("data", "model"))
        with jax.set_mesh(self.mesh):
            self.jp = self.jm.init(jax.random.key(0))
        self.tm = TModel(tcfg, device="cpu")
        self.tp = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                         self.jp))
        self.jpre = jax.jit(lambda p, b, c: self.jm.prefill(p, b, c))
        self.jdec = jax.jit(lambda p, c, t: self.jm.decode_step(p, c, t))


def tokens(seed: int, shape):
    return np.random.default_rng(seed).integers(4, 400, shape, np.int32)


def cache_np(cache):
    """Flat {path: array} of a JAX or port cache (NamedTuples, dicts)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, tuple):
            for f in node._fields:
                walk(getattr(node, f), f"{prefix}{f}/")
        else:
            out[prefix[:-1]] = np.asarray(node)

    walk(cache, "")
    return out


def assert_caches_close(got, want, what: str):
    g, w = cache_np(got), cache_np(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        assert g[k].shape == w[k].shape, f"{what}: {k}"
        if k.endswith("index"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(g[k], w[k], atol=STATE_ATOL,
                                       err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ #
def check_param_tree(pair: Pair):
    """The port's init makes the reference's tree (keys, shapes, dtypes)
    with its init laws; constant leaves agree to fp32 rounding of
    log/expm1."""
    mine = convert.flatten(pair.tm.init(torch.Generator().manual_seed(0)))
    ref = convert.flatten(jax.tree.map(np.asarray, pair.jp))
    assert sorted(mine) == sorted(ref)
    for key, want in ref.items():
        got = mine[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.std() == 0 or key.endswith("A_log"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        else:
            assert abs(got.std() / want.std() - 1) < 0.1, key
    # and the reference's weights cross as they are
    again = convert.flatten(pair.tp)
    assert sorted(again) == sorted(ref)


def check_forward(pair: Pair):
    """Forward logits: the port's kernel path (plain scans on the CPU)
    and its reference-algorithm path, against the JAX model's jnp and
    Pallas (interpret) paths."""
    toks = tokens(0, (2, 37))                  # 37: not a chunk multiple
    want, _ = pair.jm.forward(pair.jp, {"tokens": jnp.asarray(toks)},
                              remat=False)
    pallas, _ = JModel(pair.jm.cfg, use_pallas=True).forward(
        pair.jp, {"tokens": jnp.asarray(toks)}, remat=False)
    plain = TModel(pair.tm.cfg, device="cpu", use_kernels=False)
    for name, got in (("kernel path", pair.tm.forward(pair.tp,
                                                      {"tokens": toks})),
                      ("reference path", plain.forward(pair.tp,
                                                       {"tokens": toks}))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   atol=LOGIT_ATOL, err_msg=f"{name} (Pallas)")


def check_prefill_and_decode(pair: Pair, S: int):
    """Prefill logits and every cache leaf (conv state, h, and the
    hybrid's KV ring), then four greedy decode steps fed the reference's
    tokens."""
    B, cap = 2, 48
    toks = tokens(S, (B, S))
    jl, jc = pair.jpre(pair.jp, {"tokens": jnp.asarray(toks)},
                       pair.jm.init_cache(B, cap))
    tl, tc = pair.tm.prefill(pair.tp, {"tokens": toks},
                             pair.tm.init_cache(B, cap))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert_caches_close(tc, jc, f"prefill S={S}")
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    for step in range(4):
        jl, jc = pair.jdec(pair.jp, jc, jnp.asarray(tok))
        tl, tc = pair.tm.decode_step(pair.tp, tc, tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert_caches_close(tc, jc, f"after 4 decode steps, S={S}")


def _fixed_tokens(make_engine, params, prompts):
    """Greedy tokens per prompt from fixed-batch engines, one per prompt
    length (a batch shares its prompt length)."""
    groups, out = {}, {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    for idxs in groups.values():
        res = make_engine(len(idxs)).generate(
            params, {"tokens": np.stack([prompts[i] for i in idxs])},
            n_tokens=MAX_NEW)
        for row, i in enumerate(idxs):
            out[i] = res["tokens"][row]
    return out


def check_engines(pair: Pair):
    """Greedy tokens of the port's two engines equal the JAX engine's,
    and the continuous engine (exact-length prefill) equals the port's
    fixed engine token for token."""
    from repro.core.plans import get_plan
    from repro.serve import Engine as JEngine

    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in PROMPT_LENS]
    ref = _fixed_tokens(
        lambda b: JEngine(pair.jm, get_plan("data"), pair.mesh, batch_size=b,
                          max_len=32), pair.jp, prompts)
    fixed = _fixed_tokens(
        lambda b: Engine(pair.tm, batch_size=b, max_len=32, device="cpu"),
        pair.tp, prompts)
    ce = ContinuousEngine(pair.tm, slots=2, max_len=32, buckets=(8, 16),
                          device="cpu")
    assert ce.exact_prefill
    res = ce.run(pair.tp, [Request(i, p) for i, p in enumerate(prompts)],
                 max_new=MAX_NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(fixed[i], ref[i],
                                      err_msg=f"fixed, request {i}")
        np.testing.assert_array_equal(res["outputs"][i], fixed[i],
                                      err_msg=f"continuous, request {i}")
    assert res["stats"].n_tokens == MAX_NEW * len(prompts)


def check_slot_steps(pair: Pair):
    """``insert_step`` puts a batch-1 prefill into one slot (batch axis 1
    of ``[L, B, ...]`` leaves, 2 of the hybrid's ``[G, k, B, ...]`` SSM
    state) and leaves the others; ``decode_slots_step`` then decodes the
    live slot as a batch-1 decode from the same state would, emits the
    pad for dead slots and freezes their ring indices."""
    tm, tp = pair.tm, pair.tp
    prompt = tokens(7, (1, 6))
    cache = tm.init_slot_cache(3, 16)
    _, src = tm.prefill(tp, {"tokens": prompt}, tm.init_cache(1, 16))
    want_src = cache_np(src)
    cache = insert_step(cache, src, 1, 6)
    got = cache_np(cache)
    for k, v in want_src.items():
        if k.endswith("index"):
            assert (got[k][..., 1] == 6).all() and (got[k][..., [0, 2]]
                                                    == 0).all(), k
            continue
        axis = next(i for i, (m, n) in enumerate(zip(got[k].shape, v.shape))
                    if m != n)
        np.testing.assert_array_equal(np.take(got[k], 1, axis),
                                      np.take(v, 0, axis), err_msg=k)
        assert not np.take(got[k], [0, 2], axis).any(), k
    live = torch.tensor([False, True, False])
    tok = torch.tensor([[0], [11], [0]])
    logits, nxt, cache = decode_slots_step(tm, tp, cache, tok, live,
                                           pad_id=0)
    one, _ = tm.decode_step(tp, src, tok[1:2])
    torch.testing.assert_close(logits[1:2], one, rtol=0, atol=1e-5)
    assert nxt[0, 0] == 0 and nxt[2, 0] == 0
    assert nxt[1, 0] == int(one.argmax(-1)[0])
    for k, v in cache_np(cache).items():
        if k.endswith("index"):
            assert (v[..., 1] == 7).all() and (v[..., [0, 2]] == 0).all(), k


def check_int8_refused(pair: Pair):
    for make in (pair.tm.init_cache, pair.tm.init_slot_cache):
        with pytest.raises(ValueError, match="no quantizable k/v"):
            make(1, 8, kv_dtype="int8")
    with pytest.raises(ValueError, match="no quantizable k/v"):
        pair.jm.init_cache(1, 8, kv_dtype="int8")
