"""The PyTorch port's hybrid family (zamba2, reduced, fp32) against the
JAX package: the parameter tree (``layers/blocks`` as ``[G, k, ...]``,
``layers/gates``, ``shared``), forward logits against the jnp and Pallas
paths, prefill with its ``{"ssm", "attn"}`` cache, decode, both engines,
and the slot steps on the dict cache.  The scans themselves are held to
the reference in ``test_torch_ssm.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ssm_parity as parity  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    return parity.Pair("zamba2-2.7b")


def test_param_tree_matches_reference(pair):
    parity.check_param_tree(pair)
    flat = parity.convert.flatten(pair.tp)
    G, k = pair.tm._groups
    assert (G, k) == (1, 2)
    assert flat["layers/blocks/mamba/in_proj"].shape[:2] == (G, k)
    assert flat["layers/gates"].shape == (G,)
    assert flat["shared/attn/wq"].dim() == 3        # one unstacked block


def test_forward_logits_match_reference(pair):
    parity.check_forward(pair)


@pytest.mark.parametrize("S", [1, 2, 3, 37])
def test_prefill_cache_and_decode_match_reference(pair, S):
    parity.check_prefill_and_decode(pair, S)


def test_cache_layout(pair):
    G, k = pair.tm._groups
    cache = pair.tm.init_slot_cache(3, 16)
    assert sorted(cache) == ["attn", "ssm"]
    assert tuple(cache["ssm"].h.shape[:3]) == (G, k, 3)
    assert tuple(cache["attn"].k.shape[:3]) == (G, 3, 16)
    assert tuple(cache["attn"].index.shape) == (G, 3)
    np.testing.assert_array_equal(
        pair.tm._cache_index(cache).numpy(), np.zeros(3, np.int32))


def test_engines_match_reference_greedy_tokens(pair):
    parity.check_engines(pair)


def test_slot_steps_on_the_hybrid_cache(pair):
    parity.check_slot_steps(pair)


def test_int8_kv_refused(pair):
    parity.check_int8_refused(pair)
