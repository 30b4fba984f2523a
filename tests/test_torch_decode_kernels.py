"""The decode step's two kernels of the PyTorch port, on the CPU: the
launch planners of kernel B (int8-KV decode attention, split over Sk)
and kernel 6 (RMSNorm), the masks kernel B's tile skipping has to keep
(a row with no live key, non-prefix masks) held against the JAX
reference, and kernel B's split, skip and merge algorithm, written out in
fp64, held against the plain version.  ``test_torch_cuda.py`` holds the
kernels themselves to the plain versions on a card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402

# fp32 on both sides, sums in other orders over at most a few hundred
# O(1) terms (as tests/test_torch_kernels.py)
ATOL = 2e-5
H100_SMS = 132
ARCHS = ["gpt2m", "llama3.2-3b", "phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b"]


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ #
# the planners

@pytest.mark.parametrize("Sk", [1, 77, 104, 296, 1024])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8kv_splits_cover_each_key_once(arch, B, Sk):
    """Kernel B's splits at the served models' kv heads: whole tiles, at
    least one split and no more than the tiles, each split non-empty,
    every key of Sk in exactly one split, and within the kernel's limit
    of tiles a split."""
    KV = get_config(arch).n_kv_heads
    splits, kps = tq.int8kv_splits(B, KV, Sk, H100_SMS)
    tiles = -(-Sk // tq.KEY_TILE)
    assert 1 <= splits <= tiles
    assert kps % tq.KEY_TILE == 0 and kps // tq.KEY_TILE <= \
        tq.MAX_SPLIT_TILES
    owner = np.zeros(Sk, dtype=int)
    for s in range(splits):
        lo, hi = s * kps, min((s + 1) * kps, Sk)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    if splits > 1:               # the floor: no split of a small cache
        assert tiles >= 2 * tq.MIN_SPLIT_TILES
        assert kps // tq.KEY_TILE >= tq.MIN_SPLIT_TILES
    if tiles < 2 * tq.MIN_SPLIT_TILES:   # the engines' 104 and 296 slots
        assert splits == 1


@pytest.mark.parametrize("d", [2560, 3072, 4096])
@pytest.mark.parametrize("rows", [1, 8, 257, 512, 4096])
def test_rmsnorm_plan_covers_each_element_once(rows, d):
    """Kernel 6's launch shape: whole warps within the CTA limit, and
    with thread t of the row taking vectors t, t + threads, ... every
    element of the row is held by exactly one thread, within its EPT
    registers, for 16-byte vectors of bf16 and fp32 and for single
    elements; the grid walks every row exactly once."""
    plan = trn.rmsnorm_plan(rows, d, H100_SMS)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= trn.MAX_THREADS
    for vec in (8, 4, 1):
        held = np.zeros(d, dtype=int)
        for v in range(d // vec):
            k = v // plan.threads          # the thread's k-th vector
            assert k * vec < trn.EPT
            held[v * vec:(v + 1) * vec] += 1
        assert (held == 1).all()
    walked = np.zeros(rows, dtype=int)
    for cta in range(plan.grid):
        walked[cta::plan.grid] += 1
    assert (walked == 1).all()


def test_rmsnorm_plan_gives_decode_rows_a_thread_per_vector():
    """At decode (8 rows) each served width takes one CTA per row with a
    thread per 8 elements (one bf16 vector), the shape measured fastest
    on an H100; the widest row a CTA holds is MAX_D."""
    for d in (2560, 3072, 4096):
        assert trn.rmsnorm_plan(8, d, H100_SMS) == trn.RmsPlan(
            d // trn.EPT, 8)
    assert trn.rmsnorm_plan(8, trn.MAX_D, H100_SMS) == trn.RmsPlan(
        trn.MAX_THREADS, 8)
    with pytest.raises(ValueError):
        trn.rmsnorm_plan(8, trn.MAX_D + 1, H100_SMS)


# ------------------------------------------------------------------ #
# the masks tile skipping has to keep, in both packages

def _mask(kind, rng, B, Sk):
    """[B, Sk] bool: ``dead`` (row 0 has no live key, the others random
    non-prefix masks), ``all-dead``, or ``last`` (only each row's last
    slot)."""
    if kind == "all-dead":
        return np.zeros((B, Sk), dtype=bool)
    if kind == "last":
        valid = np.zeros((B, Sk), dtype=bool)
        valid[:, -1] = True
        return valid
    valid = rng.random((B, Sk)) < np.linspace(0.2, 0.8, B)[:, None]
    valid[0] = False
    return valid


def _inputs(rng, B, H, KV, Sk, D, kind):
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kq, ks = jops.quantize(jnp.asarray(
        rng.standard_normal((B, Sk, KV, D)).astype(np.float32)), block=D)
    vq, vs = jops.quantize(jnp.asarray(
        rng.standard_normal((B, Sk, KV, D)).astype(np.float32)), block=D)
    return (q, np.asarray(kq), np.asarray(ks)[..., 0], np.asarray(vq),
            np.asarray(vs)[..., 0], _mask(kind, rng, B, Sk))


def _reference(q, kq, ks, vq, vs, valid):
    """The reference's int8-KV attention as its decode calls it (the
    Pallas kernel in interpret mode, causal=False, block_q=8)."""
    return np.asarray(jops.flash_attention_int8kv(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), valid=jnp.asarray(valid, jnp.float32),
        causal=False, block_q=8, interpret=True))


@pytest.mark.parametrize("kind", ["dead", "all-dead", "last"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (6, 2)])
def test_int8kv_plain_matches_reference_on_dead_rows_and_masks(H, KV, kind):
    """Kernel B's plain version against the reference's Pallas int8-KV
    kernel and its dequantize-then-attend oracle, on a row with no live
    key (all three average the row's values: every key scores NEG_INF
    alike), random non-prefix masks, and a lone live slot at the end of
    the cache.  Sk = 128 is a whole key block of the Pallas kernel, so
    its wrapper adds no padded keys (see the next test)."""
    rng = np.random.default_rng(H * 10 + KV)
    args = _inputs(rng, 3, H, KV, 128, 64, kind)
    q, kq, ks, vq, vs, valid = args
    got = tq.int8kv_attention_plain(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), _reference(*args), atol=ATOL)
    oracle = tref.int8kv_attention_ref(
        _t(q).transpose(1, 2), _t(kq).transpose(1, 2),
        _t(ks).transpose(1, 2), _t(vq).transpose(1, 2),
        _t(vs).transpose(1, 2), _t(valid))
    np.testing.assert_allclose(got.numpy(),
                               oracle.transpose(1, 2).numpy(), atol=ATOL)
    v = vq.astype(np.float64) * vs[..., None]           # [B, Sk, KV, D]
    g = H // KV
    for b in range(3):
        if not valid[b].any():   # no live key: the mean of the values
            mean = v[b].mean(axis=0).repeat(g, axis=0)
            np.testing.assert_allclose(got.numpy()[b, 0], mean, atol=ATOL)
    if kind == "last":           # one live key: its value alone
        np.testing.assert_allclose(got.numpy()[:, 0],
                                   v[:, -1].repeat(g, axis=1), atol=ATOL)


def test_int8kv_reference_pads_a_dead_row_to_its_key_block():
    """Where Sk is not a whole key block (40 of 128), the reference's
    Pallas wrapper pads K, V and the mask with dead keys of value 0, so
    on a row with no live key its softmax spreads over 128 keys and the
    output is the row's value sum over 128; its oracle and the port's
    plain version (and kernel B) average over the 40 real keys.  Rows
    with a live key agree (padded keys get weight 0).  A decode row
    always holds its own token, so the reference's decode never meets
    the difference."""
    rng = np.random.default_rng(7)
    args = _inputs(rng, 3, 4, 2, 40, 64, "dead")
    got = tq.int8kv_attention_plain(*(_t(a) for a in args)).numpy()
    want = _reference(*args)
    np.testing.assert_allclose(got[1:], want[1:], atol=ATOL)
    np.testing.assert_allclose(got[0] * 40 / 128, want[0], atol=ATOL)


def _split_k_emulation(q, kq, ks, vq, vs, valid, kps):
    """Kernel B's algorithm in fp64: Sk cut into splits of ``kps`` keys
    (a whole number of tiles, as ``int8kv_splits`` gives them); in each
    split the tiles with a live key in order (every tile when the row has
    none: they all score NEG_INF); an online softmax in base 2 with the
    k scale on each score and the v scale folded into p; the splits
    merged in order with weight 2^(m_s - M), a split with no tile giving
    weight 0, and the output divided by max(l, 1e-30)."""
    B, _, H, D = q.shape
    Sk, KV = kq.shape[1], kq.shape[2]
    g = H // KV
    splits = -(-Sk // kps)
    c = (1.0 / math.sqrt(D)) * math.log2(math.e)
    out = torch.zeros((B, 1, H, D), dtype=torch.float64)
    for b in range(B):
        row_dead = not bool(valid[b].any())
        for h in range(H):
            kvh = h // g
            qh = q[b, 0, h].double() * c
            parts = []
            for s in range(splits):
                m, l = -math.inf, 0.0
                acc = torch.zeros(D, dtype=torch.float64)
                for t0 in range(s * kps, min((s + 1) * kps, Sk), tq.KEY_TILE):
                    keys = slice(t0, min(t0 + tq.KEY_TILE, (s + 1) * kps, Sk))
                    live = valid[b, keys].bool()
                    if not row_dead and not bool(live.any()):
                        continue                   # skipped: nothing read
                    sc = (kq[b, keys, kvh].double() @ qh) \
                        * ks[b, keys, kvh].double()
                    sc = torch.where(live, sc, torch.full_like(sc, -1e30))
                    m_new = max(m, float(sc.max()))
                    p = torch.exp2(sc - m_new)
                    corr = 2.0 ** (m - m_new)
                    l = l * corr + float(p.sum())
                    acc = acc * corr + (p * vs[b, keys, kvh].double()) \
                        @ vq[b, keys, kvh].double()
                    m = m_new
                parts.append((m, l, acc))
            M = max(m for m, _, _ in parts)
            w = [0.0 if m == -math.inf else 2.0 ** (m - M)
                 for m, _, _ in parts]
            den = max(sum(wi * l for wi, (_, l, _) in zip(w, parts)), 1e-30)
            out[b, 0, h] = sum(wi * a for wi, (_, _, a) in zip(w, parts)) \
                / den
    return out


@pytest.mark.parametrize("tiles_a_split", [1, 2])
@pytest.mark.parametrize("kind", ["prefix", "dead", "all-dead", "last"])
@pytest.mark.parametrize("Sk", [1, 77, 104, 296])
def test_int8kv_split_skip_merge_matches_plain(Sk, kind, tiles_a_split):
    """What kernel B computes, step by step in fp64 (Sk in splits of one
    or two tiles, so that every Sk past one tile is split; tiles with no
    live key skipped; splits merged), equals the plain version: skipping
    changes no result, a row with no live key still averages its values,
    and a split whose row is live elsewhere adds nothing."""
    rng = np.random.default_rng(Sk + len(kind))
    B, H, KV, D = 3, 4, 2, 16
    if kind == "prefix":
        fill = np.array([Sk, max(1, Sk // 3), 1])
        valid = np.arange(Sk)[None] < fill[:, None]
        q, kq, ks, vq, vs, _ = _inputs(rng, B, H, KV, Sk, D, "last")
    else:
        q, kq, ks, vq, vs, valid = _inputs(rng, B, H, KV, Sk, D, kind)
    args = tuple(_t(a) for a in (q, kq, ks, vq, vs, valid))
    got = _split_k_emulation(*args, kps=tiles_a_split * tq.KEY_TILE)
    want = tq.int8kv_attention_plain(*args)
    np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                               atol=ATOL)
