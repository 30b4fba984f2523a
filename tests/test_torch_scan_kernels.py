"""The prefill scans of the PyTorch port, on the CPU: the launch planners
of kernel 3 (the SSD chunked scan) and kernel 4 (the Mamba1 selective
scan), and the two kernels' arithmetic written out in PyTorch: kernel 3's
chunk algorithm with its products in 3xTF32 (the TF32 rounding of the
operands emulated as the kernel does it, by bit operations) and kernel
4's recurrence with exp2 of an A prescaled by log2(e) and its sum over
lanes.  Both are held to the plain versions and to the JAX reference's
oracles.  ``test_torch_cuda.py`` holds the kernels themselves to the
plain versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402

# the kernels' tolerance against the sequential plain versions
# (tests/test_torch_cuda.py, chip_smoke.py): sums in other orders over
# up to a few hundred steps and chunks of 64 terms, on values of O(1)
# (atol) to O(10) (rtol)
SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-3
H100_SMS = 132
LOG2E = 1.4426950408889634


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan_err(got, want):
    """Largest |got - want| in units of the scan tolerance (<= 1 passes)."""
    return float(((got - want).abs() / (SCAN_ATOL + SCAN_RTOL
                                        * want.abs())).max())


# ------------------------------------------------------------------ #
# the planners

def _ssd_widths():
    """(heads, head_dim) of the SSD scan: zamba2's served head, and the
    reduced configs' inner width (d_model 256, expand 2) cut into heads
    of 64, the only head the kernel takes; 4 heads as the card tests."""
    z = get_config("zamba2-2.7b")
    r = z.reduced()
    return [(z.ssm.expand * z.d_model // z.ssm.head_dim, z.ssm.head_dim),
            (r.ssm.expand * r.d_model // 64, 64), (4, 64)]


def ssd_warp_tiles(hd=64, ds=64, warps=8):
    """The (columns, states) of a head that each of a block's 8 warps
    owns, as ``csrc/ssd_scan.cu`` assigns them (warp w: column tile w /
    parts, state part w % parts): 16 columns times ds / parts states,
    parts = 8 / (hd / 16)."""
    parts = warps // (hd // 16)
    spw = ds // parts
    return [(range(16 * (w // parts), 16 * (w // parts) + 16),
             range((w % parts) * spw, (w % parts + 1) * spw))
            for w in range(warps)]


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("nh,hd", _ssd_widths())
@pytest.mark.parametrize("S", [1, 16, 63, 64, 65, 257])
@pytest.mark.parametrize("B", [1, 8])
def test_ssd_plan_covers_each_column_and_state_once(B, S, nh, hd, chunk):
    """Kernel 3's grid (a block per batch row and head) and warps: every
    (batch row, head, column, state) of h is owned by exactly one warp,
    every (row, head, column) of y by exactly one 16-column tile of one
    block; two stages only for more than one chunk and at most a block
    an SM; the chunks tile S."""
    n_chunks = -(-S // chunk)
    stages = tms.ssd_plan(B, nh, H100_SMS, n_chunks)
    if stages == 2:
        assert n_chunks > 1 and B * nh <= H100_SMS
    else:
        assert stages == 1
    tiles = ssd_warp_tiles(hd)
    owned = np.zeros((B, nh, hd, 64), dtype=int)
    cols = np.zeros((B, nh, hd), dtype=int)
    for hh in range(nh):
        for dcols, states in tiles:
            owned[:, hh, dcols.start:dcols.stop,
                  states.start:states.stop] += 1
        for dw in sorted({c.start for c, _ in tiles}):
            cols[:, hh, dw:dw + 16] += 1
    assert (owned == 1).all()
    assert (cols == 1).all()
    lens = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    assert len(lens) == n_chunks and sum(lens) == S
    assert all(1 <= k <= tms.SSD_MAX_CHUNK for k in lens)


def test_ssd_plan_takes_whole_heads_for_zamba2():
    """A block takes a whole head, so zamba2's 80 heads are 80 blocks at
    batch 1, staged in two stages over several chunks, and 640 at batch
    8, in one stage (two blocks an SM)."""
    assert tms.ssd_plan(1, 80, H100_SMS, 1) == 1
    assert tms.ssd_plan(1, 80, H100_SMS, 5) == 2
    assert tms.ssd_plan(8, 80, H100_SMS, 5) == 1
    with pytest.raises(ValueError):
        tms.ssd_plan(0, 80, H100_SMS, 1)


def _mamba1_widths():
    """(di, ds): falcon-mamba, the reduced configs, and a partial block."""
    f = get_config("falcon-mamba-7b")
    r = f.reduced()
    return [(f.ssm.expand * f.d_model, f.ssm.d_state),
            (r.ssm.expand * r.d_model, r.ssm.d_state), (300, 16)]


@pytest.mark.parametrize("di,ds", _mamba1_widths())
@pytest.mark.parametrize("S", [1, 16, 63, 64, 65, 257])
@pytest.mark.parametrize("B", [1, 8])
def test_mamba1_plan_covers_each_channel_and_state_once(B, S, di, ds):
    """Kernel 4's grid and lanes as ``csrc/mamba1_scan.cu`` lays them out
    (a block of 128 threads, 128 / lanes channels of a batch row, thread
    t on channel t / lanes with states (t % lanes) * ds / lanes on):
    every (batch row, channel, state) is owned by exactly one lane of one
    block; the staged tiles of 2048 / channels steps cover each time step
    once, in whole groups of the kernel's 8."""
    lanes = tms.mamba1_plan(B, di, ds, H100_SMS)
    assert lanes in tms.MAMBA1_LANES and lanes <= ds
    channels, sp = 128 // lanes, ds // lanes
    steps = 2048 // channels
    assert steps % 8 == 0
    blocks = -(-di // channels)
    owned = np.zeros((B, blocks * channels, ds), dtype=int)
    for tid in range(128):
        p = tid % lanes
        owned[:, tid // lanes::channels, p * sp:(p + 1) * sp] += 1
    assert (owned[:, :di] == 1).all()
    seen = np.zeros(S, dtype=int)
    for t0 in range(0, S, steps):
        seen[t0:t0 + steps] += 1
    assert (seen == 1).all()


def test_mamba1_plan_fills_the_card_at_batch_1():
    """falcon-mamba (di 8192, ds 16) takes 4 lanes a channel at batch 1
    (1024 warps on 132 SMs) and 2 at batch 8 (4096)."""
    assert tms.mamba1_plan(1, 8192, 16, H100_SMS) == 4
    assert tms.mamba1_plan(8, 8192, 16, H100_SMS) == 2
    with pytest.raises(ValueError):
        tms.mamba1_plan(1, 8192, 32, H100_SMS)


def test_mamba1_wrapper_refuses_rows_off_16_bytes():
    """Kernel 4 moves x, dt and y in 16-byte copies of 4 channels: its
    wrapper refuses a d_inner that is not a multiple of 4 before it looks
    at the device (every served and reduced width is one)."""
    for di, ds in _mamba1_widths():
        assert di % 4 == 0
    B, S, di, ds = 1, 5, 6, 16
    x = torch.zeros((B, S, di))
    b_s = torch.zeros((B, S, ds))
    with pytest.raises(ValueError, match="multiples of 4"):
        tms.mamba1_scan_cuda(x, x, b_s, b_s, torch.zeros((di, ds)),
                             torch.zeros((B, di, ds)))


# ------------------------------------------------------------------ #
# kernel 3's chunk algorithm in 3xTF32

def _tf32_hi(v):
    """The kernel's hi part: v rounded to TF32's 10 stored bits by adding
    half a unit of the last kept bit and masking the 13 below."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(v):
    """v truncated to TF32 (the kernel's lo part)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a, b, terms):
    """a @ b on the tensor cores: the k axis in steps of 8 (an m16n8k8
    product), each step's products exact and added to an fp32
    accumulator; ``terms`` the (a part, b part) pairs, smallest first."""
    K = a.shape[-1]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, K, 8):
        part = 0.0
        for x, y in terms(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]):
            part = part + x.double() @ y.double()
        acc = (acc.double() + part).float()
    return acc


def _split3(a, b):
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return [(al, bh), (ah, bl), (ah, bh)]


def _single(a, b):
    return [(_tf32_hi(a), _tf32_hi(b))]


def _ex2(v):
    return torch.exp2(v.float())


def ssd_chunks(xh, dt, b_s, c_s, a, h0, chunk, split=_split3):
    """Kernel 3's algorithm, chunk by chunk, in the model's layout: s
    summed in fp64, M masked before the exponential, each exp as 2 to
    the (fp32) exponent times log2(e), the four products (C B^T, M X,
    diag(exp s) C h^T, (X diag w)^T B) by ``_mm`` with ``split``'s
    terms.  xh: [B, S, nh, hd]; dt: [B, S, nh]; b_s/c_s: [B, S, ds];
    a: [nh]; h0: [B, nh, hd, ds]."""
    Bn, S, nh, hd = xh.shape
    h = h0.clone()
    ys = []
    for c0 in range(0, S, chunk):
        kc = min(chunk, S - c0)
        X = xh[:, c0:c0 + kc].permute(0, 2, 1, 3)           # [B, nh, kc, hd]
        D = dt[:, c0:c0 + kc].permute(0, 2, 1)              # [B, nh, kc]
        Bc, Cc = b_s[:, c0:c0 + kc], c_s[:, c0:c0 + kc]     # [B, kc, ds]
        s = torch.cumsum((D * a[None, :, None]).double(), dim=-1)
        G = _mm(Cc, Bc.transpose(1, 2), split)[:, None]     # [B, 1, kc, kc]
        diff = (s[..., :, None] - s[..., None, :]).float()
        keep = torch.ones(kc, kc, dtype=torch.bool).tril()
        decay = torch.where(keep, _ex2(diff * np.float32(LOG2E)),
                            torch.zeros(()))
        M = decay * D[..., None, :] * G
        es = _ex2(s * LOG2E)                                # [B, nh, kc]
        y = _mm(M, X, split) + _mm(es[..., None] * Cc[:, None],
                                   h.transpose(-1, -2), split)
        s_last = s[..., -1:]
        w = _ex2((s_last - s) * LOG2E) * D                  # [B, nh, kc]
        h = h * _ex2(s_last * LOG2E)[..., None] \
            + _mm((X * w[..., None]).transpose(-1, -2), Bc[:, None], split)
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1), h


def _ssd_case(B, S, nh, dt_scale, seed):
    """zamba2's head (64 columns, 64 states): x, dt, B, C, a (down to
    -16) and a non-zero h0, from a numpy seed."""
    rng = np.random.default_rng(seed)
    hd = ds = 64
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = (rng.random((B, S, nh)) * dt_scale).astype(np.float32)
    b_s = rng.standard_normal((B, S, ds)).astype(np.float32)
    c_s = rng.standard_normal((B, S, ds)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, nh, dtype=np.float32)
    h0 = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    return tuple(_t(v) for v in (xh, dt, b_s, c_s, a, h0))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("dt_scale", [0.1, 4.0])
def test_ssd_3xtf32_chunks_match_plain(dt_scale, chunk):
    """Kernel 3's chunk algorithm with every product in 3xTF32 against
    the sequential plain version, from a non-zero h0, over 130 steps (a
    partial last chunk), within the kernels' scan tolerance; at dt scale
    4 the in-chunk log-decays reach thousands."""
    args = _ssd_case(2, 130, 4, dt_scale, int(dt_scale * 10) + chunk)
    y, h = ssd_chunks(*args, chunk)
    wy, wh = tms.ssd_scan_plain(*args)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert _scan_err(y, wy) <= 1.0
    assert _scan_err(h, wh) <= 1.0


def test_ssd_single_tf32_misses_the_tolerance():
    """The same algorithm with each product in one TF32 pass (10 stored
    bits an operand) misses the scan tolerance: why the kernel splits
    every operand in two."""
    args = _ssd_case(2, 130, 4, 0.1, 7)
    y, h = ssd_chunks(*args, 64, split=_single)
    wy, wh = tms.ssd_scan_plain(*args)
    assert max(_scan_err(y, wy), _scan_err(h, wh)) > 1.0


def test_ssd_3xtf32_chunks_match_the_reference_oracle():
    """From a zero state, the emulated 3xTF32 chunks against the JAX
    reference's sequential oracle (``repro.kernels.ref.ssd_ref``, heads
    before time)."""
    xh, dt, b_s, c_s, a, _ = _ssd_case(1, 100, 4, 0.5, 3)
    y, h = ssd_chunks(xh, dt, b_s, c_s, a,
                      torch.zeros((1, 4, 64, 64)), 64)
    jy, jh = jref.ssd_ref(*(jnp.asarray(v.numpy()) for v in (
        xh.transpose(1, 2), dt.transpose(1, 2), b_s, c_s, a)))
    assert _scan_err(y, _t(jy).transpose(1, 2)) <= 1.0
    assert _scan_err(h, _t(jh)) <= 1.0


@pytest.mark.parametrize("v", [1.0, -3.25, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                               1e-30, -7.77e5])
def test_tf32_split_is_exact_to_21_bits(v):
    """hi has at most 10 stored bits and rounds to nearest (half a unit
    of the last kept bit away from zero); hi + lo is within 2^-21 of v."""
    x = torch.tensor([v], dtype=torch.float32)
    hi = _tf32_hi(x)
    lo = _tf32_trunc(x - hi)
    assert int(hi.view(torch.int32)) & 0x1fff == 0
    assert abs(float(x - hi)) <= abs(v) * 2 ** -11
    assert abs(float(x) - float(hi.double() + lo.double())) <= abs(v) * 2 ** -21


# ------------------------------------------------------------------ #
# kernel 4's recurrence

def mamba1_lanes(x, dt, b_s, c_s, A, h0, lanes):
    """Kernel 4's arithmetic: A prescaled by log2(e) once, each exp as
    exp2(dt * a2); each of ``lanes`` lanes of a channel sums its ds /
    lanes states' h C in order, and the lanes' sums meet in the
    butterfly of __shfl_xor_sync (offsets 1, 2), all in fp32."""
    Bn, S, di = x.shape
    ds = b_s.shape[-1]
    sp = ds // lanes
    a2 = A * np.float32(LOG2E)
    h = h0.clone()
    ys = []
    for t in range(S):
        d = dt[:, t, :, None]
        h = torch.exp2(d * a2) * h + (d * x[:, t, :, None]) * b_s[:, t, None]
        hc = (h * c_s[:, t, None]).view(Bn, di, lanes, sp)
        part = torch.zeros((Bn, di, lanes))
        for j in range(sp):
            part = part + hc[..., j]
        off = 1
        while off < lanes:
            part = part + part[..., torch.arange(lanes) ^ off]
            off *= 2
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1), h


def _mamba1_case(B, S, di, ds, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (rng.random((B, S, di)) * 0.5).astype(np.float32)
    b_s = rng.standard_normal((B, S, ds)).astype(np.float32)
    c_s = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, ds)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    return tuple(_t(v) for v in (x, dt, b_s, c_s, A, h0))


@pytest.mark.parametrize("lanes", tms.MAMBA1_LANES)
@pytest.mark.parametrize("ds", [8, 16])
def test_mamba1_exp2_lanes_match_plain(ds, lanes):
    """Kernel 4's recurrence with exp2 of the prescaled A and its lane
    sums against the sequential plain version, from a non-zero h0, over
    257 steps, within the kernels' scan tolerance."""
    args = _mamba1_case(2, 257, 48, ds, ds + lanes)
    y, h = mamba1_lanes(*args, lanes)
    wy, wh = tms.mamba1_scan_plain(*args)
    assert _scan_err(y, wy) <= 1.0
    assert _scan_err(h, wh) <= 1.0


def test_mamba1_exp2_lanes_match_the_reference_oracle():
    """From a zero state, against the JAX reference's sequential oracle
    (``repro.kernels.ref.mamba1_ref``), at 4 lanes a channel."""
    x, dt, b_s, c_s, A, _ = _mamba1_case(1, 120, 32, 16, 9)
    y, h = mamba1_lanes(x, dt, b_s, c_s, A, torch.zeros((1, 32, 16)), 4)
    jy, jh = jref.mamba1_ref(*(jnp.asarray(v.numpy())
                               for v in (x, dt, b_s, c_s, A)))
    assert _scan_err(y, _t(jy)) <= 1.0
    assert _scan_err(h, _t(jh)) <= 1.0
