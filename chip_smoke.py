"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version at the serving shapes of
the models below (scans from a non-zero state, and one SSD case whose
unmasked exp would overflow), and times kernel, plain version and, where
one exists, a PyTorch library yardstick beside the card's bound.  Then
it serves three models at full width with random weights from a seed:

  * gpt2m (24 layers, d_model 1024) through ``Engine`` (fp32 and int8
    KV) and ``ContinuousEngine`` (int8 KV): kernels A and B;
  * falcon-mamba-7b (64 Mamba1 layers, d_model 4096) through both
    engines: kernel 4;
  * zamba2-2.7b (54 Mamba2 layers in 9 groups, each behind a shared
    attention block of 32 heads of 80) through both engines: kernels 3
    and A.

For each model it checks that the kernel path's first-step logits agree
with the plain path's on the card (and, for the SSM and hybrid models,
one full-width layer in fp32 over a prompt longer than the scan's
chunk), that every kernel of each phase was launched, and that the
outputs are well formed.

The second-to-last line of stdout is the ``kernels`` JSON, the last the
device JSON.  Exits non-zero, printing neither, when anything fails or
when no card is present.  With ``SMOKE_DETAILS`` set to a file path, the
full results (every shape, the phases, the profile) are also written
there as JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside the tensor cores (the scan kernels' pipes), HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, both bf16 out of fp32 accumulation: about one
# bf16 ulp of O(1) outputs (2^-8) plus summation order
KERNEL_ATOL = 2e-2
# fp32 scan kernels vs their sequential plain versions, over up to 257
# steps and within chunks of 64 terms: sums in other orders on states and
# outputs of O(1) (atol) to O(10) (rtol).  Kernel 3 keeps its log-decay
# cumsum in fp64, so large dt |A| costs it no extra error.
SCAN_ATOL, SCAN_RTOL = 1e-4, 1e-3
# first-step logits, kernel path vs plain path, bf16 through 24 layers
# of random weights: rounding differs at every layer; relative to the
# largest logit
LOGIT_RTOL = 5e-2
# the SSM and hybrid models' bf16 check: a multiple of the measured
# difference between two exact orderings of the same plain scan
NOISE_FACTOR = 3.0
# ...and the control itself may reach at most this share of the largest
# logit, so that a noisier control cannot widen the check without bound
CONTROL_MAX = 0.10
# the same comparison in fp32 compute: two exact orderings of the scan
# differ by ~1e-5 of the largest logit through 64 layers
FP32_LOGIT_RTOL = 1e-3
# one full-width SSM layer in fp32, kernel path vs plain path, from a
# non-zero state over a prompt longer than the chunk: fp32 summation
# order only, relative to the largest value of the output and of h
LAYER_PROMPT = 100
FP32_LAYER_RTOL = 1e-4

# ~1 ms at the H100's clocks: longer than the host takes to enqueue any
# one function timed here
SLEEP_CYCLES = 2_000_000
SEED = 0
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_GEN = 8, 64, 32
CONT_SLOTS, CONT_REQUESTS, CONT_LENS, CONT_GEN = 8, 16, (16, 256), 32
# the SSM and hybrid phases: (tag, arch, kernels each phase must launch)
SSM_MODELS = (("ssm", "falcon-mamba-7b", ("mamba1_scan",)),
              ("hybrid", "zamba2-2.7b", ("ssd_scan", "flash_attn_fwd")))


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------- #

def time_ms(torch, fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn`` launch, over ``iters`` launches,
    each with a cold L2 (a 64 MB buffer is rewritten first).  A device
    sleep queued ahead of the start event keeps the card busy while the
    host enqueues ``fn``, so the events time the device, not the
    wrapper's Python."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def scan_err(torch, got, want) -> float:
    """Largest |got - want| in units of the scan tolerance (<= 1 passes)."""
    tol = SCAN_ATOL + SCAN_RTOL * want.abs()
    return float(((got - want).abs() / tol).max())


# --------------------------------------------------------------------- #
# kernel phases
# --------------------------------------------------------------------- #

def check_flash(torch, F, cfg, shapes):
    """Kernel A against its plain version at a model's prefill shapes
    ``(B, S)``."""
    from repro_torch.kernels import flash_attention as fa

    H, D = cfg.n_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst = [], 0.0
    for B, S in shapes:
        q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            fail(f"flash_attn_fwd D={D} B={B} S={S}: max_abs_err {err} > "
                 f"{KERNEL_ATOL}")
        worst = max(worst, err)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                 # visible causal pairs
        b_ms, b_by = bound(4 * B * S * H * D * 2, 4 * D * pairs * B * H)
        row = {
            "B": B, "S": S, "H": H, "D": D, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True), iters=5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, is_causal=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"flash_attn_fwd D={D} B={B:2d} S={S:5d} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} bound_ms={b_ms:.5f} "
            f"({b_by})")
    return rows, worst


def check_int8kv(torch, F, cfg):
    """Kernel B against its plain version at gpt2m decode shapes."""
    from repro_torch.kernels import quantized as qz

    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, worst = [], 0.0
    # (B, Sk, fills): the engines' decode caches, rows partly filled
    for B, Sk, fills in ((8, 104, (65, 96)), (8, 1024, (17, 290)),
                         (8, 1024, (1, 1024))):
        q = torch.randn((B, 1, H, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        kq, ks = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                         device="cuda"), block=D)
        vq, vs = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                         device="cuda"), block=D)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        fill = torch.linspace(fills[0], fills[1], B,
                              device="cuda").round().long()
        valid = torch.arange(Sk, device="cuda")[None] < fill[:, None]
        args = (q, kq, ks, vq, vs, valid)
        got = qz.int8kv_attention_cuda(*args)
        want = qz.int8kv_attention_plain(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            fail(f"int8kv_decode B={B} Sk={Sk}: max_abs_err {err} > "
                 f"{KERNEL_ATOL}")
        worst = max(worst, err)
        live = int(valid.sum())                  # keys this data needs
        n_bytes = live * KV * (2 * D + 2 * 4) + B * Sk \
            + 2 * B * H * D * 2
        b_ms, b_by = bound(n_bytes, 4 * D * live * H)
        # yardstick: SDPA over K/V already dequantized to bf16 with the
        # same mask (no PyTorch call takes the int8 cache itself)
        kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vq.float() * vs[..., None]).to(torch.bfloat16)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, kd, vd))
        mask = valid[:, None, None, :]
        row = {
            "B": B, "Sk": Sk, "live_keys": live, "max_abs_err": err,
            "ms": time_ms(torch, lambda: qz.int8kv_attention_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: qz.int8kv_attention_plain(
                *args)),
            "library_ms": None,
            "sdpa_dequant_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"int8kv_decode B={B} Sk={Sk:5d} live={live:5d} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_on_dequantized_ms={row['sdpa_dequant_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


def check_mamba1(torch, cfg):
    """Kernel 4 against its plain version at falcon-mamba's prefill
    shapes, from a non-zero state, with B and C as strided slices of one
    projection, as an fp32 model hands them (the served bf16 model's
    ``.float()`` hands contiguous copies)."""
    from repro_torch.kernels import mamba_scan as ms

    di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows, worst = [], 0.0
    # (B, S): Engine prefill (8 x 64); a ragged continuous prefill
    for B, S in ((8, 64), (1, 257)):
        x = torch.randn((B, S, di), generator=g, device="cuda")
        dt = torch.rand((B, S, di), generator=g, device="cuda") * 0.1
        bc = torch.randn((B, S, 2 * ds), generator=g, device="cuda")
        b_s, c_s = bc[..., :ds], bc[..., ds:]
        A = -torch.arange(1, ds + 1, device="cuda",
                          dtype=torch.float32).expand(di, ds).contiguous()
        h0 = torch.randn((B, di, ds), generator=g, device="cuda")
        args = (x, dt, b_s, c_s, A, h0)
        y, h = ms.mamba1_scan_cuda(*args)
        wy, wh = ms.mamba1_scan_plain(*args)
        torch.cuda.synchronize()
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = max(scan_err(torch, y, wy), scan_err(torch, h, wh))
        if not rel <= 1.0:
            fail(f"mamba1_scan B={B} S={S}: max_abs_err {err} beyond "
                 f"atol {SCAN_ATOL} + rtol {SCAN_RTOL}")
        worst = max(worst, err)
        # x, dt, y; B and C; A; h0 and h_last, all fp32.  Per (t, c, s):
        # dt a, exp, times h, + dt x B (FMA), + h C (FMA): 7 flops
        n_bytes = 4 * (3 * B * S * di + 2 * B * S * ds + di * ds
                       + 2 * B * di * ds)
        b_ms, b_by = bound(n_bytes, B * S * di * (7 * ds + 1),
                           PEAK_FP32_FLOPS)
        row = {"B": B, "S": S, "di": di, "ds": ds, "max_abs_err": err,
               "ms": time_ms(torch, lambda: ms.mamba1_scan_cuda(*args)),
               "plain_ms": time_ms(torch, lambda: ms.mamba1_scan_plain(
                   *args), iters=3, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"mamba1_scan B={B} S={S:4d} err={err:.3e} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


def ssd_flops(B, S, nh, hd, ds, K) -> float:
    """fp32 operations the SSD scan needs for these inputs.  Per chunk of
    kc rows and batch row: the kc(kc+1)/2 visible C.B scores, once (B and
    C are shared by the heads).  Per head besides: each visible M entry's
    exp and two products, M X over them, exp(s) C.h, and the state update
    (w_j x_j once per (j, d), an FMA per (j, d, s), then the decay)."""
    total = 0
    for c0 in range(0, S, K):
        kc = min(K, S - c0)
        tri = kc * (kc + 1) // 2
        per_head = (tri * 3 + tri * 2 * hd + kc * hd * (2 * ds + 2)
                    + kc * hd + hd * ds * (2 * kc + 2))
        total += tri * 2 * ds + nh * per_head
    return float(total * B)


def check_ssd(torch, cfg):
    """Kernel 3 against its plain version at zamba2's prefill shapes,
    from a non-zero state, with x, B and C as strided views of one conv
    output, as an fp32 model hands them (the served bf16 model's
    ``.float()`` hands contiguous copies); one case with in-chunk
    log-decays of thousands, where an exp before the mask would
    overflow."""
    from repro_torch.kernels import mamba_scan as ms

    s = cfg.ssm
    di = s.expand * cfg.d_model
    hd, ds, K = s.head_dim, s.d_state, s.chunk
    nh = di // hd
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows, worst = [], 0.0
    # (B, S, dt scale): Engine prefill; a ragged continuous prefill; dt up
    # to 4 with A down to -16 sums to ~ -2000 over a chunk of 64
    for B, S, dt_scale in ((8, 64, 0.1), (1, 257, 0.1), (1, 128, 4.0)):
        xbc = torch.randn((B, S, di + 2 * ds), generator=g, device="cuda")
        xh = xbc[..., :di].reshape(B, S, nh, hd)
        b_s, c_s = xbc[..., di:di + ds], xbc[..., di + ds:]
        dt = torch.rand((B, S, nh), generator=g, device="cuda") * dt_scale
        a = -torch.linspace(1.0, 16.0, nh, device="cuda")
        h0 = torch.randn((B, nh, hd, ds), generator=g, device="cuda")
        args = (xh, dt, b_s, c_s, a, h0)
        y, h = ms.ssd_scan_cuda(*args, chunk=K)
        wy, wh = ms.ssd_scan_plain(*args)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
            fail(f"ssd_scan B={B} S={S} dt_scale={dt_scale}: non-finite")
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = max(scan_err(torch, y, wy), scan_err(torch, h, wh))
        if not rel <= 1.0:
            fail(f"ssd_scan B={B} S={S} dt_scale={dt_scale}: max_abs_err "
                 f"{err} beyond atol {SCAN_ATOL} + rtol {SCAN_RTOL}")
        worst = max(worst, err)
        # x and y; dt; B and C; a; h0 and h_last, all fp32
        n_bytes = 4 * (2 * B * S * di + B * S * nh + 2 * B * S * ds + nh
                       + 2 * B * nh * hd * ds)
        b_ms, b_by = bound(n_bytes, ssd_flops(B, S, nh, hd, ds, K),
                           PEAK_FP32_FLOPS)
        row = {"B": B, "S": S, "nh": nh, "hd": hd, "ds": ds, "chunk": K,
               "dt_scale": dt_scale, "max_abs_err": err,
               "ms": time_ms(torch, lambda: ms.ssd_scan_cuda(*args,
                                                               chunk=K)),
               "plain_ms": time_ms(torch, lambda: ms.ssd_scan_plain(*args),
                                   iters=3, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"ssd_scan B={B} S={S:4d} dt<={dt_scale} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


# --------------------------------------------------------------------- #
# end-to-end phases
# --------------------------------------------------------------------- #

def check_tokens(np, tokens, shape, vocab, what):
    tokens = np.asarray(tokens)
    if tokens.shape != shape:
        fail(f"{what}: tokens of shape {tokens.shape}, want {shape}")
    if tokens.min() < 0 or tokens.max() >= vocab:
        fail(f"{what}: token ids outside [0, {vocab})")


def run_phase(torch, ops, name, fn, needs):
    """Drive one main-path phase with the launch counts set to 0 just
    before and read just after; every kernel in ``needs`` must launch."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        fail(f"phase {name}: kernels {missing} never launched ({counts})")
    log(f"phase {name}: {wall:.2f}s launches {counts}")
    return out, counts


def profile_window(torch, fn, ours):
    """Device busy time and the largest kernels over one call of ``fn``,
    from ``torch.profiler``; ``None`` when the trace holds no device
    events (then nothing is reported as measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        return None
    busy_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    mine = {k: v for k, v in by_name.items() if any(o in k for o in ours)}
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / wall_us,
            "top": [{"name": k[:80], "us": t, "count": n}
                    for k, (t, n) in top],
            "ours": [{"name": k[:80], "us": t, "count": n}
                     for k, (t, n) in mine.items()]}


def first_step(torch, m, params, batch, kv_dtype, tok=None):
    """(prefill logits, decode logits, fed token) of one model on the
    engine batch; the decode step feeds ``tok`` (or the prefill's greedy
    token), so that two paths decode the same token."""
    with torch.no_grad():
        cache = m.init_cache(ENGINE_BATCH, ENGINE_PROMPT + 8,
                             kv_dtype=kv_dtype)
        pre, cache = m.prefill(params, batch, cache)
        if tok is None:
            tok = torch.argmax(pre, -1)[:, None]
        dec, _ = m.decode_step(params, cache, tok)
    return pre, dec, tok


def compare_logits(torch, what, got, want, share):
    """Max |got - want| of the prefill and decode logits, which must stay
    within ``share`` of the largest |want| logit."""
    out = {}
    for i, step in enumerate(("prefill", "decode")):
        a, b = got[i].float(), want[i].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{what}: non-finite {step} logits")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        out[step] = {"max_abs_err": err, "max_abs_logit": scale,
                     "tolerance_share": share}
        log(f"{what} {step}: max_abs_err {err:.4e} (max |logit| "
            f"{scale:.3f}, tolerance {share:.4g} x that)")
        if not err <= share * scale:
            fail(f"{what} {step} logits disagree: {err} > {share:.4g} * "
                 f"{scale}")
    return out


def check_ssm_logits(torch, Model, cfg, params, batch):
    """First-step logits of an SSM or hybrid model, kernel path against
    plain path on the card, on one set of parameters.

    In bf16 (the served dtype) two exact orderings of the same scan
    already differ by a few % of the largest logit after 54 to 64 layers
    of random weights, so the bf16 check is held to a control measured
    here: the plain path with the scan's chunk halved, which changes
    nothing but fp32 summation order.  The kernel path must stay within
    ``NOISE_FACTOR`` times that control (and at least ``LOGIT_RTOL``).
    The control itself must stay within ``CONTROL_MAX``.  Where the path
    allows fp32 compute (no bf16-only kernel on it), the same comparison
    in fp32 is held to ``FP32_LOGIT_RTOL``."""
    import dataclasses

    half = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2))
    k = first_step(torch, Model(cfg, device="cuda"), params, batch, "fp32")
    p = first_step(torch, Model(cfg, device="cuda", use_kernels=False),
                   params, batch, "fp32", k[2])
    c = first_step(torch, Model(half, device="cuda", use_kernels=False),
                   params, batch, "fp32", k[2])
    control = compare_logits(torch, f"{cfg.name} bf16 control (chunk "
                             f"{half.ssm.chunk} vs {cfg.ssm.chunk}, plain)",
                             c, p, 1.0)
    noise = max(v["max_abs_err"] / v["max_abs_logit"]
                for v in control.values())
    if not noise <= CONTROL_MAX:
        fail(f"{cfg.name}: the bf16 control differs by {noise:.4g} of the "
             f"largest logit, over {CONTROL_MAX}")
    out = {"bf16_control": control, "bf16": compare_logits(
        torch, f"{cfg.name} bf16 logits kernel vs plain", k, p,
        max(LOGIT_RTOL, NOISE_FACTOR * noise))}
    if cfg.family == "ssm":
        f32 = dataclasses.replace(cfg, dtype="float32")
        k = first_step(torch, Model(f32, device="cuda"), params, batch,
                       "fp32")
        p = first_step(torch, Model(f32, device="cuda", use_kernels=False),
                       params, batch, "fp32", k[2])
        out["fp32"] = compare_logits(
            torch, f"{cfg.name} fp32 logits kernel vs plain", k, p,
            FP32_LOGIT_RTOL)
    return out


def check_ssm_layer(torch, cfg, params):
    """Layer 0 of an SSM or hybrid model at full width in fp32 (its
    parameters are fp32; so is x), kernel path against plain path on the
    card, from a non-zero state, over ``LAYER_PROMPT`` tokens: more than
    one chunk, so kernel 3 carries h from one chunk to the next (zamba2's
    bf16-only kernel A rules out an fp32 run of the whole hybrid model).
    In fp32 the scans get x, B and C as strided views, so this also runs
    the kernels' stride path at full width.  The output and the new h
    must agree within ``FP32_LAYER_RTOL`` of their largest value."""
    from repro_torch.models import ssm

    if cfg.family == "ssm":
        fwd, p = ssm.mamba1_forward, params["layers"]["mamba"]
        p = {k: v[0] for k, v in p.items()}
    else:
        fwd, p = ssm.mamba2_forward, params["layers"]["blocks"]["mamba"]
        p = {k: v[0, 0] for k, v in p.items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((ENGINE_BATCH, LAYER_PROMPT, cfg.d_model), generator=g,
                    device="cuda")
    zero = ssm.init_ssm_state(cfg, ENGINE_BATCH, torch.float32,
                              device="cuda")
    state = ssm.SSMState(conv=zero.conv, h=torch.randn(
        zero.h.shape, generator=g, device="cuda"))
    with torch.no_grad():
        got = fwd(x, p, cfg, state=state, use_kernels=True)
        want = fwd(x, p, cfg, state=state, use_kernels=False)
    out = {}
    for what, a, b in (("output", got[0], want[0]),
                       ("h", got[1].h, want[1].h)):
        if not torch.isfinite(a).all():
            fail(f"{cfg.name} fp32 layer: non-finite {what}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        out[what] = {"max_abs_err": err, "max_abs": scale,
                     "tolerance_share": FP32_LAYER_RTOL}
        log(f"{cfg.name} fp32 layer 0, S={LAYER_PROMPT}, kernel vs plain "
            f"{what}: max_abs_err {err:.4e} (max |value| {scale:.3f}, "
            f"tolerance {FP32_LAYER_RTOL} x that)")
        if not err <= FP32_LAYER_RTOL * scale:
            fail(f"{cfg.name} fp32 layer {what} disagrees: {err} > "
                 f"{FP32_LAYER_RTOL} * {scale}")
    return out


def engine_phase(torch, np, ops, name, model, params, batch, needs, card,
                 **kw):
    from repro_torch.serve import Engine

    cfg = model.cfg
    eng = Engine(model, batch_size=ENGINE_BATCH,
                 max_len=ENGINE_PROMPT + ENGINE_GEN + 8, **kw)
    out, counts = run_phase(
        torch, ops, name,
        lambda: eng.generate(params, batch, n_tokens=ENGINE_GEN), needs)
    check_tokens(np, out["tokens"], (ENGINE_BATCH, ENGINE_GEN),
                 cfg.vocab_size, name)
    st = out["stats"]
    log(f"{name}: TTFT {st.prefill_s * 1e3:.2f} ms, decode "
        f"{st.tokens_per_s:.1f} tok/s ({st.steps_per_s:.2f} steps/s x "
        f"{ENGINE_BATCH}) on {card}")
    return {"batch": ENGINE_BATCH, "prompt": ENGINE_PROMPT,
            "gen": ENGINE_GEN, "ttft_s": st.prefill_s,
            "decode_steps_per_s": st.steps_per_s,
            "tokens_per_s": st.tokens_per_s, "launches": counts}


def continuous_phase(torch, np, ops, name, model, params, rng, max_len,
                     needs, card, **kw):
    from repro_torch.serve import ContinuousEngine, Request

    cfg = model.cfg
    lens = rng.integers(CONT_LENS[0], CONT_LENS[1] + 1, CONT_REQUESTS)
    reqs = [Request(i, rng.integers(4, cfg.vocab_size, (int(n),),
                                    dtype=np.int64))
            for i, n in enumerate(lens)]
    ce = ContinuousEngine(model, slots=CONT_SLOTS, max_len=max_len, **kw)
    res, counts = run_phase(
        torch, ops, name, lambda: ce.run(params, reqs, max_new=CONT_GEN),
        needs)
    for r in reqs:
        check_tokens(np, res["outputs"][r.uid], (CONT_GEN,),
                     cfg.vocab_size, f"{name} request {r.uid}")
    st = res["stats"]
    ttft = sorted(st.ttft_s.values())
    log(f"{name}: {st.n_tokens} tokens in {st.total_s:.2f}s, "
        f"{st.tokens_per_s:.1f} tok/s, TTFT p50 "
        f"{np.percentile(ttft, 50) * 1e3:.1f} ms, occupancy "
        f"{st.mean_occupancy:.2f}/{CONT_SLOTS} on {card}")
    return {"slots": CONT_SLOTS, "requests": CONT_REQUESTS,
            "prompt_lens": [int(n) for n in lens], "gen": CONT_GEN,
            "max_len": max_len, "exact_prefill": ce.exact_prefill,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_max_s": ttft[-1], "tokens_per_s": st.tokens_per_s,
            "mean_occupancy": st.mean_occupancy, "total_s": st.total_s,
            "launches": counts}


def log_profile(name, prof):
    if prof is None:
        log(f"profile {name}: the trace holds no device events (not "
            f"measured)")
        return
    log(f"profile {name}: wall {prof['wall_us'] / 1e3:.2f} ms, device busy "
        f"{prof['device_busy_us'] / 1e3:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    for r in prof["top"]:
        log(f"  {r['us'] / 1e3:9.3f} ms  x{r['count']:5d}  {r['name']}")
    for r in prof["ours"]:
        log(f"  ours: {r['us'] / 1e3:9.3f} ms  x{r['count']:5d}  "
            f"{r['name']}")


OUR_KERNELS = ("flash_fwd_kernel", "int8kv_decode_kernel",
               "mamba1_scan_kernel", "ssd_scan_kernel")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten
    from repro_torch.kernels import _build, ops
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.1f}s")
    for stem, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    cfg = get_config("gpt2m")
    fcfg, zcfg = get_config("falcon-mamba-7b"), get_config("zamba2-2.7b")
    # (B, S): Engine prefill (8 x 64), ContinuousEngine buckets (1 x
    # 16..256), and a ragged and a full-context shape; zamba2's shared
    # attention (head_dim 80) at its Engine prefill and a long prompt
    flash_rows, flash_err = check_flash(
        torch, F, cfg, ((8, 64), (1, 16), (1, 256), (4, 128), (1, 257),
                        (1, 1024)))
    z_rows, z_err = check_flash(torch, F, zcfg, ((8, 64), (1, 256)))
    flash_rows, flash_err = flash_rows + z_rows, max(flash_err, z_err)
    int8_rows, int8_err = check_int8kv(torch, F, cfg)
    m1_rows, m1_err = check_mamba1(torch, fcfg)
    ssd_rows, ssd_err = check_ssd(torch, zcfg)

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                    (ENGINE_BATCH, ENGINE_PROMPT),
                                    dtype=np.int64)}
    k = first_step(torch, model, params, batch, "int8")
    p = first_step(torch, Model(cfg, device="cuda", use_kernels=False),
                   params, batch, "int8", k[2])
    logit_err = {cfg.name: compare_logits(
        torch, f"{cfg.name} logits kernel vs plain", k, p, LOGIT_RTOL)}
    del k, p

    totals = {name: 0 for name in ops.KERNELS}
    e2e = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] += n

    for kv in ("fp32", "int8"):
        e2e[f"engine_{kv}"] = engine_phase(
            torch, np, ops, f"engine-{kv}", model, params, batch,
            ["flash_attn_fwd"] + (["int8kv_decode"] if kv == "int8" else []),
            card, kv_dtype=kv)
        add(e2e[f"engine_{kv}"]["launches"])

    # where the time goes: one int8-KV generate of 8 tokens, traced after
    # the counted phases (its launches are not in the kernels line)
    eng = Engine(model, batch_size=ENGINE_BATCH,
                 max_len=ENGINE_PROMPT + ENGINE_GEN + 8, kv_dtype="int8")
    prof = profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8, timing=False),
        OUR_KERNELS)
    log_profile("engine-int8, prefill + 7 decode steps", prof)
    e2e["profile_engine_int8"] = prof

    e2e["continuous_int8"] = continuous_phase(
        torch, np, ops, "continuous-int8", model, params, rng,
        cfg.max_seq_len, ["flash_attn_fwd", "int8kv_decode"], card,
        kv_dtype="int8")
    add(e2e["continuous_int8"]["launches"])
    del model, params, eng
    torch.cuda.empty_cache()

    # the SSM and hybrid families at full width, one model on the card at
    # a time (falcon-mamba-7b holds ~29 GB of fp32 parameters)
    for tag, arch, needs in SSM_MODELS:
        mcfg = get_config(arch)
        model = Model(mcfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        n_params = sum(t.numel() for t in flatten(params).values())
        log(f"{arch}: {n_params / 1e9:.3f} B parameters, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        batch = {"tokens": rng.integers(4, mcfg.vocab_size,
                                        (ENGINE_BATCH, ENGINE_PROMPT),
                                        dtype=np.int64)}
        logit_err[arch] = check_ssm_logits(torch, Model, mcfg, params, batch)
        logit_err[arch]["fp32_layer"] = check_ssm_layer(torch, mcfg, params)
        e2e[f"{tag}_engine"] = engine_phase(
            torch, np, ops, f"{tag}-engine", model, params, batch, needs,
            card)
        add(e2e[f"{tag}_engine"]["launches"])
        eng = Engine(model, batch_size=ENGINE_BATCH,
                     max_len=ENGINE_PROMPT + ENGINE_GEN + 8)
        prof = profile_window(
            torch, lambda: eng.generate(params, batch, n_tokens=8,
                                        timing=False), OUR_KERNELS)
        log_profile(f"{tag}-engine, prefill + 7 decode steps", prof)
        e2e[f"profile_{tag}_engine"] = prof
        e2e[f"{tag}_continuous"] = continuous_phase(
            torch, np, ops, f"{tag}-continuous", model, params, rng,
            CONT_LENS[1] + CONT_GEN + 8, needs, card)
        add(e2e[f"{tag}_continuous"]["launches"])
        e2e[f"{tag}_params"] = n_params
        del model, params, eng
        torch.cuda.empty_cache()
    log(f"all phases in {time.perf_counter() - t_start:.1f}s")

    def entry(name, route_src, replaces, rows, worst, at):
        row = next(r for r in rows if all(r[k] == v for k, v in at.items()))
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": totals[name],
                "max_abs_err": worst, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "at": at}

    kernels = [
        entry("flash_attn_fwd", "src/repro_torch/csrc/flash_attn_fwd.cu",
              "src/repro/kernels/flash_attention.py:77", flash_rows,
              flash_err, {"B": 1, "S": 256, "D": 64}),
        entry("int8kv_decode", "src/repro_torch/csrc/int8kv_attn.cu",
              "src/repro/kernels/quantized.py:145", int8_rows, int8_err,
              {"B": 8, "Sk": 1024, "live_keys": int8_rows[1]["live_keys"]}),
        entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/mamba_scan.py:72", ssd_rows, ssd_err,
              {"B": 8, "S": 64}),
        entry("mamba1_scan", "src/repro_torch/csrc/mamba1_scan.cu",
              "src/repro/kernels/mamba_scan.py:144", m1_rows, m1_err,
              {"B": 8, "S": 64}),
    ]
    details = os.environ.get("SMOKE_DETAILS")
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "build_s": build_s,
                       "flash_attn_fwd": flash_rows,
                       "int8kv_decode": int8_rows, "ssd_scan": ssd_rows,
                       "mamba1_scan": m1_rows,
                       "logits_kernel_vs_plain": logit_err, "e2e": e2e,
                       "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
