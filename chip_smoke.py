"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version at gpt2m's serving shapes
(and times kernel, plain version and a PyTorch library yardstick beside
the card's bound), then serves gpt2m at full width (24 layers, d_model
1024, random weights from a seed) through ``Engine`` (fp32 and int8 KV)
and ``ContinuousEngine`` (int8 KV), checking that every kernel of that
path was launched, that the kernel path's first-step logits agree with
the plain path's on the card, and that the outputs are well formed.

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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain version, both bf16 out of fp32 accumulation: about one
# bf16 ulp of O(1) outputs (2^-8) plus summation order
KERNEL_ATOL = 2e-2
# first-step logits, kernel path vs plain path, bf16 through 24 layers
# of random weights: rounding differs at every layer; relative to the
# largest logit
LOGIT_RTOL = 5e-2

# ~1 ms at the H100's clocks: longer than the host takes to enqueue any
# one function timed here
SLEEP_CYCLES = 2_000_000
SEED = 0
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_GEN = 8, 64, 32
CONT_SLOTS, CONT_REQUESTS, CONT_LENS, CONT_GEN = 8, 16, (16, 256), 32


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


def bound(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- #
# kernel phases
# --------------------------------------------------------------------- #

def check_flash(torch, F, cfg):
    """Kernel A against its plain version at gpt2m prefill shapes."""
    from repro_torch.kernels import flash_attention as fa

    H, D = cfg.n_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst = [], 0.0
    # (B, S): Engine prefill (8 x 64), ContinuousEngine buckets (1 x
    # 16..256), and a ragged and a full-context shape
    for B, S in ((8, 64), (1, 16), (1, 256), (4, 128), (1, 257),
                 (1, 1024)):
        q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        got = fa.flash_attention_cuda(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            fail(f"flash_attn_fwd B={B} S={S}: max_abs_err {err} > "
                 f"{KERNEL_ATOL}")
        worst = max(worst, err)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                 # visible causal pairs
        b_ms, b_by = bound(4 * B * S * H * D * 2, 4 * D * pairs * B * H)
        row = {
            "B": B, "S": S, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True), iters=5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, is_causal=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"flash_attn_fwd B={B:2d} S={S:5d} err={err:.3e} "
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
    from repro_torch.kernels import _build, ops
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine, Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for stem, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    cfg = get_config("gpt2m")
    flash_rows, flash_err = check_flash(torch, F, cfg)
    int8_rows, int8_err = check_int8kv(torch, F, cfg)

    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                    (ENGINE_BATCH, ENGINE_PROMPT),
                                    dtype=np.int64)}

    # first-step logits: kernel path vs plain path on the card
    plain = Model(cfg, device="cuda", use_kernels=False)
    first = {}
    with torch.no_grad():
        for tag, m in (("kernels", model), ("plain", plain)):
            cache = m.init_cache(ENGINE_BATCH, ENGINE_PROMPT + 8,
                                 kv_dtype="int8")
            pre, cache = m.prefill(params, batch, cache)
            tok = torch.argmax(first["kernels"][0], -1)[:, None] \
                if first else torch.argmax(pre, -1)[:, None]
            dec, _ = m.decode_step(params, cache, tok)
            first[tag] = (pre, dec)
    logit_err = {}
    for i, what in enumerate(("prefill", "decode")):
        a, b = first["kernels"][i], first["plain"][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"non-finite {what} logits")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        logit_err[what] = {"max_abs_err": err, "max_abs_logit": scale}
        log(f"{what} logits kernel vs plain: max_abs_err {err:.4e} "
            f"(max |logit| {scale:.3f}, tolerance {LOGIT_RTOL} x that)")
        if not err <= LOGIT_RTOL * scale:
            fail(f"{what} logits disagree: {err} > {LOGIT_RTOL} * {scale}")
    del plain, first

    totals = {name: 0 for name in ops.KERNELS}
    e2e = {}
    max_len = ENGINE_PROMPT + ENGINE_GEN + 8
    for kv in ("fp32", "int8"):
        eng = Engine(model, batch_size=ENGINE_BATCH, max_len=max_len,
                     kv_dtype=kv)
        needs = ["flash_attn_fwd"] + (["int8kv_decode"] if kv == "int8"
                                      else [])
        out, counts = run_phase(
            torch, ops, f"engine-{kv}",
            lambda: eng.generate(params, batch, n_tokens=ENGINE_GEN), needs)
        check_tokens(np, out["tokens"], (ENGINE_BATCH, ENGINE_GEN),
                     cfg.vocab_size, f"engine-{kv}")
        st = out["stats"]
        e2e[f"engine_{kv}"] = {
            "batch": ENGINE_BATCH, "prompt": ENGINE_PROMPT,
            "gen": ENGINE_GEN, "ttft_s": st.prefill_s,
            "decode_steps_per_s": st.steps_per_s,
            "tokens_per_s": st.tokens_per_s, "launches": counts}
        log(f"engine kv={kv}: TTFT {st.prefill_s * 1e3:.2f} ms, decode "
            f"{st.tokens_per_s:.1f} tok/s ({st.steps_per_s:.2f} steps/s x "
            f"{ENGINE_BATCH}) on {card}")
        for k, n in counts.items():
            totals[k] += n

    # where the time goes: one int8-KV generate of 8 tokens, traced after
    # the counted phases (its launches are not in the kernels line)
    eng = Engine(model, batch_size=ENGINE_BATCH, max_len=max_len,
                 kv_dtype="int8")
    prof = profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8, timing=False),
        ("flash_fwd_kernel", "int8kv_decode_kernel"))
    if prof is None:
        log("profile: the trace holds no device events (not measured)")
    else:
        log(f"profile engine-int8, prefill + 7 decode steps: wall "
            f"{prof['wall_us'] / 1e3:.2f} ms, device busy "
            f"{prof['device_busy_us'] / 1e3:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}")
        for r in prof["top"]:
            log(f"  {r['us'] / 1e3:9.3f} ms  x{r['count']:5d}  {r['name']}")
        for r in prof["ours"]:
            log(f"  ours: {r['us'] / 1e3:9.3f} ms  x{r['count']:5d}  "
                f"{r['name']}")
    e2e["profile_engine_int8"] = prof

    lens = rng.integers(CONT_LENS[0], CONT_LENS[1] + 1, CONT_REQUESTS)
    reqs = [Request(i, rng.integers(4, cfg.vocab_size, (int(n),),
                                    dtype=np.int64))
            for i, n in enumerate(lens)]
    ce = ContinuousEngine(model, slots=CONT_SLOTS,
                          max_len=cfg.max_seq_len, kv_dtype="int8")
    res, counts = run_phase(
        torch, ops, "continuous-int8",
        lambda: ce.run(params, reqs, max_new=CONT_GEN),
        ["flash_attn_fwd", "int8kv_decode"])
    for r in reqs:
        check_tokens(np, res["outputs"][r.uid], (CONT_GEN,),
                     cfg.vocab_size, f"continuous request {r.uid}")
    st = res["stats"]
    ttft = sorted(st.ttft_s.values())
    e2e["continuous_int8"] = {
        "slots": CONT_SLOTS, "requests": CONT_REQUESTS,
        "prompt_lens": [int(n) for n in lens], "gen": CONT_GEN,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_max_s": ttft[-1], "tokens_per_s": st.tokens_per_s,
        "mean_occupancy": st.mean_occupancy, "total_s": st.total_s,
        "launches": counts}
    log(f"continuous kv=int8: {st.n_tokens} tokens in {st.total_s:.2f}s, "
        f"{st.tokens_per_s:.1f} tok/s, TTFT p50 "
        f"{np.percentile(ttft, 50) * 1e3:.1f} ms, occupancy "
        f"{st.mean_occupancy:.2f}/{CONT_SLOTS} on {card}")
    for k, n in counts.items():
        totals[k] += n

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
              flash_err, {"B": 1, "S": 256}),
        entry("int8kv_decode", "src/repro_torch/csrc/int8kv_attn.cu",
              "src/repro/kernels/quantized.py:145", int8_rows, int8_err,
              {"B": 8, "Sk": 1024, "live_keys": int8_rows[1]["live_keys"]}),
    ]
    details = os.environ.get("SMOKE_DETAILS")
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "flash_attn_fwd": flash_rows,
                       "int8kv_decode": int8_rows,
                       "logits_kernel_vs_plain": logit_err, "e2e": e2e,
                       "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
