"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version at the serving shapes of
the models below (scans from a non-zero state, and one SSD case whose
unmasked exp would overflow; kernel B at the engines' caches, with a
row that has no live key and random non-prefix masks; kernels B and 6
rerun for the same bits), and times kernel, plain version and, where
one exists, a PyTorch library yardstick beside the card's bound and a
minimal launch.  Then
it serves five models at full width with random weights from a seed:

  * gpt2m (24 layers, d_model 1024) through ``Engine`` (fp32 and int8
    KV) and ``ContinuousEngine`` (int8 KV): kernels A and B;
  * llama3.2-3b (28 layers, d_model 3072, 24 heads of 128 over 8 KV
    heads) through ``Engine`` (bf16 and int8 KV) and ``ContinuousEngine``
    (int8 KV): kernels 6 (RMSNorm), A and B at head_dim 128;
  * phi3.5-moe-42b-a6.6b (d_model 4096, 32 heads of 128 over 8, 16
    experts of d_ff 6400, top-2) cut to 8 of its 32 layers, through both
    engines (int8 KV): kernels 6, A and B at head_dim 128;
  * falcon-mamba-7b (64 Mamba1 layers, d_model 4096) through both
    engines: kernels 4 and 6;
  * zamba2-2.7b (54 Mamba2 layers in 9 groups, each behind a shared
    attention block of 32 heads of 80) through both engines: kernels 3,
    A and 6.

Then it calibrates the card as a site of the paper's TACC-TACC cluster
for gpt2m through ``repro_torch.launch.calibrate`` (kernel micro-bench
through kernels 5 and A, host ring, least-squares fit, plan search
before and after), once through the launcher at its default sizes (on
the card, the model's widths) and once by calling the micro-bench at
gpt2m's widths, checks that the JSON is the reference's ``Calibration``
schema and that both pick the same plan.

Then it pretrains gpt2m at full width and depth (batch 8 of 1024
tokens, ``TrainConfig`` defaults: remat, bf16 compute over fp32 params)
for six steps of ``repro_torch.train.train`` on the synthetic corpus,
through kernel A and its backward (``train-gpt2m``); holds one step's
loss and every gradient leaf through the kernels against the plain
attention, with the fp32 plain path as a control (``train-parity``); and
restores the checkpoint of step 4 and reruns steps 4 and 5
(``train-resume``).  Kernel A's backward is held against its plain
version beforehand, at the training shape and three others.

Then it trains gpt2L (the paper's second model: 30 layers, d_model
1280, 20 heads of 64, vocab 50257) at full width and depth, batch 8 of
1024 tokens, three steps of ``train()`` on one device (``train-gpt2L``)
and under each of the paper's flat plans, data, zero2, shard and
shard_zero, and under fsdp, on a mesh of one rank over NCCL
(``plan-data``, ..., ``plan-fsdp``): the real collectives on the card
and the plan code end to end, through kernel A and its backward; each
plan's losses are held to the one-device run's, data's, zero2's and
fsdp's params bit-equal; it prints each plan's step time, tokens/s,
6·N·D TFLOP/s, peak memory and the calls and bytes of each collective
kind a step.  Then it trains gpt2L the
same way under the pipeline plan on a (stage, data, model) mesh of one
rank, four microbatches, under GPipe, 1F1B and interleaved with an
uneven split of two chunks (``pipe-gpipe``, ``pipe-1f1b``,
``pipe-interleaved``): kernel A 240 forward and 120 backward launches a
step (remat), losses held to ``train-gpt2L``'s, the three phases
bit-equal to each other, 1F1B's peak memory over a forward and backward
of the batch below GPipe's.  Then the MoE, SSM and hybrid families at
full width, depth cut (phi3.5-MoE 2 of 32 layers, falcon-mamba 4 of 64,
zamba2 12 of 54), three steps of batch 4 of 512 random tokens through
the kernels' plain versions (their kernels have no backward on the
card), on one device, then under shard (``fam-moe-shard``, ...,
bit-equal to one device) and under pipeshard with 1F1B and four
microbatches (``fam-moe-pipe``, ..., held to one device with four
accumulated microbatches), each step updating its state in place.

For each model it checks that the kernel path's first-step logits agree
with the plain path's on the card (the MoE model's against the fp32
plain path, no farther than a bf16 control; for the SSM and hybrid
models also one full-width layer in fp32 over a prompt longer than the
scan's chunk), that every kernel of each phase was launched, and that
the outputs are well formed; it prints each phase's launches and peak
device memory.

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
# outside the tensor cores (the scan kernels' pipes), int8 tensor cores,
# HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# TF32 tensor cores (kernel 3's products, three a 3xTF32 product), and
# the special-function units' exponentials: 16 a clock an SM (the clock
# read from nvidia-smi's clocks.max.sm)
PEAK_TF32_FLOPS = 495e12
SFU_PER_SM_CLK = 16
# kernel 5's promotion of each K block's int32 partial: two fp32
# instructions, an add and an FMA, at 128 a clock an SM (its one integer
# add, at 64 or more a clock an SM, never takes longer than these two)
FP32_PER_SM_CLK = 128
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

# kernel 5 vs its plain version: the same exact int32 partials and the
# same fp32 accumulation order; only FMA contraction of partial * scale
# into the sum differs, relative to the largest output
INT8MM_RTOL = 1e-5
# ...and the reference's gate on the int8 product against fp32: relative
# Frobenius error (tests/test_quantized.py)
INT8MM_FROB = 0.02
# (M, K, N, block): the reference's dequant test; the calibration
# micro-bench's default and wide sizes at blocks 64; gpt2m's MLP at
# blocks 128 over 8 sequences of 1024 tokens (up and down projection);
# a shape that pads on every axis
INT8MM_SHAPES = ((64, 96, 64, 32), (128, 128, 128, 64), (192, 192, 192, 64),
                 (1024, 1024, 1024, 64), (4096, 4096, 4096, 64),
                 (8192, 1024, 4096, 128), (8192, 4096, 1024, 128),
                 (1000, 1000, 1000, 128))
CAL_CLUSTER, CAL_MODEL = "TACC-TACC", "gpt2m"
# kernel A's backward vs its plain version on the same bf16 inputs and
# lse: both accumulate in fp32 and round dq, dk, dv once to bf16 (2^-8
# of the value); relative to the largest gradient, since dk and dv sum
# over up to 1024 queries and the group's heads
BWD_RTOL = 1e-2
# kernel A's logsumexp vs the plain one, fp32 from the same bf16 inputs
LSE_ATOL = 1e-4
# (B, S, H, KV, D), causal: gpt2m training; ragged; grouped-query;
# zamba2's head dim
BWD_SHAPES = ((8, 1024, 16, 16, 64), (1, 257, 16, 16, 64),
              (1, 128, 4, 2, 64), (1, 256, 32, 32, 80))
# training: gpt2m at full width and depth, batch 8 of max_seq_len (1024)
# tokens, six steps with a checkpoint at step 4; enough synthetic
# documents (~200 tokens each) for 48 distinct windows of 1025 tokens
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_DOCS = 8, 6, 4, 400
# train-parity, kernel path vs plain path in bf16: the loss directly
# within 1e-2 relative (a few bf16 ulps); against the fp32 plain path
# (the control's truth), the kernel path's loss, global gradient norm
# and each leaf's 1 - cosine may stray at most NOISE_FACTOR times as far
# as the bf16 plain path's do, plus a floor for a control that is near 0
# by luck (1e-3 relative for loss and norm, 1e-4 for 1 - cosine)
TRAIN_LOSS_RTOL = 1e-2
TRAIN_NORM_FLOOR, TRAIN_COS_FLOOR = 1e-3, 1e-4
# train-resume: the rerun of steps 4 and 5 from the restored checkpoint;
# nothing on the path sums with atomics (F.embedding's backward and the
# kernels are ordered), so the losses are expected equal; 1e-5 relative
# leaves room for a library that is not
RESUME_RTOL = 1e-5
# the plan phases: gpt2L at full width and depth, three steps of batch 8
# of 1024 tokens on one device and under each flat plan over NCCL at a
# world of one.  Under shard and shard_zero the loss's logsumexp and the
# embedding lookups run their vocab-parallel forms (the same operations
# as one device's on a model axis of one rank, but a bf16 rounding that
# fell apart would grow through AdamW), so their losses are held to 1e-5
# relative and their bit-equality is reported; data and zero2 do the
# same operations as one device, and their params must be bit-equal
# after the three steps; so must fsdp's, which runs shard's operations
# on each layer's leaves gathered whole (copies at one rank).
PLAN_ARCH, PLAN_STEPS, PLAN_DOCS = "gpt2L", 3, 3 * TRAIN_BATCH
PLAN_NAMES = ("data", "zero2", "shard", "shard_zero", "fsdp")
PLAN_BIT_EQUAL = ("data", "zero2", "fsdp")
PLAN_LOSS_RTOL = 1e-5
# the family phases: the MoE, SSM and hybrid families at full width,
# depth cut, under shard and under pipeshard (1F1B, FAM_MICRO
# microbatches) at a world of one, three steps of batch 4 of 512 random
# tokens each, through the kernels' plain versions (rows 1b and 3 to 6
# have no backward on the card).  shard is held bit-equal to the
# one-device port; pipeshard to the one-device port with grad_accum =
# FAM_MICRO (each microbatch routed as one, as pipeshard routes it),
# within FAM_LOSS1_RTOL at step 1 and FAM_LOSS_RTOL after.  The steps
# update their params and optimizer state in place (donate): phi3.5-MoE
# at 2 layers holds 2.86 B fp32 params, 11.5 GB a copy.
FAM_MODELS = (("moe", "phi3.5-moe-42b-a6.6b", 2),
              ("ssm", "falcon-mamba-7b", 4),
              ("hybrid", "zamba2-2.7b", 12))
FAM_BATCH, FAM_SEQ, FAM_STEPS, FAM_MICRO = 4, 512, 3, 4
FAM_LOSS1_RTOL, FAM_LOSS_RTOL = 1e-5, 1e-3
# the pipe phases: gpt2L under pipeshard on a (stage, data, model) mesh
# of (1, 1, 1), the batch of 8 cut into PIPE_MICRO microbatches, under
# each schedule; interleaved runs two chunks, the uneven (16, 14).  Each
# microbatch's loss divides by the whole batch's token count and the
# microbatch sums of bf16 GEMMs differ from the one-device batch's in
# rounding only: the step-1 loss within PIPE_LOSS1_RTOL of train-gpt2L's,
# every step within PIPE_LOSS_RTOL (AdamW grows the rounding).  The three
# phases do the same operations in other orders, so their losses and
# params must be bit-equal.
PIPE_MICRO = 4
PIPE_PHASES = (("gpipe", None), ("1f1b", None), ("interleaved", (16, 14)))
PIPE_LOSS1_RTOL, PIPE_LOSS_RTOL = 1e-4, 2e-3
# the calibration micro-bench's flash sample (calib/microbench.py):
# (H, KV, D) and (B, S), causal; grouped-query, unlike the models here
CAL_FLASH_HEADS, CAL_FLASH_BS = (4, 2, 64), (1, 128)

# kernel 6 (RMSNorm) against its plain version: fp32 within 1e-5 of the
# largest output (the mean of squares sums in another order; rsqrtf is
# within 2 ulps); bf16 within one ulp of each value (the output's
# rounding may fall either side of an fp32 difference).  Shapes: the
# widths of zamba2 (2560), llama3.2 (3072) and phi3.5-MoE and
# falcon-mamba (4096), at decode (8 rows), a ragged prefill and the
# Engine prefill (8 x 64)
RMS_FP32_RTOL = 1e-5
RMS_DS, RMS_ROWS = (2560, 3072, 4096), (8, 257, 512)
# the slice-5 models: llama3.2-3b at full width and depth; phi3.5-MoE at
# full width, cut to MOE_LAYERS of its 32 layers (10.7 B parameters, 43
# GB in fp32; all 32 would need ~167 GB in fp32, 84 GB in bf16)
LLAMA, MOE, MOE_LAYERS = "llama3.2-3b", "phi3.5-moe-42b-a6.6b", 8
NORM_ATTN = ("rmsnorm", "flash_attn_fwd")

# ~1 ms at the H100's clocks: longer than the host takes to enqueue any
# one function timed here
SLEEP_CYCLES = 2_000_000
# the minimal launch timed beside the decode kernels: a sleep of a few
# cycles
FLOOR_CYCLES = 10
SEED = 0
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_GEN = 8, 64, 32
CONT_SLOTS, CONT_REQUESTS, CONT_LENS, CONT_GEN = 8, 16, (16, 256), 32
# the scans' shapes: Engine prefill (8 x 64), ContinuousEngine's one
# request at a time at its prompt's length (1 x 16 to 256), a ragged
# 257; for kernel 3 also dt up to 4 with A down to -16, which sums to
# ~ -2000 over a chunk of 64
MAMBA1_CASES = ((8, 64), (1, 257), (1, 16), (1, 64), (1, 136), (1, 256))
SSD_CASES = ((8, 64, 0.1), (1, 257, 0.1), (1, 128, 4.0), (1, 16, 0.1),
             (1, 64, 0.1), (1, 136, 0.1), (1, 256, 0.1))
# the SSM and hybrid phases: (tag, arch, kernels each phase must launch)
SSM_MODELS = (("ssm", "falcon-mamba-7b", ("mamba1_scan", "rmsnorm")),
              ("hybrid", "zamba2-2.7b", ("ssd_scan", "flash_attn_fwd",
                                         "rmsnorm")))


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


def bound(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS,
          also=()):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate, the flops over ``peak_flops`` and each further
    ``(operations, rate)`` of ``also`` (units that run side by side:
    tensor cores, fp32 pipes, special functions)."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max([flops / peak_flops] + [n / rate for n, rate in also])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int8mm_bound(Mp, Kp, Np, bk, n_scales, sm_hz, n_sm):
    """(ms, "bytes" or "operations") of kernel 5 on padded [Mp, Kp] x
    [Kp, Np] int8 operands with K blocks of ``bk``: int8 x and w,
    ``n_scales`` fp32 scales and the fp32 output each moved once; the
    tensor cores' 2 M N K operations beside the promotion's 2 M N K/bk
    fp32 instructions at ``sm_hz`` on ``n_sm`` SMs."""
    n_bytes = Mp * Kp + Kp * Np + 4 * n_scales + 4 * Mp * Np
    promotions = Mp * Np * (Kp // bk)
    clk = sm_hz * n_sm
    return bound(n_bytes, 2.0 * Mp * Np * Kp, PEAK_INT8_OPS,
                 also=[(2 * promotions, FP32_PER_SM_CLK * clk)])


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), in
    Hz: the special-function units' rate in the scans' bounds."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def add_rates(row, flops):
    """Kernel A's achieved TFLOP/s and its time over SDPA's and over the
    bound, into ``row``."""
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    row["x_library"] = row["ms"] / row["library_ms"]
    row["x_bound"] = row["ms"] / row["bound_ms"]
    return row


def scan_err(torch, got, want) -> float:
    """Largest |got - want| in units of the scan tolerance (<= 1 passes)."""
    tol = SCAN_ATOL + SCAN_RTOL * want.abs()
    return float(((got - want).abs() / tol).max())


# --------------------------------------------------------------------- #
# kernel phases
# --------------------------------------------------------------------- #

def check_flash(torch, F, H, KV, D, shapes):
    """Kernel A against its plain version, causal, with H query heads over
    KV key/value heads of D, at prefill shapes ``(B, S)``."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst = [], 0.0
    for B, S in shapes:
        q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (H, KV, KV))
        got = fa.flash_attention_cuda(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            fail(f"flash_attn_fwd H={H} KV={KV} D={D} B={B} S={S}: "
                 f"max_abs_err {err} > {KERNEL_ATOL}")
        worst = max(worst, err)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2                 # visible causal pairs
        flops = 4 * D * pairs * B * H
        # bf16 q and output at H heads, k and v at KV heads
        b_ms, b_by = bound(2 * B * S * (2 * H + 2 * KV) * D, flops)
        row = {
            "B": B, "S": S, "H": H, "KV": KV, "D": D, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True), iters=5),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, is_causal=True, enable_gqa=KV != H)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(add_rates(row, flops))
        log(f"flash_attn_fwd H={H} KV={KV} D={D} B={B:2d} S={S:5d} "
            f"err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}) {row['tflops']:.1f} TFLOP/s, "
            f"{row['x_library']:.2f}x SDPA, {row['x_bound']:.1f}x bound")
    return rows, worst


def check_flash_bwd(torch, F):
    """Kernel A's backward against its plain version on the same bf16
    inputs and the forward kernel's lse, causal, at ``BWD_SHAPES``; the
    forward's lse against the plain logsumexp; SDPA's backward (same
    mask) as the yardstick."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, worst = [], 0.0
    for B, S, H, KV, D in BWD_SHAPES:
        q, k, v, do = (torch.randn((B, S, h, D), generator=g, device="cuda")
                       .to(torch.bfloat16) for h in (H, KV, KV, H))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True,
                                         return_lse=True)
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal=True,
                                                return_lse=True)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        what = f"flash_attn_bwd B={B} S={S} H={H} KV={KV} D={D}"
        lse_err = float((lse - lse_plain).abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"{what}: lse max_abs_err {lse_err} > {LSE_ATOL}")
        err, rel = 0.0, {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                fail(f"{what}: non-finite {name}")
            e = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            if not e <= BWD_RTOL * scale:
                fail(f"{what}: {name} max_abs_err {e} > {BWD_RTOL} * "
                     f"{scale}")
            err, rel[name] = max(err, e), e / scale
        worst = max(worst, err)
        qT, kT, vT = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qT, kT, vT, is_causal=True,
                                             enable_gqa=KV != H)
        doT = do.transpose(1, 2).contiguous()
        pairs = S * (S + 1) // 2                 # visible causal pairs
        # bf16 q, o, dO and dq at H heads, k, v, dk, dv at KV heads, fp32
        # lse; five causal products (S, dP, dV, dK, dQ) of 2 D flops a pair
        n_bytes = 2 * B * S * D * (4 * H + 4 * KV) + 4 * B * H * S
        flops = 10 * D * pairs * B * H
        b_ms, b_by = bound(n_bytes, flops)
        row = {
            "B": B, "S": S, "H": H, "KV": KV, "D": D, "max_abs_err": err,
            "rel_err": rel, "lse_max_abs_err": lse_err,
            "ms": time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, do, lse)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse), iters=3, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                out, (qT, kT, vT), doT, retain_graph=True)),
            "fwd_lse_ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=True, return_lse=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(add_rates(row, flops))
        log(f"{what} err={err:.3e} rel dq/dk/dv="
            f"{rel['dq']:.2e}/{rel['dk']:.2e}/{rel['dv']:.2e} "
            f"lse_err={lse_err:.2e} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"sdpa_bwd_ms={row['library_ms']:.4f} "
            f"fwd_with_lse_ms={row['fwd_lse_ms']:.4f} bound_ms={b_ms:.5f} "
            f"({b_by}) {row['tflops']:.1f} TFLOP/s of the five products, "
            f"{row['x_library']:.2f}x SDPA's backward, "
            f"{row['x_bound']:.1f}x bound")
    return rows, worst


def decode_mask(torch, g, B, Sk, fills):
    """[B, Sk] key validity of a decode cache: ``(lo, hi)`` fills row
    prefixes from lo to hi keys; ``"mixed"`` gives row 0 no live key and
    the other rows random non-prefix masks of rising density."""
    if fills == "mixed":
        dens = torch.linspace(0.05, 0.9, B, device="cuda")[:, None]
        valid = torch.rand((B, Sk), generator=g, device="cuda") < dens
        valid[0] = False
        return valid
    fill = torch.linspace(fills[0], fills[1], B,
                          device="cuda").round().long()
    return torch.arange(Sk, device="cuda")[None] < fill[:, None]


def check_int8kv(torch, F, H, KV, D, cases, seed):
    """Kernel B against its plain version with H query heads over KV
    key/value heads of D, at decode shapes ``(B, Sk, fills)`` (masks as
    ``decode_mask`` makes them); a rerun must give the same bits."""
    from repro_torch.kernels import quantized as qz

    g = torch.Generator(device="cuda").manual_seed(seed)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for B, Sk, fills in cases:
        q = torch.randn((B, 1, H, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        kq, ks = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                         device="cuda"), block=D)
        vq, vs = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                         device="cuda"), block=D)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        valid = decode_mask(torch, g, B, Sk, fills)
        args = (q, kq, ks, vq, vs, valid)
        got = qz.int8kv_attention_cuda(*args)
        again = qz.int8kv_attention_cuda(*args)
        want = qz.int8kv_attention_plain(*args)
        torch.cuda.synchronize()
        what = (f"int8kv_decode H={H} KV={KV} D={D} B={B} Sk={Sk} "
                f"fills={fills}")
        err = float((got.float() - want.float()).abs().max())
        if not err <= KERNEL_ATOL:
            fail(f"{what}: max_abs_err {err} > {KERNEL_ATOL}")
        if not torch.equal(got, again):
            fail(f"{what}: a rerun gave other bits")
        worst = max(worst, err)
        # what this data needs: K, V and both scales of each live key; a
        # row with no live key averages all its values (V and v scale);
        # the mask, q and the output
        live = int(valid.sum())
        dead = int((valid.sum(1) == 0).sum())
        n_bytes = live * KV * (2 * D + 2 * 4) + dead * Sk * KV * (D + 4) \
            + B * Sk + 2 * B * H * D * 2
        b_ms, b_by = bound(n_bytes, 4 * D * live * H + 2 * D * dead * Sk * H)
        # yardstick: SDPA over K/V already dequantized to bf16 with the
        # same mask (no PyTorch call takes the int8 cache itself)
        kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vq.float() * vs[..., None]).to(torch.bfloat16)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, kd, vd))
        mask = valid[:, None, None, :]
        row = {
            "B": B, "Sk": Sk, "H": H, "KV": KV, "D": D, "live_keys": live,
            "fills": fills, "max_abs_err": err, "rerun_bit_equal": True,
            "splits": qz.int8kv_splits(B, KV, Sk, n_sm),
            "ms": time_ms(torch, lambda: qz.int8kv_attention_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: qz.int8kv_attention_plain(
                *args)),
            "library_ms": None,
            "sdpa_dequant_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask, enable_gqa=KV != H)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"{what} live={live:5d} splits={row['splits']} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_on_dequantized_ms={row['sdpa_dequant_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


def bf16_ulp(torch, x):
    """One bf16 ulp of each entry of an fp32 tensor (8 significant
    bits)."""
    _, e = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), e - 8)


def launch_floor_ms(torch) -> float:
    """Device time of a minimal launch (``torch.cuda._sleep`` of a few
    cycles), timed as every kernel here is: the floor under the tiny
    decode kernels' times."""
    return time_ms(torch, lambda: torch.cuda._sleep(FLOOR_CYCLES))


def check_rmsnorm(torch, F, floor_ms):
    """Kernel 6 against its plain version at the RMSNorm models' widths,
    in bf16 (the served models) and fp32; a rerun must give the same
    bits.  The yardstick is ``F.rms_norm`` with the weight in x's dtype
    (its fused path wants one dtype)."""
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out, worst = [], 0.0
    shapes = [(rows, d) for d in RMS_DS for rows in RMS_ROWS]
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in shapes:
            x = (torch.randn((rows, d), generator=g, device="cuda") * 3
                 + 0.5).to(dtype)
            w = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
            got = rn.rmsnorm_cuda(x, w, eps=1e-5)
            again = rn.rmsnorm_cuda(x, w, eps=1e-5)
            want = rn.rmsnorm_plain(x, w, 1e-5)
            torch.cuda.synchronize()
            what = f"rmsnorm {str(dtype)[6:]} rows={rows} d={d}"
            if not torch.isfinite(got).all():
                fail(f"{what}: non-finite output")
            if not torch.equal(got, again):
                fail(f"{what}: a rerun gave other bits")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.float32:
                ok = err <= RMS_FP32_RTOL * float(want.abs().max())
            else:
                ok = bool((diff <= bf16_ulp(torch, want.float())).all())
            if not ok:
                fail(f"{what}: max_abs_err {err} beyond the tolerance")
            worst = max(worst, err)
            esz = x.element_size()
            # x read once, y written once, the fp32 weight; per
            # element a square-add, and two products
            b_ms, b_by = bound(2 * rows * d * esz + 4 * d, 4 * rows * d,
                               PEAK_FP32_FLOPS)
            wl = w.to(dtype)
            row = {"rows": rows, "d": d, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "rerun_bit_equal": True,
                   "plan": list(rn.rmsnorm_plan(rows, d, n_sm)),
                   "launch_floor_ms": floor_ms,
                   "ms": time_ms(torch, lambda: rn.rmsnorm_cuda(
                       x, w, eps=1e-5)),
                   "plain_ms": time_ms(torch, lambda: rn.rmsnorm_plain(
                       x, w, 1e-5)),
                   "library_ms": time_ms(torch, lambda: F.rms_norm(
                       x, (d,), wl, eps=1e-5)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows_out.append(row)
            log(f"{what} plan={row['plan']} err={err:.3e} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"rms_norm_ms={row['library_ms']:.4f} "
                f"bound_ms={b_ms:.5f} ({b_by}) "
                f"launch_floor_ms={floor_ms:.4f}")
    return rows_out, worst


def mamba1_inputs(torch, cfg, g, B, S):
    """Kernel 4's operands at falcon-mamba's widths, from a non-zero
    state, with B and C as strided slices of one projection, as an fp32
    model hands them (the served bf16 model's ``.float()`` hands
    contiguous copies)."""
    di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    x = torch.randn((B, S, di), generator=g, device="cuda")
    dt = torch.rand((B, S, di), generator=g, device="cuda") * 0.1
    bc = torch.randn((B, S, 2 * ds), generator=g, device="cuda")
    A = -torch.arange(1, ds + 1, device="cuda",
                      dtype=torch.float32).expand(di, ds).contiguous()
    h0 = torch.randn((B, di, ds), generator=g, device="cuda")
    return x, dt, bc[..., :ds], bc[..., ds:], A, h0


def mamba1_bound(B, S, di, ds, sfu):
    """Kernel 4's bound: x, dt, y, B, C, A, h0 and h_last moved once (fp32);
    per (t, c, s) dt a, an FMA for h and one for y (5 fp32 flops) at 67
    TFLOP/s, and its exp on the special-function units (``sfu``
    exponentials a second: 16 a clock an SM)."""
    n_bytes = 4 * (3 * B * S * di + 2 * B * S * ds + di * ds
                   + 2 * B * di * ds)
    return bound(n_bytes, B * S * di * (5 * ds + 1), PEAK_FP32_FLOPS,
                 also=[(B * S * di * ds, sfu)])


def check_mamba1(torch, cfg, sfu):
    """Kernel 4 against its plain version at falcon-mamba's prefill
    shapes (``MAMBA1_CASES``); a rerun must give the same bits."""
    from repro_torch.kernels import mamba_scan as ms

    di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for B, S in MAMBA1_CASES:
        args = mamba1_inputs(torch, cfg, g, B, S)
        y, h = ms.mamba1_scan_cuda(*args)
        y2, h2 = ms.mamba1_scan_cuda(*args)
        wy, wh = ms.mamba1_scan_plain(*args)
        torch.cuda.synchronize()
        what = f"mamba1_scan B={B} S={S}"
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = max(scan_err(torch, y, wy), scan_err(torch, h, wh))
        if not rel <= 1.0:
            fail(f"{what}: max_abs_err {err} beyond atol {SCAN_ATOL} + "
                 f"rtol {SCAN_RTOL}")
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            fail(f"{what}: a rerun gave other bits")
        worst = max(worst, err)
        b_ms, b_by = mamba1_bound(B, S, di, ds, sfu)
        row = {"B": B, "S": S, "di": di, "ds": ds, "max_abs_err": err,
               "rerun_bit_equal": True,
               "lanes": ms.mamba1_plan(B, di, ds, n_sm),
               "ms": time_ms(torch, lambda: ms.mamba1_scan_cuda(*args)),
               "plain_ms": time_ms(torch, lambda: ms.mamba1_scan_plain(
                   *args), iters=3, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"{what:24s} lanes={row['lanes']} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


def ssd_work(B, S, nh, hd, ds, K):
    """(tensor-core flops, fp32 flops, exps) the SSD scan needs for these
    inputs.  Per chunk of kc rows and batch row: the kc(kc+1)/2 visible
    C.B scores, once (B and C are shared by the heads).  Per head
    besides: M X over the visible entries, C h^T and X^T diag(w) B, on
    the tensor cores, three TF32 products each (3xTF32); each visible M
    entry's exp and two products, exp(s_i) C_i, w_j x_j and the decay in
    fp32; the exps of M, exp(s_i), w_j and the decay."""
    tc = fp = ex = 0
    for c0 in range(0, S, K):
        kc = min(K, S - c0)
        tri = kc * (kc + 1) // 2
        tc += 3 * (2 * tri * ds + nh * 2 * (tri * hd + 2 * kc * hd * ds))
        fp += nh * (3 * tri + kc * ds + kc * hd + 2 * kc + hd * ds)
        ex += nh * (tri + 2 * kc + 1)
    return float(tc * B), float(fp * B), float(ex * B)


def ssd_inputs(torch, cfg, g, B, S, dt_scale):
    """Kernel 3's operands at zamba2's widths, from a non-zero state,
    with x, B and C as strided views of one conv output, as an fp32 model
    hands them (the served bf16 model's ``.float()`` hands contiguous
    copies)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    hd, ds = s.head_dim, s.d_state
    nh = di // hd
    xbc = torch.randn((B, S, di + 2 * ds), generator=g, device="cuda")
    xh = xbc[..., :di].reshape(B, S, nh, hd)
    b_s, c_s = xbc[..., di:di + ds], xbc[..., di + ds:]
    dt = torch.rand((B, S, nh), generator=g, device="cuda") * dt_scale
    a = -torch.linspace(1.0, 16.0, nh, device="cuda")
    h0 = torch.randn((B, nh, hd, ds), generator=g, device="cuda")
    return xh, dt, b_s, c_s, a, h0


def ssd_bound(B, S, nh, hd, ds, K, sfu):
    """Kernel 3's bound: x and y, dt, B and C, a, h0 and h_last moved once
    (fp32); ``ssd_work``'s products on the TF32 tensor cores, its other
    flops at the fp32 rate, its exps on the special-function units."""
    tc, fp, ex = ssd_work(B, S, nh, hd, ds, K)
    n_bytes = 4 * (2 * B * S * nh * hd + B * S * nh + 2 * B * S * ds + nh
                   + 2 * B * nh * hd * ds)
    return bound(n_bytes, tc, PEAK_TF32_FLOPS,
                 also=[(fp, PEAK_FP32_FLOPS), (ex, sfu)])


def check_ssd(torch, cfg, sfu):
    """Kernel 3 against its plain version at zamba2's prefill shapes
    (``SSD_CASES``), one with in-chunk log-decays of thousands, where an
    exp before the mask would overflow; a rerun must give the same
    bits."""
    from repro_torch.kernels import mamba_scan as ms

    s = cfg.ssm
    di = s.expand * cfg.d_model
    hd, ds, K = s.head_dim, s.d_state, s.chunk
    nh = di // hd
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for B, S, dt_scale in SSD_CASES:
        args = ssd_inputs(torch, cfg, g, B, S, dt_scale)
        y, h = ms.ssd_scan_cuda(*args, chunk=K)
        y2, h2 = ms.ssd_scan_cuda(*args, chunk=K)
        wy, wh = ms.ssd_scan_plain(*args)
        torch.cuda.synchronize()
        what = f"ssd_scan B={B} S={S} dt_scale={dt_scale}"
        if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
            fail(f"{what}: non-finite")
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = max(scan_err(torch, y, wy), scan_err(torch, h, wh))
        if not rel <= 1.0:
            fail(f"{what}: max_abs_err {err} beyond atol {SCAN_ATOL} + "
                 f"rtol {SCAN_RTOL}")
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            fail(f"{what}: a rerun gave other bits")
        worst = max(worst, err)
        b_ms, b_by = ssd_bound(B, S, nh, hd, ds, K, sfu)
        row = {"B": B, "S": S, "nh": nh, "hd": hd, "ds": ds, "chunk": K,
               "dt_scale": dt_scale, "max_abs_err": err,
               "rerun_bit_equal": True,
               "stages": ms.ssd_plan(B, nh, n_sm, -(-S // K)),
               "ms": time_ms(torch, lambda: ms.ssd_scan_cuda(*args,
                                                               chunk=K)),
               "plain_ms": time_ms(torch, lambda: ms.ssd_scan_plain(*args),
                                   iters=3, warmup=1),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"{what:36s} stages={row['stages']} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
    return rows, worst


def check_int8_matmul(torch, sm_hz):
    """Kernel 5 against its plain version on the same padded, quantized
    operands, a rerun to the same bits, and the product against the fp32
    matmul (TF32 off); timed beside ``torch._int_mm`` with w row-major
    and column-major (cuBLASLt's preferred layout)."""
    from repro_torch.kernels import quantized as qz
    from repro_torch.kernels.ops import int8_operands
    from repro_torch.kernels.ref import matmul_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows, worst = [], 0.0
    for M, K, N, blk in INT8MM_SHAPES:
        x = torch.randn((M, K), generator=g, device="cuda")
        w = torch.randn((K, N), generator=g, device="cuda")
        blocks = dict(block_m=blk, block_k=blk, block_n=blk)
        xq, xs, wq, ws = int8_operands(x, w, **blocks)
        got = qz.int8_matmul_cuda(xq, xs, wq, ws, **blocks)
        again = qz.int8_matmul_cuda(xq, xs, wq, ws, **blocks)
        want = qz.int8_matmul_plain(xq, xs, wq, ws, **blocks)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"int8_matmul {M}x{K}x{N}/{blk}: non-finite output")
        if not torch.equal(got, again):
            fail(f"int8_matmul {M}x{K}x{N}/{blk}: a rerun gave other bits")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= INT8MM_RTOL * scale:
            fail(f"int8_matmul {M}x{K}x{N}/{blk}: max_abs_err {err} > "
                 f"{INT8MM_RTOL} * {scale}")
        worst = max(worst, err)
        fp32 = matmul_ref(x, w)
        frob = float(torch.linalg.norm(got[:M, :N] - fp32)
                     / torch.linalg.norm(fp32))
        if not frob < INT8MM_FROB:
            fail(f"int8_matmul {M}x{K}x{N}/{blk}: relative Frobenius error "
                 f"{frob} against fp32 >= {INT8MM_FROB}")
        Mp, Kp = xq.shape
        Np = wq.shape[1]
        b_ms, b_by = int8mm_bound(
            Mp, Kp, Np, blk, xs.numel() + ws.numel(), sm_hz,
            torch.cuda.get_device_properties(0).multi_processor_count)
        w_cols = wq.t().contiguous().t()
        row = {"M": M, "K": K, "N": N, "block": blk,
               "padded": [Mp, Kp, Np], "max_abs_err": err,
               "max_abs_plain": scale, "frobenius_vs_fp32": frob,
               "ms": time_ms(torch, lambda: qz.int8_matmul_cuda(
                   xq, xs, wq, ws, **blocks)),
               "plain_ms": time_ms(torch, lambda: qz.int8_matmul_plain(
                   xq, xs, wq, ws, **blocks), iters=5, warmup=1),
               "library": "torch._int_mm (int8 x int8 -> int32, no "
                          "per-tile scales), w column-major",
               "library_ms": time_ms(torch,
                                     lambda: torch._int_mm(xq, w_cols)),
               "library_row_major_ms": time_ms(
                   torch, lambda: torch._int_mm(xq, wq)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"int8_matmul {M}x{K}x{N} block {blk} err={err:.3e} "
            f"frob={frob:.4f} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"int_mm_ms*={row['library_ms']:.4f} (w row-major "
            f"{row['library_row_major_ms']:.4f}) bound_ms={b_ms:.5f} "
            f"({b_by})")
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


PHASES = {}      # phase -> wall time, launches, peak device memory


def run_phase(torch, ops, name, fn, needs):
    """Drive one main-path phase with the launch counts set to 0 just
    before and read just after; every kernel in ``needs`` must launch."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    before = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    after = torch.cuda.memory_stats()
    # the caching allocator's calls to the driver over the phase
    allocator = {k: after.get(k, 0) - before.get(k, 0) for k in
                 ("num_device_alloc", "num_device_free",
                  "num_alloc_retries")}
    PHASES[name] = {"wall_s": wall, "launches": counts,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "allocator": allocator}
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        fail(f"phase {name}: kernels {missing} never launched ({counts})")
    log(f"phase {name}: {wall:.2f}s, peak memory "
        f"{PHASES[name]['peak_bytes'] / 2**30:.2f} GiB, launches {counts}, "
        f"allocator {allocator}")
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
    mine = {k: v for k, v in by_name.items() if kernel_of(k, ours)}
    per_kernel = {}
    for k, (t, n) in mine.items():
        rec = per_kernel.setdefault(kernel_of(k, ours),
                                    {"us": 0.0, "count": 0})
        rec["us"] += t
        rec["count"] += n
    for rec in per_kernel.values():
        rec["share"] = rec["us"] / busy_us
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "idle_share": 1.0 - busy_us / wall_us,
            "top": [{"name": k[:80], "us": t, "count": n}
                    for k, (t, n) in top],
            "ours": [{"name": k[:80], "us": t, "count": n}
                     for k, (t, n) in mine.items()],
            "per_kernel": per_kernel}


def kernel_of(event_name, ours):
    """The port's kernel (``ours``: CUDA function name -> kernel) that a
    trace event of that name belongs to, or None."""
    return next((kern for fn, kern in ours.items() if fn in event_name),
                None)


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
    within ``share`` (one number, or one a step) of the largest |want|
    logit."""
    out = {}
    for i, step in enumerate(("prefill", "decode")):
        share_i = share[step] if isinstance(share, dict) else share
        a, b = got[i].float(), want[i].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{what}: non-finite {step} logits")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        out[step] = {"max_abs_err": err, "max_abs_logit": scale,
                     "tolerance_share": share_i}
        log(f"{what} {step}: max_abs_err {err:.4e} (max |logit| "
            f"{scale:.3f}, tolerance {share_i:.4g} x that)")
        if not err <= share_i * scale:
            fail(f"{what} {step} logits disagree: {err} > {share_i:.4g} * "
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


def check_moe_logits(torch, Model, cfg, params, batch):
    """First-step logits of the MoE model (int8 KV), kernel path against
    the fp32 plain path on the card.  Two correct bf16 paths may route a
    near-tie token to different experts, so the kernel path is held to a
    control: it may be no farther from the fp32 plain path than
    ``NOISE_FACTOR`` times the bf16 plain path is (as ``train-parity``
    holds its gradients)."""
    import dataclasses

    k = first_step(torch, Model(cfg, device="cuda"), params, batch, "int8")
    p = first_step(torch, Model(cfg, device="cuda", use_kernels=False),
                   params, batch, "int8", k[2])
    f = first_step(torch, Model(dataclasses.replace(cfg, dtype="float32"),
                                device="cuda", use_kernels=False),
                   params, batch, "int8", k[2])
    control = compare_logits(torch, f"{cfg.name} control: bf16 plain vs "
                             f"fp32 plain", p, f, 1.0)
    share = {step: NOISE_FACTOR * v["max_abs_err"] / v["max_abs_logit"]
             for step, v in control.items()}
    return {"bf16_control": control, "kernel_vs_fp32": compare_logits(
        torch, f"{cfg.name} logits kernel (bf16) vs fp32 plain", k, f,
        share)}


def slice5_phases(torch, np, ops, card):
    """Phases ``llama-engine`` (bf16 KV), ``llama-int8``,
    ``llama-continuous``, ``moe-engine`` and ``moe-continuous`` (int8
    KV): llama3.2-3b at full width and depth, phi3.5-MoE at full width
    and ``MOE_LAYERS`` layers, one model on the card at a time.  Every
    Engine phase must launch kernel 6 2L + 1 times a forward pass, A L
    times (its prefill) and B L times a decode step (int8 KV).  Returns
    (records, first-step logit checks)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    rng = np.random.default_rng(SEED + 5)
    out, logits = {}, {}
    for tag, arch in (("llama", LLAMA), ("moe", MOE)):
        mcfg = get_config(arch)
        if tag == "moe":
            log(f"{arch}: depth cut to {MOE_LAYERS} of {mcfg.n_layers} "
                f"layers (all {mcfg.n_layers} hold "
                f"{mcfg.param_count() / 1e9:.1f} B parameters, "
                f"{4 * mcfg.param_count() / 1e9:.0f} GB in fp32: more than "
                f"one card); width unchanged")
            mcfg = dataclasses.replace(mcfg, n_layers=MOE_LAYERS)
        L = mcfg.n_layers
        model = Model(mcfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        n_params = sum(t.numel() for t in flatten(params).values())
        log(f"{arch}: {L} layers, {n_params / 1e9:.3f} B parameters, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        batch = {"tokens": rng.integers(4, mcfg.vocab_size,
                                        (ENGINE_BATCH, ENGINE_PROMPT),
                                        dtype=np.int64)}
        if tag == "llama":
            k = first_step(torch, model, params, batch, "int8")
            p = first_step(torch, Model(mcfg, device="cuda",
                                        use_kernels=False),
                           params, batch, "int8", k[2])
            logits[arch] = compare_logits(
                torch, f"{arch} logits kernel vs plain", k, p, LOGIT_RTOL)
            del k, p
        else:
            logits[arch] = check_moe_logits(torch, Model, mcfg, params,
                                            batch)
        kvs = (("engine", "fp32"), ("int8", "int8")) if tag == "llama" \
            else (("engine", "int8"),)
        for phase, kv in kvs:
            name = f"{tag}-{phase}"
            needs = NORM_ATTN + (("int8kv_decode",) if kv == "int8" else ())
            rec = engine_phase(torch, np, ops, name, model, params, batch,
                               needs, card, kv_dtype=kv)
            want = {"rmsnorm": (2 * L + 1) * ENGINE_GEN,
                    "flash_attn_fwd": L,
                    "int8kv_decode": L * (ENGINE_GEN - 1)
                    if kv == "int8" else 0}
            for kname, n in want.items():
                if rec["launches"][kname] != n:
                    fail(f"phase {name}: {rec['launches'][kname]} {kname} "
                         f"launches, want {n}")
            out[f"{tag}_{phase}"] = rec
        eng = Engine(model, batch_size=ENGINE_BATCH,
                     max_len=ENGINE_PROMPT + ENGINE_GEN + 8,
                     kv_dtype="int8")
        prof = profile_window(
            torch, lambda: eng.generate(params, batch, n_tokens=8,
                                        timing=False), OUR_KERNELS)
        log_profile(f"{tag}-int8 engine, prefill + 7 decode steps", prof)
        out[f"profile_{tag}_engine_int8"] = prof
        out[f"{tag}_continuous"] = continuous_phase(
            torch, np, ops, f"{tag}-continuous", model, params, rng,
            CONT_LENS[1] + CONT_GEN + 8, NORM_ATTN + ("int8kv_decode",),
            card, kv_dtype="int8")
        out[f"{tag}_params"] = n_params
        out[f"{tag}_layers"] = L
        del model, params, eng
        torch.cuda.empty_cache()
    return out, logits


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


def report_fit(name, topo, wl, cal, residual, n_samples):
    """The fitted site rates, the residual and the plan search's winner
    before and after the overlay, as lines and as a record."""
    from repro_torch.core.search import PlanSearch

    before = PlanSearch(wl, topo).best()
    after = PlanSearch(wl, topo, calibration=cal).best()
    rec = {"site_tflops": {str(k): v for k, v in cal.site_tflops.items()},
           "links": [[i, j, r.alpha_s, r.gbps]
                     for (i, j), r in sorted(cal.links.items())],
           "residual": residual, "n_samples": n_samples,
           "winner_before": [before.candidate.key, before.tflops],
           "winner_after": [after.candidate.key, after.tflops]}
    log(f"{name}: fitted site TFLOP/s {rec['site_tflops']}")
    log(f"{name}: fit residual {residual} over {n_samples} samples")
    log(f"{name}: search winner {before.candidate.key} "
        f"({before.tflops:.4f} TFLOP/s analytic) -> {after.candidate.key} "
        f"({after.tflops:.4f} calibrated)")
    return rec


def calibrate_phases(torch, ops, card):
    """Phase ``calibrate``: the launcher a user runs, at its default
    micro-bench sizes (on the card, the model's widths); its JSON must be
    the reference's schema and load back through the port's
    ``Calibration.loads``.  Phase ``calibrate-wide``: the same profile
    called directly at gpt2m's widths (sizes 1024 and 4096), fitted and
    searched the same way; the two must pick the same winner."""
    import contextlib
    import io
    import re
    import tempfile

    from repro_torch.calib.fit import fit_calibration
    from repro_torch.calib.microbench import (host_ring_collective_samples,
                                              kernel_compute_samples)
    from repro_torch.calib.overlay import Calibration
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import (PAPER_CLUSTERS, as_topology,
                                            paper_workload)
    from repro_torch.launch import calibrate

    wl = paper_workload(get_config(CAL_MODEL))
    topo = as_topology(PAPER_CLUSTERS[CAL_CLUSTER])
    needs = ["int8_matmul", "flash_attn_fwd"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cal.json")
        said = io.StringIO()

        def launch():
            with contextlib.redirect_stdout(said):
                return calibrate.main(["--cluster", CAL_CLUSTER, "--model",
                                       CAL_MODEL, "--out", path])

        rc, counts = run_phase(torch, ops, "calibrate", launch, needs)
        for line in said.getvalue().splitlines():
            log(f"  calibrate: {line}")
        if rc != 0:
            fail(f"phase calibrate: the launcher returned {rc}")
        with open(path) as f:
            text = f.read()
    doc = json.loads(text)
    if sorted(doc) != ["links", "note", "site_tflops"] \
            or not all(len(r) == 4 for r in doc["links"]):
        fail(f"phase calibrate: JSON is not the Calibration schema: {doc}")
    cal = Calibration.loads(text)
    if cal.dumps() != text:
        fail("phase calibrate: the JSON does not round-trip through "
             "Calibration.loads")
    rate = cal.site_tflops.get(0)
    if not (rate is not None and 0 < rate < float("inf")):
        fail(f"phase calibrate: fitted site 0 rate {rate}")
    m = re.search(r"fit residual (\S+) over (\d+) samples", said.getvalue())
    if m is None:
        fail("phase calibrate: the launcher printed no fit residual")
    out["calibrate"] = {"json": doc, "launches": counts, "fit": report_fit(
        "calibrate", topo, wl, cal, float(m.group(1)), int(m.group(2)))}

    def wide():
        s = kernel_compute_samples(0, sizes=(1024, 4096), device="cuda")
        return s + host_ring_collective_samples((0, 0))

    samples, counts = run_phase(torch, ops, "calibrate-wide", wide, needs)
    rows = [{"flops": s.flops, "time_s": s.time_s,
             "tflops": s.flops / s.time_s / 1e12}
            for s in samples if s.kind == "compute"]
    for r, what in zip(rows, ("fp32 matmul 1024", "int8 matmul 1024",
                              "fp32 matmul 4096", "int8 matmul 4096",
                              "flash 1x128x4x64 bf16")):
        r["what"] = what
        log(f"calibrate-wide sample {what}: {r['time_s'] * 1e6:.2f} us, "
            f"{r['tflops']:.3f} TFLOP/s on {card}")
    fr = fit_calibration(topo, samples, note=f"{CAL_CLUSTER} wide fit")
    out["calibrate_wide"] = {"samples": rows, "launches": counts,
                             "fit": report_fit(
                                 "calibrate-wide", topo, wl, fr.calibration,
                                 fr.residual, fr.n_samples)}
    winners = [out[k]["fit"]["winner_after"][0]
               for k in ("calibrate", "calibrate_wide")]
    if winners[0] != winners[1]:
        fail(f"phase calibrate picked {winners[0]}, calibrate-wide "
             f"{winners[1]}: the launcher's default sizes do not measure "
             f"what the model's widths do")
    # where an int8 sample's time goes: one ops.int8_matmul (pad,
    # quantize, kernel 5) as the micro-bench calls it, traced after the
    # counted phases
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for m in (1024, 4096):
        x = torch.randn((m, m), generator=g, device="cuda")
        w = torch.randn((m, m), generator=g, device="cuda")

        def call():
            return ops.int8_matmul(x, w, block_m=64, block_k=64,
                                   block_n=64)

        call()
        prof = profile_window(torch, call, OUR_KERNELS)
        log_profile(f"calibrate-wide, one ops.int8_matmul at {m}^3, "
                    f"blocks 64", prof)
        out["calibrate_wide"][f"profile_int8_matmul_{m}"] = prof
    return out


def _cosine(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 1.0


def check_train_parity(grads, losses):
    """Loss, global gradient norm and each leaf's cosine of the kernel
    path against the fp32 plain path, held to ``NOISE_FACTOR`` times the
    bf16 plain path's distance from it (the control); the loss also
    directly against the bf16 plain path."""
    k, p, f = (losses[n] for n in ("kernel", "plain", "fp32"))
    if not all(map(lambda x: x == x and abs(x) < float("inf"), (k, p, f))):
        fail(f"train-parity: non-finite loss {losses}")
    if not abs(k - p) <= TRAIN_LOSS_RTOL * abs(p):
        fail(f"train-parity: loss {k} vs plain {p}, beyond {TRAIN_LOSS_RTOL} "
             f"relative")
    if not abs(k - f) <= NOISE_FACTOR * abs(p - f) + TRAIN_NORM_FLOOR * abs(f):
        fail(f"train-parity: loss {k} is {abs(k - f)} from fp32 {f}; the "
             f"bf16 plain path is {abs(p - f)} from it")
    norms = {n: float(sum(g.double().square().sum()
                          for g in grads[n].values()) ** 0.5)
             for n in grads}
    nk, np_, nf = norms["kernel"], norms["plain"], norms["fp32"]
    if not abs(nk - nf) <= NOISE_FACTOR * abs(np_ - nf) \
            + TRAIN_NORM_FLOOR * nf:
        fail(f"train-parity: grad norm {nk} is {abs(nk - nf)} from fp32 "
             f"{nf}; the bf16 plain path is {abs(np_ - nf)} from it")
    leaves, worst = {}, 0.0
    for key, gf in grads["fp32"].items():
        ck = _cosine(grads["kernel"][key], gf)
        cp = _cosine(grads["plain"][key], gf)
        ckp = _cosine(grads["kernel"][key], grads["plain"][key])
        leaves[key] = {"cos_kernel_fp32": ck, "cos_plain_fp32": cp,
                       "cos_kernel_plain": ckp,
                       "norm_fp32": float(gf.double().norm())}
        allowed = NOISE_FACTOR * (1 - cp) + TRAIN_COS_FLOOR
        worst = max(worst, (1 - ck) / allowed)
        if not 1 - ck <= allowed:
            fail(f"train-parity {key}: 1 - cos(kernel, fp32) = {1 - ck} > "
                 f"{NOISE_FACTOR} x (1 - cos(plain, fp32) = {1 - cp}) + "
                 f"{TRAIN_COS_FLOOR}")
    log(f"train-parity: loss kernel {k:.6f} plain {p:.6f} fp32 {f:.6f}; "
        f"grad norm kernel {nk:.6f} plain {np_:.6f} fp32 {nf:.6f}")
    for key, r in leaves.items():
        log(f"  {key}: cos(kernel, fp32) {r['cos_kernel_fp32']:.6f} "
            f"cos(plain, fp32) {r['cos_plain_fp32']:.6f} cos(kernel, plain) "
            f"{r['cos_kernel_plain']:.6f}")
    log(f"train-parity: worst leaf uses {worst:.3f} of its allowance")
    return {"losses": losses, "grad_norms": norms, "leaves": leaves,
            "worst_leaf_share_of_allowance": worst}


def train_phases(torch, np, ops, card):
    """Phases ``train-gpt2m``, ``train-parity`` and ``train-resume``:
    gpt2m pretraining at full width and depth on one card."""
    import dataclasses
    import tempfile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import flatten
    from repro_torch.core.steps import build_train_step, value_and_grad
    from repro_torch.data import (Loader, Tokenizer, build_dataset,
                                  synthetic_wikipedia)
    from repro_torch.models import Model
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import (model_flops_per_step, restore_checkpoint,
                                   train)

    cfg = get_config("gpt2m")
    S, L = cfg.max_seq_len, cfg.n_layers
    t0 = time.perf_counter()
    texts = list(synthetic_wikipedia(TRAIN_DOCS, seed=SEED))
    tok = Tokenizer.train(texts, cfg.vocab_size)
    ds = build_dataset(texts, tok, seq_len=S)
    if not tok.vocab_size <= cfg.vocab_size:
        fail(f"tokenizer ids reach {tok.vocab_size} > {cfg.vocab_size}")
    if len(ds) < TRAIN_BATCH * TRAIN_STEPS:
        fail(f"{len(ds)} windows of {S + 1} tokens < "
             f"{TRAIN_BATCH * TRAIN_STEPS}")
    loader = Loader(ds, global_batch=TRAIN_BATCH, seed=SEED)
    log(f"train data: {TRAIN_DOCS} documents, tokenizer of "
        f"{tok.vocab_size} ids (model vocab {cfg.vocab_size}), "
        f"{len(ds)} windows of {S + 1}, in {time.perf_counter() - t0:.1f}s")
    model = Model(cfg, device="cuda")
    tcfg = TrainConfig()
    needs = ["flash_attn_fwd", "flash_attn_bwd"]
    per_step = {"flash_attn_fwd": 2 * L, "flash_attn_bwd": L}

    def expect(name, counts, steps):
        for kname, n in per_step.items():
            if counts[kname] != n * steps:
                fail(f"phase {name}: {counts[kname]} {kname} launches, want "
                     f"{n} a step (remat runs each layer's forward twice)")

    out = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.cuda.reset_peak_memory_stats()
        res, counts = run_phase(
            torch, ops, "train-gpt2m",
            lambda: train(model, tcfg, loader, steps=TRAIN_STEPS,
                          log_every=1, ckpt_dir=ckpt_dir,
                          ckpt_every=TRAIN_CKPT_AT,
                          log_fn=lambda m: log(f"  train-gpt2m: {m}")),
            needs)
        peak = torch.cuda.max_memory_allocated()
        expect("train-gpt2m", counts, TRAIN_STEPS)
        if not all(np.isfinite(res.losses)):
            fail(f"train-gpt2m: non-finite losses {res.losses}")
        tokens = TRAIN_BATCH * S
        flops = model_flops_per_step(cfg, tokens)
        step_s = res.avg_step_time
        rate = flops / step_s / 1e12
        out["train_gpt2m"] = {
            "batch": TRAIN_BATCH, "seq": S, "steps": TRAIN_STEPS,
            "params": cfg.param_count(), "losses": res.losses,
            "step_s": res.step_times, "avg_step_s_steps_2_to_6": step_s,
            "tokens_per_s": tokens / step_s, "model_tflops": rate,
            "share_of_bf16_peak": rate * 1e12 / PEAK_BF16_FLOPS,
            "peak_bytes": peak, "launches": counts,
            "metrics_last": res.metrics_last}
        log(f"train-gpt2m: losses {[round(x, 4) for x in res.losses]}")
        log(f"train-gpt2m: step {step_s * 1e3:.1f} ms (steps 2 to "
            f"{TRAIN_STEPS}), {tokens / step_s:.0f} tokens/s, 6ND "
            f"{rate:.2f} TFLOP/s = {rate * 1e12 / PEAK_BF16_FLOPS:.4f} of "
            f"989, peak memory {peak / 2**30:.2f} GiB, on {card}")

        # where a step's time goes: one more step from the final state,
        # traced after the counted phase
        step_fn = build_train_step(model, tcfg)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in loader.batch_at(TRAIN_STEPS).items()}
        prof = profile_window(
            torch, lambda: step_fn(res.params, res.opt_state, batch),
            OUR_KERNELS)
        log_profile("train-gpt2m, one step", prof)
        out["profile_train_gpt2m"] = prof
        if prof is not None:
            shares = {part: sum(r["us"] for r in prof["ours"]
                                if any(n in r["name"] for n in names))
                      / prof["device_busy_us"]
                      for part, names in (("flash_attn_fwd",
                                           ("flash_fwd_kernel",)),
                                          ("flash_attn_bwd",
                                           ("bwd_delta_kernel",
                                            "bwd_dkdv_kernel",
                                            "bwd_dq_kernel")))}
            out["train_gpt2m"]["kernel_a_share_of_device_time"] = shares
            log(f"train-gpt2m: kernel A's share of the traced step's "
                f"device time: forward {shares['flash_attn_fwd']:.4f}, "
                f"backward {shares['flash_attn_bwd']:.4f}")

        # train-resume: restore step 4, rerun steps 4 and 5
        like = tree_map(torch.empty_like, res.params)
        opt_like = init_adamw(like)
        path = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}")
        p_end, o_end, _ = restore_checkpoint(path, like, opt_like)
        for a, b in zip(tree_leaves(p_end) + tree_leaves(o_end.m)
                        + tree_leaves(o_end.v),
                        tree_leaves(res.params) + tree_leaves(res.opt_state.m)
                        + tree_leaves(res.opt_state.v)):
            if not torch.equal(a, b):
                fail("train-resume: the restored final checkpoint is not "
                     "bit-equal to the trained state")
        del p_end, o_end
        path = os.path.join(ckpt_dir, f"step_{TRAIN_CKPT_AT:08d}")
        p4, o4, step = restore_checkpoint(path, like, opt_like)
        if step != TRAIN_CKPT_AT or int(o4.step) != TRAIN_CKPT_AT:
            fail(f"train-resume: restored step {step} / {int(o4.step)}")
    again, counts = run_phase(
        torch, ops, "train-resume",
        lambda: train(model, tcfg, loader, steps=TRAIN_STEPS, params=p4,
                      opt_state=o4, start_step=TRAIN_CKPT_AT, log_every=0),
        needs)
    expect("train-resume", counts, TRAIN_STEPS - TRAIN_CKPT_AT)
    first = res.losses[TRAIN_CKPT_AT:]
    rel = [abs(a - b) / abs(b) for a, b in zip(again.losses, first)]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(again.params),
                                                 tree_leaves(res.params)))
    log(f"train-resume: steps {TRAIN_CKPT_AT}..{TRAIN_STEPS - 1} losses "
        f"{again.losses} vs {first}, relative differences {rel}; final "
        f"params bit-equal: {same}")
    if not max(rel) <= RESUME_RTOL:
        fail(f"train-resume: losses {again.losses} vs {first} differ by "
             f"{max(rel)} > {RESUME_RTOL} relative")
    out["train_resume"] = {"losses": again.losses, "original": first,
                           "relative_diff": rel, "params_bit_equal": same,
                           "launches": counts}
    del res, again, p4, o4, like, opt_like, step_fn
    torch.cuda.empty_cache()

    # train-parity: one step's loss and gradients, fresh params, batch 0
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in loader.batch_at(0).items()}
    paths = {"kernel": model,
             "plain": Model(cfg, device="cuda", use_kernels=False),
             "fp32": Model(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda", use_kernels=False)}
    grads, losses = {}, {}
    for name, m in paths.items():
        def vg(m=m):
            return value_and_grad(lambda p, b: m.loss(p, b), params, batch)
        if name == "kernel":
            (loss, _, g), counts = run_phase(torch, ops, "train-parity", vg,
                                             needs)
            expect("train-parity", counts, 1)
            out["train_parity_launches"] = counts
        else:
            loss, _, g = vg()
        losses[name], grads[name] = float(loss), flatten(g)
        del g
    out["train_parity"] = check_train_parity(grads, losses)
    del grads, params, model, paths
    torch.cuda.empty_cache()
    return out


def plan_phases(torch, np, ops, card):
    """Phases ``train-gpt2L`` and ``plan-<name>`` for each flat plan:
    gpt2L trains ``PLAN_STEPS`` steps through ``train()`` on one device
    and under each plan on a mesh of one rank over NCCL, then the pipe
    phases (``pipe_phases``) and the family phases (``family_phases``)
    in the same process group.  One more step of the one device, of
    shard_zero (the plan with the most layout work) and of fsdp is traced
    after its counted phase."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.data import Loader, PackedDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import model_flops_per_step, train

    cfg = get_config(PLAN_ARCH)
    S, L = cfg.max_seq_len, cfg.n_layers
    rng = np.random.default_rng(SEED + 2)
    ds = PackedDataset(rng.integers(0, cfg.vocab_size, (PLAN_DOCS, S + 1))
                       .astype(np.int32), S)
    loader = Loader(ds, global_batch=TRAIN_BATCH, seed=SEED)
    tcfg = TrainConfig()
    needs = ["flash_attn_fwd", "flash_attn_bwd"]
    per_step = {"flash_attn_fwd": 2 * L, "flash_attn_bwd": L}
    tokens = TRAIN_BATCH * S
    flops = model_flops_per_step(cfg, tokens)
    out = {}

    def run(name, plan=None, mesh=None, trace=False, tc=tcfg, micro=1,
            **kw):
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        sharding.reset_collective_counts()
        res, counts = run_phase(
            torch, ops, name,
            lambda: train(model, tc, loader, steps=PLAN_STEPS,
                          params=params, log_every=0, plan=plan, mesh=mesh,
                          **kw),
            needs)
        coll = {k: {"calls": v["calls"] / PLAN_STEPS,
                    "bytes": v["bytes"] / PLAN_STEPS}
                for k, v in sharding.collective_counts().items()}
        for kname, n in per_step.items():
            if counts[kname] != n * micro * PLAN_STEPS:
                fail(f"phase {name}: {counts[kname]} {kname} launches, want "
                     f"{n * micro} a step (remat runs each layer's forward "
                     f"twice)")
        if not all(np.isfinite(res.losses)):
            fail(f"phase {name}: non-finite losses {res.losses}")
        step_s = res.avg_step_time
        rate = flops / step_s / 1e12
        rec = {"losses": res.losses, "step_s": res.step_times,
               "avg_step_s_steps_2_to_3": step_s,
               "tokens_per_s": tokens / step_s, "model_tflops": rate,
               "peak_bytes": PHASES[name]["peak_bytes"], "launches": counts,
               "collectives_a_step": coll}
        log(f"{name}: losses {res.losses}; step {step_s * 1e3:.1f} ms "
            f"(steps 2 to {PLAN_STEPS}), {tokens / step_s:.0f} tokens/s, "
            f"6ND {rate:.2f} TFLOP/s, peak memory "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB, on {card}")
        log(f"{name}: collectives a step: " + ", ".join(
            f"{k} {v['calls']:g} calls {v['bytes'] / 1e6:.3f} MB"
            for k, v in coll.items()))
        if trace:
            step_fn = build_train_step(model, tc, plan=plan, mesh=mesh, **kw)
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in loader.batch_at(PLAN_STEPS).items()}
            rec["profile"] = profile_window(
                torch, lambda: step_fn(res.params, res.opt_state, batch),
                OUR_KERNELS)
            log_profile(f"{name}, one step", rec["profile"])
        return res, rec

    ref, out["train_gpt2L"] = run("train-gpt2L", trace=True)
    # on the host, so that the plan phases' peaks are their own
    ref_params = [t.cpu() for t in tree_leaves(ref.params)]
    del ref
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh((1, 1, 1), ("pod", "data", "model"))
        for name in PLAN_NAMES:
            res, rec = run(f"plan-{name}", name, mesh,
                           trace=name in ("shard_zero", "fsdp"))
            want = out["train_gpt2L"]["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, want)]
            rec["loss_rel_diff"] = rel
            if not max(rel) <= PLAN_LOSS_RTOL:
                fail(f"plan-{name}: losses {res.losses} vs one device {want}"
                     f", {max(rel)} > {PLAN_LOSS_RTOL} relative")
            rec["bit_equal"] = res.losses == want and all(
                torch.equal(a.cpu(), b) for a, b in
                zip(tree_leaves(res.params), ref_params))
            if name in PLAN_BIT_EQUAL and not rec["bit_equal"]:
                fail(f"plan-{name}: not bit-equal to one device at a world "
                     f"of one")
            log(f"plan-{name}: loss relative differences to one device "
                f"{rel}; losses and params bit-equal: {rec['bit_equal']}")
            out[f"plan_{name}"] = rec
            del res
            torch.cuda.empty_cache()
        out.update(pipe_phases(torch, run, loader,
                               out["train_gpt2L"]["losses"]))
        out.update(family_phases(torch, np, ops, card))
    finally:
        dist.destroy_process_group()
    del ref_params
    torch.cuda.empty_cache()
    return out


def pipe_phases(torch, run, loader, want):
    """Phases ``pipe-<schedule>`` (``PIPE_PHASES``): gpt2L under
    pipeshard on a (1, 1, 1) staged mesh, through ``run`` of
    ``plan_phases``; one more step of 1F1B is traced.  After each phase
    one more forward and backward of the batch (``PipelineStep.grads``)
    gives the schedule's own peak: the most memory it allocates above
    what the params and the optimizer state hold (the phase's peak is
    AdamW's, the same under every schedule)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves

    tc = TrainConfig(microbatches=PIPE_MICRO)
    out, first = {}, None
    for sched, split in PIPE_PHASES:
        name = f"pipe-{sched}"
        mesh = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1,
                                  stage_layers=split, schedule=sched)
        res, rec = run(name, "pipeshard", mesh, trace=sched == "1f1b",
                       tc=tc, micro=PIPE_MICRO, stage_layers=split,
                       schedule=sched)
        rel = [abs(a - b) / abs(b) for a, b in zip(res.losses, want)]
        rec["loss_rel_diff"] = rel
        if not (rel[0] <= PIPE_LOSS1_RTOL and max(rel) <= PIPE_LOSS_RTOL):
            fail(f"{name}: losses {res.losses} vs one device {want}: "
                 f"{rel} relative, beyond {PIPE_LOSS1_RTOL} at step 1 or "
                 f"{PIPE_LOSS_RTOL}")
        params = [t.cpu() for t in tree_leaves(res.params)]
        if first is None:
            first = (name, res.losses, params)
        elif res.losses != first[1] or not all(
                torch.equal(a, b) for a, b in zip(params, first[2])):
            fail(f"{name}: losses {res.losses} or params not bit-equal to "
                 f"{first[0]}'s ({first[1]})")
        rec["split"] = split
        step = build_train_step(Model(get_config(PLAN_ARCH), device="cuda"),
                                tc, plan="pipeshard", mesh=mesh,
                                stage_layers=split, schedule=sched)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in loader.batch_at(0).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step.grads(res.params, batch)
        torch.cuda.synchronize()
        rec["schedule_peak_bytes"] = torch.cuda.max_memory_allocated() - held
        log(f"{name}: loss relative differences to one device {rel}; "
            f"bit-equal to {first[0]}; the schedule's peak "
            f"{rec['schedule_peak_bytes'] / 2**30:.3f} GiB above the "
            f"params and optimizer state")
        out[name.replace("-", "_")] = rec
        del res, params, step
        torch.cuda.empty_cache()
    key = "schedule_peak_bytes"
    if not out["pipe_1f1b"][key] < out["pipe_gpipe"][key]:
        fail(f"pipe-1f1b's schedule peak {out['pipe_1f1b'][key]} is not "
             f"below pipe-gpipe's {out['pipe_gpipe'][key]}")
    return out


def collectives_a_step(torch, steps):
    """The collective counts since the last reset, a step."""
    from repro_torch.core import sharding
    return {k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps}
            for k, v in sharding.collective_counts().items()}


def family_phases(torch, np, ops, card):
    """Phases ``fam-<tag>-shard`` and ``fam-<tag>-pipe`` (``FAM_MODELS``)
    in the process group of ``plan_phases``, each after its yardstick,
    the one-device port on the same steps (``fam-<tag>-one``; with
    ``grad_accum``, ``fam-<tag>-accum``).  Each family's model is built
    once; every phase initializes its params from the seed."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import sharding
    from repro_torch.data import Loader, PackedDataset
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import model_flops_per_step, train

    axes = ("pod", "data", "model")
    flat = make_host_mesh((1, 1, 1), axes)
    staged = make_pipeline_mesh((1, 1, 1), axes, 1, schedule="1f1b")
    tokens = FAM_BATCH * FAM_SEQ
    out = {}
    for tag, arch, layers in FAM_MODELS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers,
                                  max_seq_len=max(full.max_seq_len, FAM_SEQ))
        if trains_through_kernels(cfg):
            fail(f"{arch}: expected a family without backward kernels")
        log(f"fam-{tag}: {arch} at full width, reduced: {layers} of "
            f"{full.n_layers} layers, {cfg.param_count() / 1e9:.3f} B "
            f"params; batch {FAM_BATCH} x {FAM_SEQ} random tokens, "
            f"{FAM_STEPS} steps; the kernels' plain versions")
        model = Model(cfg, device="cuda", use_kernels=False)
        rng = np.random.default_rng(SEED + 3)
        ds = PackedDataset(rng.integers(
            0, cfg.vocab_size, (FAM_STEPS * FAM_BATCH, FAM_SEQ + 1))
            .astype(np.int32), FAM_SEQ)
        loader = Loader(ds, global_batch=FAM_BATCH, seed=SEED)
        flops = model_flops_per_step(cfg, tokens)

        def run(name, tcfg, keep=False, **kw):
            """One phase of FAM_STEPS steps; with ``keep``, also the final
            params on the host."""
            sharding.reset_collective_counts()
            res, counts = run_phase(
                torch, ops, name,
                lambda: train(model, tcfg, loader, steps=FAM_STEPS,
                              log_every=0, donate=True, **kw), [])
            if not all(np.isfinite(res.losses)):
                fail(f"{name}: non-finite losses {res.losses}")
            step_s = res.avg_step_time
            rec = {"losses": res.losses, "step_s": res.step_times,
                   "avg_step_s_steps_2_to_3": step_s,
                   "tokens_per_s": tokens / step_s,
                   "model_tflops": flops / step_s / 1e12,
                   "peak_bytes": PHASES[name]["peak_bytes"],
                   "launches": counts,
                   "collectives_a_step": collectives_a_step(torch,
                                                            FAM_STEPS)}
            params = [t.cpu() for t in tree_leaves(res.params)] if keep \
                else None
            log(f"{name}: losses {res.losses}; step {step_s * 1e3:.1f} ms "
                f"(steps 2 to {FAM_STEPS}), {tokens / step_s:.0f} tokens/s, "
                f"6ND {rec['model_tflops']:.2f} TFLOP/s, peak memory "
                f"{rec['peak_bytes'] / 2**30:.2f} GiB, on {card}")
            log(f"{name}: collectives a step: " + ", ".join(
                f"{k} {v['calls']:g} calls {v['bytes'] / 1e6:.3f} MB"
                for k, v in rec["collectives_a_step"].items()))
            del res
            torch.cuda.empty_cache()
            return rec, params

        one, one_params = run(f"fam-{tag}-one", TrainConfig(), keep=True)
        rec, params = run(f"fam-{tag}-shard", TrainConfig(), keep=True,
                          plan="shard", mesh=flat)
        rec["bit_equal"] = rec["losses"] == one["losses"] and all(
            torch.equal(a, b) for a, b in zip(params, one_params))
        log(f"fam-{tag}-shard: held bit-equal to fam-{tag}-one "
            f"({one['losses']}): {rec['bit_equal']}")
        if not rec["bit_equal"]:
            fail(f"fam-{tag}-shard: not bit-equal to one device at a world "
                 f"of one")
        out[f"fam_{tag}_one"], out[f"fam_{tag}_shard"] = one, rec
        del params, one_params
        tc = TrainConfig(microbatches=FAM_MICRO)
        accum, _ = run(f"fam-{tag}-accum", TrainConfig(grad_accum=FAM_MICRO))
        rec, _ = run(f"fam-{tag}-pipe", tc, plan="pipeshard", mesh=staged,
                     schedule="1f1b")
        rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                  accum["losses"])]
        rec["loss_rel_diff"] = rel
        log(f"fam-{tag}-pipe: held to fam-{tag}-accum ({accum['losses']}) "
            f"within {FAM_LOSS1_RTOL} at step 1 and {FAM_LOSS_RTOL} after: "
            f"relative differences {rel}, {rel[0] / FAM_LOSS1_RTOL:.3f} and "
            f"{max(rel[1:]) / FAM_LOSS_RTOL:.3f} of the tolerances")
        if not (rel[0] <= FAM_LOSS1_RTOL and max(rel) <= FAM_LOSS_RTOL):
            fail(f"fam-{tag}-pipe: losses {rec['losses']} vs "
                 f"{accum['losses']}: {rel} relative")
        out[f"fam_{tag}_accum"], out[f"fam_{tag}_pipe"] = accum, rec
        del model
        torch.cuda.empty_cache()
    return out


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
    for kern, r in sorted(prof["per_kernel"].items()):
        log(f"  kernel {kern}: {r['us'] / 1e3:.3f} ms of device time in "
            f"{r['count']} launches, share {r['share']:.4f}")


# keys a kernel row may add: kernel A's rates and ratios (add_rates),
# kernel 5's row-major library time; and the training shape
EXTRAS = ("tflops", "x_library", "x_bound", "library_row_major_ms")
TRAIN_AT = {"B": 8, "S": 1024, "H": 16, "D": 64}
# the port's CUDA functions in a trace, by the kernel they belong to (a
# call of kernel B launches int8kv_combine_kernel after the split kernel
# when Sk is cut into more than one split)
OUR_KERNELS = {"flash_fwd_kernel": "flash_attn_fwd",
               "bwd_delta_kernel": "flash_attn_bwd",
               "bwd_dkdv_kernel": "flash_attn_bwd",
               "bwd_dq_kernel": "flash_attn_bwd",
               "int8kv_decode_kernel": "int8kv_decode",
               "int8kv_combine_kernel": "int8kv_decode",
               "mamba1_scan_kernel": "mamba1_scan",
               "ssd_scan_kernel": "ssd_scan",
               "ssd_scores_kernel": "ssd_scan",
               "int8_matmul_kernel": "int8_matmul",
               "rmsnorm_kernel": "rmsnorm"}


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
    stages = {}

    def stage(name):
        """Seconds since the start at the end of a stage of the run."""
        stages[name] = time.perf_counter() - t_start
        log(f"[{stages[name]:.1f}s] {name} done")

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {build_s:.1f}s; each nvcc: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in sorted(_build.BUILD_SECONDS.items(),
                                            key=lambda kv: -kv[1])))
    for stem, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")
    mm_log = _build.BUILD_LOG.get("int8_matmul")
    if not mm_log:
        fail("no ptxas log for kernel 5: cannot check its wgmma")
    if "serialized" in mm_log:
        fail("ptxas serialized kernel 5's wgmma: " + mm_log)

    cfg = get_config("gpt2m")
    fcfg, zcfg = get_config("falcon-mamba-7b"), get_config("zamba2-2.7b")
    lcfg, mcfg = get_config(LLAMA), get_config(MOE)
    # (B, S): Engine prefill (8 x 64), ContinuousEngine buckets (1 x
    # 16..256), and a ragged and a full-context shape; zamba2's shared
    # attention (head_dim 80) at its Engine prefill and a long prompt
    flash_rows, flash_err = [], 0.0
    for heads, shapes in (
            ((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
             ((8, 64), (1, 16), (1, 256), (4, 128), (1, 257), (1, 1024),
              (8, 1024))),
            ((zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim),
             ((8, 64), (1, 256))),
            (CAL_FLASH_HEADS, (CAL_FLASH_BS,)),
            # head_dim 128: llama3.2 (group 3) and phi3.5-MoE (group 4) at
            # their Engine prefill and a ragged continuous prefill; llama3.2
            # also at gpt2m's training batch and length
            ((lcfg.n_heads, lcfg.n_kv_heads, lcfg.head_dim),
             ((8, 64), (1, 257), (8, 1024))),
            ((mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim),
             ((8, 64), (1, 257)))):
        rows, err = check_flash(torch, F, *heads, shapes)
        flash_rows, flash_err = flash_rows + rows, max(flash_err, err)
    bwd_rows, bwd_err = check_flash_bwd(torch, F)
    # (B, Sk, fills): the engines' decode caches, rows partly filled
    # (Engine: 104 slots, ContinuousEngine: 296 at head_dim 128), 1024
    # slots, and "mixed" masks (a row with no live key, random non-prefix
    # rows); at head_dim 128 the llama3.2 and phi3.5-MoE heads
    int8_rows, int8_err = check_int8kv(
        torch, F, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        ((8, 104, (65, 96)), (8, 1024, (17, 290)), (8, 1024, (1, 1024)),
         (8, 1024, "mixed")),
        SEED + 1)
    for c in (lcfg, mcfg):
        rows, err = check_int8kv(torch, F, c.n_heads, c.n_kv_heads,
                                 c.head_dim,
                                 ((8, 1024, (17, 290)), (8, 104, (65, 96)),
                                  (8, 296, (17, 288)), (8, 296, "mixed")),
                                 SEED + 9)
        int8_rows, int8_err = int8_rows + rows, max(int8_err, err)
    floor_ms = launch_floor_ms(torch)
    log(f"minimal launch (torch.cuda._sleep({FLOOR_CYCLES})): "
        f"{floor_ms:.4f} ms")
    rms_rows, rms_err = check_rmsnorm(torch, F, floor_ms)
    sm_hz = sm_clock_hz()
    sfu = SFU_PER_SM_CLK * sm_hz * \
        torch.cuda.get_device_properties(0).multi_processor_count
    log(f"highest SM clock (clocks.max.sm): {sm_hz / 1e6:.0f} MHz; "
        f"exps {sfu / 1e12:.3f} T/s")
    m1_rows, m1_err = check_mamba1(torch, fcfg, sfu)
    ssd_rows, ssd_err = check_ssd(torch, zcfg, sfu)
    mm_rows, mm_err = check_int8_matmul(torch, sm_hz)
    stage("kernel checks")

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
    stage("gpt2m serving")

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

    stage("falcon-mamba and zamba2 serving")
    slice5, logits5 = slice5_phases(torch, np, ops, card)
    stage("llama3.2 and phi3.5-MoE serving")
    logit_err.update(logits5)
    at128 = {"flash_attn_fwd": 0, "int8kv_decode": 0}
    for key, rec in slice5.items():
        if isinstance(rec, dict) and "launches" in rec:
            add(rec["launches"])
            for k in at128:
                at128[k] += rec["launches"][k]
    e2e.update(slice5)

    calib = calibrate_phases(torch, ops, card)
    for key in ("calibrate", "calibrate_wide"):
        add(calib[key]["launches"])
    e2e.update(calib)
    stage("calibration")
    training = train_phases(torch, np, ops, card)
    stage("training")
    for key in ("train_gpt2m", "train_resume"):
        add(training[key]["launches"])
    add(training["train_parity_launches"])
    e2e.update(training)
    plans = plan_phases(torch, np, ops, card)
    stage("gpt2L under the plans and the pipeline")
    for rec in plans.values():
        add(rec["launches"])
    e2e.update(plans)
    log(f"all phases in {time.perf_counter() - t_start:.1f}s")

    def pick(rows, at):
        return next(r for r in rows if all(r[k] == v for k, v in at.items()))

    def summary(rows, at):
        """A kernel's numbers at one shape (with kernel A's rates)."""
        row = pick(rows, at)
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") + EXTRAS
        return {k: row[k] for k in keys if k in row} | {"at": at}

    def at_head_dim(rows, at, launches):
        """The row of a kernel at head_dim 128 and its launches in the
        slice-5 phases (the only ones at that head dim)."""
        return {"128": summary(rows, at) | {"launches": launches}}

    def entry(name, route_src, replaces, rows, worst, at, **extra):
        row = pick(rows, at)
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": totals[name],
                "max_abs_err": worst, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "at": at,
                **{k: row[k] for k in EXTRAS if k in row}, **extra}

    kernels = [
        entry("flash_attn_fwd", "src/repro_torch/csrc/flash_attn_fwd.cu",
              "src/repro/kernels/flash_attention.py:77", flash_rows,
              flash_err, {"B": 1, "S": 256, "H": 16, "D": 64},
              train_shape=summary(flash_rows, TRAIN_AT),
              by_head_dim=at_head_dim(
                  flash_rows, {"B": 8, "S": 64, "H": 24, "D": 128},
                  at128["flash_attn_fwd"])),
        entry("flash_attn_bwd", "src/repro_torch/csrc/flash_attn_bwd.cu",
              "src/repro/kernels/flash_attention.py:77", bwd_rows, bwd_err,
              TRAIN_AT, differentiates="src/repro/models/attention.py:36"),
        entry("int8kv_decode", "src/repro_torch/csrc/int8kv_attn.cu",
              "src/repro/kernels/quantized.py:145", int8_rows, int8_err,
              {"B": 8, "Sk": 1024, "D": 64,
               "live_keys": int8_rows[1]["live_keys"]},
              by_head_dim=at_head_dim(
                  int8_rows, {"B": 8, "Sk": 1024, "H": 24, "D": 128},
                  at128["int8kv_decode"]),
              launch_floor_ms=floor_ms),
        entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/mamba_scan.py:72", ssd_rows, ssd_err,
              {"B": 8, "S": 64},
              batch1=summary(ssd_rows, {"B": 1, "S": 256})),
        entry("mamba1_scan", "src/repro_torch/csrc/mamba1_scan.cu",
              "src/repro/kernels/mamba_scan.py:144", m1_rows, m1_err,
              {"B": 8, "S": 64},
              batch1=summary(m1_rows, {"B": 1, "S": 256})),
        entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
              "src/repro/kernels/quantized.py:69", mm_rows, mm_err,
              {"M": 4096, "K": 4096, "N": 4096, "block": 64},
              at_1024=summary(mm_rows, {"M": 1024, "K": 1024, "N": 1024,
                                        "block": 64})),
        entry("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm.py:27", rms_rows, rms_err,
              {"rows": 512, "d": 3072, "dtype": "bfloat16"},
              decode=summary(rms_rows, {"rows": 8, "d": 3072,
                                        "dtype": "bfloat16"}),
              launch_floor_ms=floor_ms),
    ]
    details = os.environ.get("SMOKE_DETAILS")
    if details:
        os.makedirs(os.path.dirname(os.path.abspath(details)), exist_ok=True)
        with open(details, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "build_s": build_s,
                       "flash_attn_fwd": flash_rows,
                       "flash_attn_bwd": bwd_rows,
                       "int8kv_decode": int8_rows, "ssd_scan": ssd_rows,
                       "mamba1_scan": m1_rows, "int8_matmul": mm_rows,
                       "rmsnorm": rms_rows, "launch_floor_ms": floor_ms,
                       "phases": PHASES,
                       "stages_s": stages,
                       "build_s_each": _build.BUILD_SECONDS,
                       "logits_kernel_vs_plain": logit_err, "e2e": e2e,
                       "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
