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

Then the Multi-head Latent Attention models and phi4-mini, one at a
time: minicpm3-4b (62 layers, d_model 2560, 40 heads, q/k of 96 over v
of 64) at full size through both engines (``mla-engine``,
``mla-continuous``, bf16 cache); deepseek-v2-236b (d_model 5120, 128
heads at (192, 128), top-6 of 160 experts and 2 shared) at full width,
cut to 2 of its 60 layers (``dsv2-engine``; the top-6 combine run twice
for the same bits); phi4-mini-3.8b at full size with the int8 cache
(``phi4mini-engine``): kernels A at its split head dims and at 128, B
and 6 (also at the latents' widths); and minicpm3 at full width, 8
layers, three training steps through the plain versions
(``train-mla``).  Kernel A is held at (96, 64) and (192, 128) beside
SDPA, naming the backend SDPA picked.

Then the encoder-decoder: whisper-small at full size (12 encoder and 12
decoder layers, d_model 768, 12 heads of 64, 1500 frames, random frames
[8, 1500, 768] x 0.02 from the seed) through ``Engine`` (batch 8, prompt
64, 32 new tokens, ``whisper-engine``: kernel A 36 times a prefill, the
encoder's and the cross-attention's non-causal), and three training
steps of 8 x 448 tokens over 8 x 1500 frames through kernel A and its
backward (``train-whisper``), one step's loss and gradients held to the
plain path with an fp32 control (``whisper-parity``).  Kernel A and its
backward are held non-causal at the model's shapes (Sq of 1, 64, 448 and
1500 over 1500 keys) beside SDPA, naming its backend.

Kernel A is held at (96, 96) and kernel B at head_dim 96, phi-3-vision's
heads, at its Engine's shapes (8 x (576 + 64) positions; a cache of 680
slots filled 640 to 671) and beside SDPA.  After the elastic phases,
in their process group, the vision-language model: phi-3-vision-4.2b at
full size (32 layers, d_model 3072, 32 heads of 96, random patches [8,
576, 1024] x 0.02 from the seed) through ``Engine`` with the bf16 and
the int8 cache (``vlm-engine``, ``vlm-int8``: kernel A 32 times a
prefill, 6 65 times a forward pass, B 32 times a decode step), then
under pipeshard on one stage (``serve-vlm-pipeshard``, tokens equal to
``vlm-int8``'s); and at full width cut to 8 layers, three training
steps of 8 x (576 patches + 448 text tokens) through the plain versions
(``train-vlm``, the step-1 loss held to an fp32 control) and the same
under pipeshard, four microbatches (``fam-vlm-pipe``, held to
``train-vlm``).  ``serve-shard``, ``serve-shard_zero``,
``serve-shard-int8`` and ``serve-llama-shard`` serve once, to pay for
it.

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
Then it serves under the flat plans in the same process group: gpt2L at
full size through ``Engine`` (batch 8, prompt 64, 32 new tokens) under
data, zero2, shard, shard_zero and fsdp with the fp32 cache, under
shard with the int8 cache (kernel B with its log-sum-exp, the merge of
the ring's blocks) and through ``ContinuousEngine`` (int8, 8 slots, 16
requests), and llama3.2-3b at full size with the int8 cache under shard
(``serve-*``): each phase's tokens held to the one-device engine's on
the same weights and prompts, one run timed (``SERVE_ONE_RUN``: every
flat phase).  Then, once each after
its one-device yardstick: gpt2L under pipeshard on one stage of two
chunks (16 and 14 layers) through ``Engine`` (fp32 KV) and
``ContinuousEngine`` (int8; ``serve-pipeshard``,
``serve-pipeshard-continuous``), and phi3.5-MoE (7 of 32 layers, int8
KV), falcon-mamba-7b and zamba2-2.7b (chunks of 5 and 4 of its 9
groups) at full width under shard and under pipeshard
(``serve-moe-shard``, ..., ``serve-hybrid-pipeshard``): kernels A, B,
3, 4 and 6 as the families use them.  Then elasticity, gpt2m at full
width cut to 12 of its 24 layers (batch 8 of 1024 tokens,
``TrainConfig`` defaults), in the same process group: two steps under
pipeshard on one stage (interleaved, chunks of 7 and 5 layers, four
microbatches), a checkpoint, and
``reshard_checkpoint`` onto fsdp (``elastic-reshard-pipe``); the same
from zero2 onto that pipeshard layout (``elastic-reshard-flat``); and
the recovery mode of ``launch/replan.py`` on a two-site topology with
site V2 dead, from the first phase's checkpoint, onto the survivor
search's winner (``elastic-recover``).  The resharded params and AdamW
moments must be bit-equal to the host-side reference re-placement and
every loss after a reshard bit-equal to a control that restored the same
checkpoint without the reshard code; kernel A launches 24 forward and 12
backward a microbatch of a step; each phase prints its checkpoint
writes and restores (seconds, GB), its step times before and after, and
its peak memory.

Then the dry run against the card (``dryrun-vs-card``, no second
training step): ``repro_torch.launch.dryrun`` traces one gpt2m training
step at train-gpt2m's shape on the meta device (the kernels' shape
rules, no launch) and one gpt2L step under shard on plan-shard's mesh of
one rank over a fake world of one; the predicted peak must lie within
10% of the peak the card measured for train-gpt2m's last step, that
step's measured time at or above the roofline's max(compute, memory)
(the H100 data sheet's constants), and the dry run's collectives equal,
call for call and byte for byte, to one step of plan-shard's.

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
import shutil
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
# the elastic phases: gpt2m at full width cut to ELASTIC_LAYERS of its 24
# layers (a checkpoint of half the bytes: its write and restores take
# most of a phase), TrainConfig's defaults (remat, bf16 compute over fp32
# params), batch 8 of 1024 random tokens, over NCCL at a world of one.  elastic-reshard-pipe trains ELASTIC_STEPS
# steps under pipeshard on one stage, interleaved, the uneven split
# ELASTIC_SPLIT, ELASTIC_MICRO microbatches, checkpoints, reshards the
# checkpoint onto fsdp and takes one more step; elastic-reshard-flat the
# same from zero2 onto that pipeshard layout; elastic-recover runs the
# recovery mode of ``launch/replan.py`` on the ELASTIC_GPUS topology
# with site V2 dead from the first phase's checkpoint, two steps.  The
# resharded params and moments must be bit-equal to the host-side
# reference re-placement (``train.reshard.reshard_state``), and every
# loss after a reshard bit-equal to a control that restored the same
# checkpoint without the reshard code.  The reference's search picks
# ELASTIC_WINNER for this workload at 24 layers (tests/test_torch_elastic
# .py), and the port's at 12 and 8 too.
ELASTIC_STEPS, ELASTIC_MICRO, ELASTIC_SPLIT = 2, 4, (7, 5)
ELASTIC_LAYERS = sum(ELASTIC_SPLIT)
ELASTIC_GPUS, ELASTIC_DEAD, ELASTIC_WINNER = "A30;A30", (1,), ("data", (0,))
# the serve phases: gpt2L at full size through ``Engine`` (batch 8,
# prompt 64, 32 new tokens) under each flat plan over NCCL at a world of
# one, fp32 KV (``serve-<plan>``), under shard with the int8 cache
# (``serve-shard-int8``) and through ``ContinuousEngine`` (int8, 8 slots,
# 16 requests of 16 to 256 tokens, ``serve-shard-continuous``), and
# llama3.2-3b at full size with the int8 cache under shard
# (``serve-llama-shard``): kernels A and B at head_dim 128 and kernel 6.
# Each phase serves SERVE_RUNS times (TTFT and tokens/s as the median
# and spread), after one run of the one-device engine on the same
# weights and prompts (``serve-one-<kind>``), whose tokens it must give.
# At a world of one the merge of one block is exact and every gather a
# copy, so bit-equal tokens are expected; a phase that is not compares
# the logits of prefill and of every decode step, teacher-forced on the
# one-device tokens, within SERVE_LOGIT_RTOL of the largest logit.
SERVE_RUNS, SERVE_LOGIT_RTOL = 3, 1e-2
# ...but these serve once (their first run's tokens and every check as
# before): the two longest of the phases, cut to pay for the whisper
# stage's seconds, the next four, cut to pay for the VLM stage's, and the
# last two, cut to make room for the dry run's phase
SERVE_ONE_RUN = ("serve-fsdp", "serve-shard-continuous", "serve-shard",
                 "serve-shard_zero", "serve-shard-int8", "serve-llama-shard",
                 "serve-data", "serve-zero2")
# (phase, arch, plan, KV dtype, engine)
SERVE_PHASES = tuple((f"serve-{p}", PLAN_ARCH, p, "fp32", "engine")
                     for p in PLAN_NAMES) + (
    ("serve-shard-int8", PLAN_ARCH, "shard", "int8", "engine"),
    ("serve-shard-continuous", PLAN_ARCH, "shard", "int8", "continuous"),
    ("serve-pipeshard", PLAN_ARCH, "pipeshard", "fp32", "engine"),
    ("serve-pipeshard-continuous", PLAN_ARCH, "pipeshard", "int8",
     "continuous"),
    ("serve-llama-shard", "llama3.2-3b", "shard", "int8", "engine"))
# gpt2L under pipeshard: one stage of two chunks, the uneven (16, 14)
SERVE_PIPE_SPLIT = (16, 14)
# the families under the serving plans, at a world of one: each model
# built once, its one-device Engine (``serve-one-<tag>-engine-<kv>``),
# then under shard and under pipeshard (one stage; zamba2 two chunks of
# its 9 groups), one run each, their tokens held to the one-device
# engine's as the gpt2L phases' are.  phi3.5-MoE keeps 7 of its 32
# layers: at 8 the stack would be as deep as the batch of 8, which
# ``cache_spec`` takes for the batch (it finds the batch by size) and
# the serving plans refuse.  (tag, arch, layers kept or None, KV dtype,
# kernels each phase must launch, pipeline split or None)
SERVE_FAMILIES = (
    ("moe", "phi3.5-moe-42b-a6.6b", 7, "int8",
     ("rmsnorm", "flash_attn_fwd", "int8kv_decode"), None),
    ("ssm", "falcon-mamba-7b", None, "fp32", ("mamba1_scan", "rmsnorm"),
     None),
    ("hybrid", "zamba2-2.7b", None, "fp32",
     ("ssd_scan", "flash_attn_fwd", "rmsnorm"), (5, 4)))
# the dry run against the card (``dryrun-vs-card``): gpt2m's predicted
# peak of one training step at train-gpt2m's shape (the meta device's,
# ``launch/dryrun.py``) within DRYRUN_PEAK_RTOL of the peak the card
# measured for its last step; that step no faster than the roofline's
# max(compute, memory); gpt2L's collectives under shard on plan-shard's
# mesh of one rank equal, call for call and byte for byte, to one step
# of plan-shard's
DRYRUN_PEAK_RTOL = 0.10
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
# ...and the MLA latents' widths: kv_norm's 256 and q_norm's 768
# (minicpm3-4b), kv_norm's 512 and q_norm's 1536 (deepseek-v2-236b)
RMS_MLA_DS = (256, 512, 768, 1536)
# the slice-5 models: llama3.2-3b at full width and depth; phi3.5-MoE at
# full width, cut to MOE_LAYERS of its 32 layers (10.7 B parameters, 43
# GB in fp32; all 32 would need ~167 GB in fp32, 84 GB in bf16)
LLAMA, MOE, MOE_LAYERS = "llama3.2-3b", "phi3.5-moe-42b-a6.6b", 8
NORM_ATTN = ("rmsnorm", "flash_attn_fwd")
# the MLA phases: minicpm3-4b at full width and depth through both
# engines (the bf16 cache: MLA's latent cache is not quantized);
# deepseek-v2-236b at full width cut to DSV2_LAYERS of its 60 layers (a
# layer holds ~3.97 B parameters, the embedding and head 1.05 B: 2
# layers are ~36 GB in fp32, all 60 ~958 GB); phi4-mini-3.8b at full
# size with the int8 cache; and minicpm3 training at full width cut to
# TRAIN_MLA_LAYERS layers, TRAIN_MLA_STEPS steps of FAM_BATCH x FAM_SEQ
# random tokens through the plain versions (kernel A has no backward at
# (96, 64)).  Kernel A at the split head dims is held at the Engine
# prefill and the ContinuousEngine's longest prompt, MLA_FLASH_SHAPES.
MINICPM, DSV2, DSV2_LAYERS = "minicpm3-4b", "deepseek-v2-236b", 2
PHI4 = "phi4-mini-3.8b"
TRAIN_MLA_LAYERS, TRAIN_MLA_STEPS = 8, 3
MLA_FLASH_SHAPES = ((8, 64), (1, 256))

# ~1 ms at the H100's clocks: longer than the host takes to enqueue any
# one function timed here
SLEEP_CYCLES = 2_000_000
# the minimal launch timed beside the decode kernels: a sleep of a few
# cycles
FLOOR_CYCLES = 10
SEED = 0
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_GEN = 8, 64, 32
# the encoder-decoder: whisper-small at full size (12 encoder and 12
# decoder layers, d_model 768, 12 heads of 64, 1500 frames), one model on
# the card.  Kernel A non-causal at its attention's shapes, batch 8, H =
# KV = 12, D = 64, (Sq, Sk): the cross-attention at the Engine prompt
# and at the training length over the frames, the encoder's
# self-attention, and a single query row over every frame (the edge of a
# query tile; 1500 = 23 x 64 + 28 ends on the edge of a key tile); its
# backward at the training cross-attention and the encoder.  Training:
# WHISPER_STEPS steps of ENGINE_BATCH x WHISPER_SEQ tokens (whisper's
# longest text) over ENGINE_BATCH x 1500 frames.
WHISPER, WHISPER_HEADS = "whisper-small", (12, 12, 64)
WHISPER_FWD = tuple((ENGINE_BATCH, sq, 1500) for sq in (64, 448, 1500, 1))
WHISPER_BWD = tuple((ENGINE_BATCH, sq, 1500) + WHISPER_HEADS
                    for sq in (448, 1500))
WHISPER_SEQ, WHISPER_STEPS = 448, 3
# the vision-language model: phi-3-vision-4.2b at full size (32 layers,
# d_model 3072, 32 heads of 96 over 32 KV heads, 576 patches of 1024
# features, random patches x 0.02 from the seed), one model on the card;
# its Engine's cache holds the patches, the prompt and the new tokens
# (VLM_LEN).  Kernel A at (96, 96), causal, batch 8: the Engine prefill
# of 576 + 64 positions, a 256-token prefill and a ragged 577; kernel B
# at 96 over 32 KV heads: the Engine's int8 cache of VLM_LEN slots
# filled P + 64 to P + 95 (its 31 decode steps), a 1024-slot cache and
# mixed masks.  Training at full width cut to TRAIN_VLM_LAYERS of its 32
# layers (the 8-layer model, its AdamW state and gradients: ~18 GB),
# TRAIN_VLM_STEPS steps of ENGINE_BATCH x (576 patches + TRAIN_VLM_SEQ
# text tokens) through the plain versions (no backward at 96 and for
# RMSNorm), then under pipeshard on one stage, PIPE_MICRO microbatches,
# held to it as the gpt2L pipe phases are.
VLM = "phi-3-vision-4.2b"
VLM_PATCHES = 576
VLM_LEN = VLM_PATCHES + ENGINE_PROMPT + ENGINE_GEN + 8
VLM_FLASH_SHAPES = ((ENGINE_BATCH, VLM_PATCHES + ENGINE_PROMPT), (1, 256),
                    (1, VLM_PATCHES + 1))
VLM_INT8_CASES = ((ENGINE_BATCH, VLM_LEN, (VLM_PATCHES + ENGINE_PROMPT,
                                           VLM_PATCHES + ENGINE_PROMPT
                                           + ENGINE_GEN - 1)),
                  (ENGINE_BATCH, 1024, (17, 290)),
                  (ENGINE_BATCH, VLM_LEN, "mixed"))
TRAIN_VLM_LAYERS, TRAIN_VLM_SEQ, TRAIN_VLM_STEPS = 8, 448, 3
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

def sdpa_backend(torch, fn):
    """(backend, kernel): the device kernel that took longest in a trace
    of one ``fn`` (an SDPA call) and the SDPA backend its name tells;
    ("not measured", None) when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spent = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spent[e.name] = spent.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not spent:
        return "not measured", None
    name = max(spent, key=spent.get)
    low = name.lower()
    backend = ("cudnn" if "cudnn" in low else "efficient" if "fmha" in low
               else "flash" if "flash" in low else "math")
    return backend, name[:120]


def _lengths(shape):
    """(B, Sq, Sk) of a shape ``(B, S)`` (Sq = Sk) or ``(B, Sq, Sk)``, and
    the row keys that name it."""
    if len(shape) == 2:
        B, S = shape
        return B, S, S, {"B": B, "S": S}
    B, Sq, Sk = shape
    return B, Sq, Sk, {"B": B, "Sq": Sq, "Sk": Sk}


def check_flash(torch, F, H, KV, D, shapes, Dv=None, causal=True):
    """Kernel A against its plain version, causal or not, with H query
    heads over KV key/value heads, q and k of D and v of ``Dv`` (default
    D), at shapes ``(B, S)`` or ``(B, Sq, Sk)``; SDPA on the same tensors
    beside it, with the backend it picked."""
    from repro_torch.kernels import flash_attention as fa

    Dv = D if Dv is None else Dv
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows, worst = [], 0.0
    for shape in shapes:
        B, Sq, Sk, at = _lengths(shape)
        q, k, v = (torch.randn((B, n, h, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for n, h, d in ((Sq, H, D),
                                                       (Sk, KV, D),
                                                       (Sk, KV, Dv)))
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        what = f"H={H} KV={KV} D={D}" + (f" Dv={Dv}" if Dv != D else "") \
            + ("" if causal else " non-causal")
        where = " ".join(f"{k}={v}" for k, v in at.items())
        if not err <= KERNEL_ATOL:
            fail(f"flash_attn_fwd {what} {where}: max_abs_err {err} > "
                 f"{KERNEL_ATOL}")
        worst = max(worst, err)
        qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # visible pairs: the causal triangle, or every query and key
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        flops = 2 * (D + Dv) * pairs * B * H     # Q K^T and P V
        # bf16 q (D) and output (Dv) at H heads, k (D) and v (Dv) at KV
        b_ms, b_by = bound(2 * B * (Sq * H + Sk * KV) * (D + Dv), flops)

        def sdpa():
            return F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=causal, enable_gqa=KV != H)

        backend, sdpa_kernel = sdpa_backend(torch, sdpa)
        row = {
            **at, "H": H, "KV": KV, "D": D, "Dv": Dv, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=causal), iters=5),
            "library_ms": time_ms(torch, sdpa),
            "library_backend": backend, "library_kernel": sdpa_kernel,
            "bound_ms": b_ms, "bound_by": b_by}
        if not causal:
            row["causal"] = False
        rows.append(add_rates(row, flops))
        where = f"B={B:2d} S={Sq:5d}" if causal else \
            f"B={B:2d} Sq={Sq:4d} Sk={Sk:4d}"
        log(f"flash_attn_fwd {what} {where} err={err:.3e} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"sdpa_ms={row['library_ms']:.4f} ({backend}: {sdpa_kernel}) "
            f"bound_ms={b_ms:.5f} ({b_by}) {row['tflops']:.1f} TFLOP/s, "
            f"{row['x_library']:.2f}x SDPA, {row['x_bound']:.1f}x bound")
    return rows, worst


def check_flash_bwd(torch, F, shapes=BWD_SHAPES, causal=True):
    """Kernel A's backward against its plain version on the same bf16
    inputs and the forward kernel's lse and output (as training runs
    them, ``FlashAttention``: the bf16 output where causal, the fp32 one
    where not), causal at ``(B, S, H, KV, D)`` shapes or not at ``(B, Sq,
    Sk, H, KV, D)`` ones; the forward's lse (and fp32 output) against
    the plain logsumexp (and fp32 output); SDPA's backward (same mask) as
    the yardstick."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, worst = [], 0.0
    for shape in shapes:
        B, Sq, Sk, at = _lengths(shape[:-3])
        H, KV, D = shape[-3:]
        q, k, v, do = (torch.randn((B, n, h, D), generator=g, device="cuda")
                       .to(torch.bfloat16) for n, h in ((Sq, H), (Sk, KV),
                                                        (Sk, KV), (Sq, H)))
        o32 = None if causal else torch.empty(q.shape, dtype=torch.float32,
                                              device="cuda")
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         return_lse=True, o32=o32)
        o_plain, lse_plain = fa.flash_attention_plain(
            q, k, v, causal=causal, return_lse=True,
            out_dtype=torch.float32)
        if o32 is not None:
            o = o32
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                            causal=causal)
        torch.cuda.synchronize()
        what = "flash_attn_bwd " + " ".join(
            f"{k}={v}" for k, v in at.items()) + f" H={H} KV={KV} D={D}" \
            + ("" if causal else " non-causal")
        lse_err = float((lse - lse_plain).abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"{what}: lse max_abs_err {lse_err} > {LSE_ATOL}")
        o32_err = None if o32 is None else float((o - o_plain).abs().max())
        if o32 is not None and not o32_err <= KERNEL_ATOL:
            fail(f"{what}: fp32 output max_abs_err {o32_err} > "
                 f"{KERNEL_ATOL}")
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

        def sdpa():
            return F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=causal, enable_gqa=KV != H)

        out = sdpa()
        doT = do.transpose(1, 2).contiguous()
        # visible pairs: the causal triangle, or every query and key
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        # bf16 q, o, dO and dq at H heads, k, v, dk, dv at KV heads, fp32
        # lse (and o in fp32 where not causal); five products (S, dP, dV,
        # dK, dQ) of 2 D flops a pair
        n_bytes = 2 * B * D * (4 * H * Sq + 4 * KV * Sk) + 4 * B * H * Sq \
            + (0 if causal else 2 * B * Sq * H * D)
        flops = 10 * D * pairs * B * H
        b_ms, b_by = bound(n_bytes, flops)
        row = {
            **at, "H": H, "KV": KV, "D": D, "max_abs_err": err,
            "rel_err": rel, "lse_max_abs_err": lse_err,
            "ms": time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, causal=causal)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, do, lse, causal=causal), iters=3, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                out, (qT, kT, vT), doT, retain_graph=True)),
            "fwd_lse_ms": time_ms(torch, lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal, return_lse=True, o32=o32)),
            "bound_ms": b_ms, "bound_by": b_by}
        if not causal:
            row["causal"] = False
            row["o32_max_abs_err"] = o32_err
            row["library_backend"] = sdpa_backend(
                torch, lambda: torch.autograd.grad(
                    out, (qT, kT, vT), doT, retain_graph=True))[0]
        rows.append(add_rates(row, flops))
        log(f"{what} err={err:.3e} rel dq/dk/dv="
            f"{rel['dq']:.2e}/{rel['dk']:.2e}/{rel['dv']:.2e} "
            f"lse_err={lse_err:.2e} "
            + ("" if causal else f"o32_err={o32_err:.2e} ")
            + f"ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"sdpa_bwd_ms={row['library_ms']:.4f}"
            + (f" ({row['library_backend']}) " if not causal else " ")
            + f"fwd_with_lse_ms={row['fwd_lse_ms']:.4f} bound_ms={b_ms:.5f} "
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
    ``decode_mask`` makes them); a rerun must give the same bits.  Its
    log-sum-exp output (``with_lse``, what a serving plan merges the
    ring's blocks by) is held to the plain version's within
    ``LSE_ATOL``, -inf on a row with no live key, and must leave the
    output's bits as they were; it is timed beside the plain call."""
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
        with_lse, lse = qz.int8kv_attention_cuda(*args, with_lse=True)
        _, want_lse = qz.int8kv_attention_plain(*args, with_lse=True)
        torch.cuda.synchronize()
        dead_rows = ~valid.any(-1)
        lse_err = float((lse - want_lse)[~dead_rows].abs().amax()) \
            if not dead_rows.all() else 0.0
        if not torch.equal(with_lse, got):
            fail(f"{what}: the output with the lse differs from without")
        if not (torch.isneginf(lse[dead_rows]).all() and
                lse_err <= LSE_ATOL):
            fail(f"{what}: lse max_abs_err {lse_err} > {LSE_ATOL}, or a row "
                 f"with no live key without -inf")
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
            "with_lse_ms": time_ms(torch, lambda: qz.int8kv_attention_cuda(
                *args, with_lse=True)),
            "lse_max_abs_err": lse_err,
            "plain_ms": time_ms(torch, lambda: qz.int8kv_attention_plain(
                *args)),
            "library_ms": None,
            "sdpa_dequant_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask, enable_gqa=KV != H)),
            "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"{what} live={live:5d} splits={row['splits']} err={err:.3e} "
            f"ms={row['ms']:.4f} with_lse_ms={row['with_lse_ms']:.4f} "
            f"lse_err={lse_err:.2e} plain_ms={row['plain_ms']:.4f} "
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
    shapes = [(rows, d) for d in RMS_DS + RMS_MLA_DS for rows in RMS_ROWS]
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


def first_step(torch, m, params, batch, kv_dtype, tok=None,
               capacity=ENGINE_PROMPT + 8):
    """(prefill logits, decode logits, fed token) of one model on the
    engine batch; the decode step feeds ``tok`` (or the prefill's greedy
    token), so that two paths decode the same token.  ``capacity``: the
    cache's positions (a VLM's holds its patches too)."""
    with torch.no_grad():
        cache = m.init_cache(ENGINE_BATCH, capacity, kv_dtype=kv_dtype)
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


def check_moe_logits(torch, Model, cfg, params, batch, kv="int8"):
    """First-step logits of the MoE model (``kv`` cache, int8 by
    default), kernel path against the fp32 plain path on the card.  Two
    correct bf16 paths may route a near-tie token to different experts,
    so the kernel path is held to a control: it may be no farther from
    the fp32 plain path than ``NOISE_FACTOR`` times the bf16 plain path
    is (as ``train-parity`` holds its gradients)."""
    import dataclasses

    k = first_step(torch, Model(cfg, device="cuda"), params, batch, kv)
    p = first_step(torch, Model(cfg, device="cuda", use_kernels=False),
                   params, batch, kv, k[2])
    f = first_step(torch, Model(dataclasses.replace(cfg, dtype="float32"),
                                device="cuda", use_kernels=False),
                   params, batch, kv, k[2])
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


def check_combine_bits(torch, cfg, params):
    """Layer 0's MoE at the config's top-k on one bf16 input [ENGINE_BATCH,
    ENGINE_PROMPT, d_model], run twice: the ordered combine must give the
    same bits."""
    from repro_torch.models import moe as moe_mod

    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((ENGINE_BATCH, ENGINE_PROMPT, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        a, _ = moe_mod.moe_forward(x, p, cfg)
        b, _ = moe_mod.moe_forward(x, p, cfg)
    torch.cuda.synchronize()
    if not torch.isfinite(a).all():
        fail(f"{cfg.name} MoE layer: non-finite output")
    if not torch.equal(a, b):
        fail(f"{cfg.name} MoE layer at top-{cfg.moe.top_k}: two runs on "
             f"one input gave other bits")
    log(f"{cfg.name} MoE layer 0 at top-{cfg.moe.top_k} of "
        f"{cfg.moe.n_experts} experts, {x.shape[0] * x.shape[1]} tokens: "
        f"two runs bit-equal")
    return {"top_k": cfg.moe.top_k, "tokens": x.shape[0] * x.shape[1],
            "bit_equal": True}


def mla_phases(torch, np, ops, card):
    """Phases ``mla-engine`` and ``mla-continuous`` (minicpm3-4b at full
    size, bf16 cache), ``dsv2-engine`` (deepseek-v2-236b at full width,
    ``DSV2_LAYERS`` layers, bf16 cache) and ``phi4mini-engine``
    (phi4-mini-3.8b at full size, int8 cache), one model on the card at a
    time, then ``train-mla``.  Every Engine phase must launch kernel 6
    (4L + 1) times a forward pass with MLA (the block's two norms,
    ``q_norm`` and ``kv_norm`` a layer, and the final norm), 2L + 1
    without, kernel A L times (its prefill) and, with the int8 cache,
    kernel B L times a decode step.  Returns (records, first-step logit
    checks)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    rng = np.random.default_rng(SEED + 6)
    out, logits = {}, {}
    for tag, arch, layers, kv in (("mla", MINICPM, None, "fp32"),
                                  ("dsv2", DSV2, DSV2_LAYERS, "fp32"),
                                  ("phi4mini", PHI4, None, "int8")):
        mcfg = get_config(arch)
        if layers:
            log(f"{arch}: depth cut to {layers} of {mcfg.n_layers} layers "
                f"(all {mcfg.n_layers} hold "
                f"{mcfg.param_count() / 1e9:.1f} B parameters, "
                f"{4 * mcfg.param_count() / 1e9:.0f} GB in fp32: more than "
                f"one card); width unchanged")
            mcfg = dataclasses.replace(mcfg, n_layers=layers)
        L = mcfg.n_layers
        model = Model(mcfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        n_params = sum(t.numel() for t in flatten(params).values())
        log(f"{arch}: {L} layers, {n_params / 1e9:.3f} B parameters, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        batch = {"tokens": rng.integers(4, mcfg.vocab_size,
                                        (ENGINE_BATCH, ENGINE_PROMPT),
                                        dtype=np.int64)}
        if mcfg.moe is not None:
            logits[arch] = check_moe_logits(torch, Model, mcfg, params,
                                            batch, kv)
            out[f"{tag}_combine"] = check_combine_bits(torch, mcfg, params)
        else:
            k = first_step(torch, model, params, batch, kv)
            p = first_step(torch, Model(mcfg, device="cuda",
                                        use_kernels=False),
                           params, batch, kv, k[2])
            logits[arch] = compare_logits(
                torch, f"{arch} logits kernel vs plain", k, p, LOGIT_RTOL)
            del k, p
        norms = 4 * L + 1 if mcfg.mla is not None else 2 * L + 1
        needs = NORM_ATTN + (("int8kv_decode",) if kv == "int8" else ())
        name = f"{tag}-engine"
        rec = engine_phase(torch, np, ops, name, model, params, batch, needs,
                           card, kv_dtype=kv)
        want = {"rmsnorm": norms * ENGINE_GEN, "flash_attn_fwd": L,
                "int8kv_decode": L * (ENGINE_GEN - 1) if kv == "int8"
                else 0}
        for kname, n in want.items():
            if rec["launches"][kname] != n:
                fail(f"phase {name}: {rec['launches'][kname]} {kname} "
                     f"launches, want {n}")
        out[f"{tag}_engine"] = rec
        if tag == "mla":
            eng = Engine(model, batch_size=ENGINE_BATCH,
                         max_len=ENGINE_PROMPT + ENGINE_GEN + 8, kv_dtype=kv)
            prof = profile_window(
                torch, lambda: eng.generate(params, batch, n_tokens=8,
                                            timing=False), OUR_KERNELS)
            log_profile("mla-engine, prefill + 7 decode steps", prof)
            out["profile_mla_engine"] = prof
            del eng
            rec = continuous_phase(
                torch, np, ops, "mla-continuous", model, params, rng,
                CONT_LENS[1] + CONT_GEN + 8, NORM_ATTN, card, kv_dtype=kv)
            # one forward pass a request's prefill and a decode step
            passes = CONT_REQUESTS + rec["decode_steps"]
            want = {"rmsnorm": norms * passes,
                    "flash_attn_fwd": L * CONT_REQUESTS}
            for kname, n in want.items():
                if rec["launches"][kname] != n:
                    fail(f"phase mla-continuous: {rec['launches'][kname]} "
                         f"{kname} launches, want {n}")
            out["mla_continuous"] = rec
        out[f"{tag}_params"] = n_params
        out[f"{tag}_layers"] = L
        del model, params
        torch.cuda.empty_cache()
    out["train_mla"] = train_mla_phase(torch, np, ops, card)
    return out, logits


def train_mla_phase(torch, np, ops, card):
    """Phase ``train-mla``: minicpm3-4b at full width cut to
    ``TRAIN_MLA_LAYERS`` layers, ``TRAIN_MLA_STEPS`` steps of FAM_BATCH x
    FAM_SEQ random tokens through ``train()`` as ``launch/train.py``
    drives it: ``use_kernels=trains_through_kernels(cfg)``, which is False
    for MLA (kernel A has no backward at (96, 64)), so no kernel may
    launch; the losses must be finite."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import Loader, PackedDataset
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.train import model_flops_per_step, train

    full = get_config(MINICPM)
    cfg = dataclasses.replace(full, n_layers=TRAIN_MLA_LAYERS,
                              max_seq_len=max(full.max_seq_len, FAM_SEQ))
    if trains_through_kernels(cfg):
        fail(f"{MINICPM}: expected the launchers to train MLA through the "
             f"plain versions")
    log(f"train-mla: {MINICPM} at full width, reduced: {TRAIN_MLA_LAYERS} "
        f"of {full.n_layers} layers, {cfg.param_count() / 1e9:.3f} B "
        f"params; batch {FAM_BATCH} x {FAM_SEQ} random tokens, "
        f"{TRAIN_MLA_STEPS} steps; the kernels' plain versions")
    model = Model(cfg, device="cuda", use_kernels=trains_through_kernels(cfg))
    rng = np.random.default_rng(SEED + 3)
    ds = PackedDataset(rng.integers(
        0, cfg.vocab_size, (TRAIN_MLA_STEPS * FAM_BATCH, FAM_SEQ + 1))
        .astype(np.int32), FAM_SEQ)
    loader = Loader(ds, global_batch=FAM_BATCH, seed=SEED)
    tokens = FAM_BATCH * FAM_SEQ
    flops = model_flops_per_step(cfg, tokens)
    res, counts = run_phase(
        torch, ops, "train-mla",
        lambda: train(model, TrainConfig(), loader, steps=TRAIN_MLA_STEPS,
                      log_every=0, donate=True), [])
    if any(counts.values()):
        fail(f"train-mla: the plain path launched kernels {counts}")
    if not all(np.isfinite(res.losses)):
        fail(f"train-mla: non-finite losses {res.losses}")
    step_s = res.avg_step_time
    rec = {"layers": TRAIN_MLA_LAYERS, "losses": res.losses,
           "step_s": res.step_times,
           "avg_step_s_steps_2_to_3": step_s,
           "tokens_per_s": tokens / step_s,
           "model_tflops": flops / step_s / 1e12,
           "peak_bytes": PHASES["train-mla"]["peak_bytes"],
           "launches": counts}
    log(f"train-mla: losses {res.losses}; step {step_s * 1e3:.1f} ms (steps "
        f"2 to {TRAIN_MLA_STEPS}), {tokens / step_s:.0f} tokens/s, 6ND "
        f"{rec['model_tflops']:.2f} TFLOP/s, peak memory "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB, on {card}")
    del res, model
    torch.cuda.empty_cache()
    return rec


def whisper_phases(torch, np, ops, card):
    """Phases ``whisper-engine`` and ``train-whisper``: whisper-small at
    full size.  ``Engine`` (batch 8, prompt 64, 32 new tokens, the cache
    in the compute dtype) over frames [8, 1500, 768] x 0.02 from the
    seed, as ``launch/serve.py`` makes them: kernel A 36 times a prefill
    (12 encoder layers, 12 causal self-attentions, 12 non-causal
    cross-attentions over the frames), none a decode step (the cached
    cross K/V is read by the plain ``decode_attention``, as the
    reference's jnp one).  The prefill's and the first decode step's
    logits held to ``use_kernels=False``.  Then ``WHISPER_STEPS`` steps
    of the one-device training step (remat: kernel A 12 + 2 x 24 forward
    launches and 36 backward a step, the encoder outside the remat), and
    one step's loss and gradients held to the plain path with the fp32
    control (``check_train_parity``, phase ``whisper-parity``).  A traced
    generate and a traced step.  Returns (records, first-step logit
    checks)."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import flatten
    from repro_torch.core.steps import build_train_step, value_and_grad
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.optim import init_adamw
    from repro_torch.serve import Engine
    from repro_torch.train import model_flops_per_step

    cfg = get_config(WHISPER)
    F = cfg.enc_seq_len
    # kernel A's attentions a forward pass: the encoder's, and each
    # decoder layer's self- and cross-attention
    A = cfg.n_enc_layers + 2 * cfg.n_layers
    if not trains_through_kernels(cfg):
        fail(f"{WHISPER}: expected training through kernel A's backward")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"{WHISPER}: {cfg.n_enc_layers} encoder and {cfg.n_layers} decoder "
        f"layers, {cfg.param_count() / 1e6:.1f} M parameters by "
        f"param_count, {n_params / 1e6:.1f} M leaves (biases, norms and "
        f"the position tables), "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(SEED + 8)
    batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                    (ENGINE_BATCH, ENGINE_PROMPT),
                                    dtype=np.int64),
             "frames": np.asarray(rng.standard_normal(
                 (ENGINE_BATCH, F, cfg.d_model)) * 0.02, np.float32)}
    out, logits = {"whisper_params": n_params}, {}
    k = first_step(torch, model, params, batch, "fp32")
    p = first_step(torch, Model(cfg, device="cuda", use_kernels=False),
                   params, batch, "fp32", k[2])
    logits[WHISPER] = compare_logits(
        torch, f"{WHISPER} logits kernel vs plain", k, p, LOGIT_RTOL)
    del k, p
    rec = engine_phase(torch, np, ops, "whisper-engine", model, params,
                       batch, ["flash_attn_fwd"], card, kv_dtype="fp32")
    want = dict.fromkeys(ops.KERNELS, 0) | {"flash_attn_fwd": A}
    if rec["launches"] != want:
        fail(f"phase whisper-engine: launches {rec['launches']}, want "
             f"{want} (kernel A 12 + 12 + 12 a prefill)")
    rec["peak_bytes"] = PHASES["whisper-engine"]["peak_bytes"]
    out["whisper_engine"] = rec
    eng = Engine(model, batch_size=ENGINE_BATCH,
                 max_len=ENGINE_PROMPT + ENGINE_GEN + 8)
    prof = profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8,
                                    timing=False), OUR_KERNELS)
    log_profile("whisper-engine, prefill + 7 decode steps", prof)
    out["profile_whisper_engine"] = prof
    del eng, params

    # training: random text over random frames, one batch a step
    B, S = ENGINE_BATCH, WHISPER_SEQ

    def train_batch():
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                            device="cuda")
        f = torch.as_tensor(np.asarray(rng.standard_normal(
            (B, F, cfg.d_model)) * 0.02, np.float32), device="cuda")
        return {"tokens": t, "labels": t, "frames": f}

    batches = [train_batch() for _ in range(WHISPER_STEPS + 1)]
    tcfg = TrainConfig()
    step = build_train_step(model, tcfg, donate=True)
    state = [model.init(torch.Generator(device="cuda").manual_seed(SEED))]
    state.append(init_adamw(state[0]))
    needs = ["flash_attn_fwd", "flash_attn_bwd"]
    # remat reruns each decoder layer's two attentions in the backward;
    # the encoder runs once, outside it
    per_step = dict.fromkeys(ops.KERNELS, 0) | {
        "flash_attn_fwd": A + 2 * cfg.n_layers, "flash_attn_bwd": A}

    def expect(name, counts, steps):
        want = {k: n * steps for k, n in per_step.items()}
        if counts != want:
            fail(f"phase {name}: launches {counts}, want {want}")

    def run_steps():
        losses, times = [], []
        for b in batches[:WHISPER_STEPS]:
            t0 = time.perf_counter()
            params, opt, metrics = step(*state, b)
            state[:] = params, opt
            losses.append(float(metrics["loss"]))      # waits for the step
            times.append(time.perf_counter() - t0)
        return losses, times

    (losses, times), counts = run_phase(torch, ops, "train-whisper",
                                        run_steps, needs)
    expect("train-whisper", counts, WHISPER_STEPS)
    if not all(np.isfinite(losses)):
        fail(f"train-whisper: non-finite losses {losses}")
    tokens = B * S
    flops = model_flops_per_step(cfg, tokens)
    step_s = float(np.mean(times[1:]))
    rate = flops / step_s / 1e12
    out["train_whisper"] = {
        "batch": B, "seq": S, "frames": F, "steps": WHISPER_STEPS,
        "losses": losses, "step_s": times,
        "avg_step_s_steps_2_to_3": step_s, "tokens_per_s": tokens / step_s,
        "model_tflops": rate, "peak_bytes": PHASES["train-whisper"][
            "peak_bytes"], "launches": counts}
    log(f"train-whisper: losses {losses}; step {step_s * 1e3:.1f} ms (steps "
        f"2 to {WHISPER_STEPS}), {tokens / step_s:.0f} text tokens/s, 6ND "
        f"{rate:.2f} TFLOP/s (N the parameters, D the text tokens), peak "
        f"memory {out['train_whisper']['peak_bytes'] / 2**30:.2f} GiB, on "
        f"{card}")
    prof = profile_window(
        torch, lambda: step(*state, batches[-1]), OUR_KERNELS)
    log_profile("train-whisper, one step", prof)
    out["profile_train_whisper"] = prof
    del state, step
    torch.cuda.empty_cache()

    # whisper-parity: one step's loss and gradients, fresh params
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    paths = {"kernel": model,
             "plain": Model(cfg, device="cuda", use_kernels=False),
             "fp32": Model(dataclasses.replace(cfg, dtype="float32"),
                           device="cuda", use_kernels=False)}
    grads, losses = {}, {}
    for name, m in paths.items():
        def vg(m=m):
            return value_and_grad(lambda p, b: m.loss(p, b), params,
                                  batches[0])
        if name == "kernel":
            (loss, _, g), counts = run_phase(torch, ops, "whisper-parity",
                                             vg, needs)
            expect("whisper-parity", counts, 1)
            out["whisper_parity_launches"] = counts
        else:
            loss, _, g = vg()
        losses[name], grads[name] = float(loss), flatten(g)
        del g
        torch.cuda.empty_cache()
    out["whisper_parity"] = check_train_parity(grads, losses,
                                               "whisper-parity")
    del grads, params, model, paths
    torch.cuda.empty_cache()
    return out, logits


def vlm_phases(torch, np, ops, card, mesh):
    """Phases ``vlm-engine``, ``vlm-int8``, ``serve-vlm-pipeshard``,
    ``train-vlm`` and ``fam-vlm-pipe`` in the process group of
    ``plan_phases`` on its mesh of one rank: phi-3-vision-4.2b at full
    size through ``Engine`` (batch 8, prompt 64 after the 576 patches,
    32 new tokens; the cache in the compute dtype, then int8), kernel A
    L times a prefill at (96, 96), kernel 6 2L + 1 times a forward pass
    and, with the int8 cache, kernel B L times a decode step at 96; the
    prefill's and the first decode step's logits of both caches held to
    ``use_kernels=False``; one traced int8 generate; the int8 Engine
    under pipeshard on one stage, its tokens held to ``vlm-int8``'s.
    Then the model at full width cut to ``TRAIN_VLM_LAYERS`` layers:
    ``TRAIN_VLM_STEPS`` one-device steps of 8 x (576 patches +
    ``TRAIN_VLM_SEQ`` text tokens) through the plain versions, the
    step-1 loss held to an fp32 control, then the same steps under
    pipeshard (one stage, ``PIPE_MICRO`` microbatches, 1F1B), held to
    them.  Returns (records, each with its launches; first-step logit
    checks; the traced generate)."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import flatten
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.optim import init_adamw
    from repro_torch.serve import Engine
    from repro_torch.serve import steps
    from repro_torch.train import model_flops_per_step

    t_all = time.perf_counter()
    cfg = get_config(VLM)
    L, P = cfg.n_layers, cfg.n_patches
    if P != VLM_PATCHES or cfg.head_dim != 96:
        fail(f"{VLM}: expected {VLM_PATCHES} patches and heads of 96")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"{VLM}: {L} layers, {cfg.param_count() / 1e9:.3f} B parameters by "
        f"param_count, {n_params / 1e9:.3f} B leaves, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(SEED + 12)

    def patches(B):
        return np.asarray(rng.standard_normal((B, P, cfg.vision_dim))
                          * 0.02, np.float32)

    batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                    (ENGINE_BATCH, ENGINE_PROMPT),
                                    dtype=np.int64),
             "patch_embeds": patches(ENGINE_BATCH)}
    out, logits = {}, {}
    plain = Model(cfg, device="cuda", use_kernels=False)
    for kv in ("fp32", "int8"):
        k = first_step(torch, model, params, batch, kv,
                       capacity=P + ENGINE_PROMPT + 8)
        p = first_step(torch, plain, params, batch, kv, k[2],
                       capacity=P + ENGINE_PROMPT + 8)
        logits[f"{VLM} {kv}"] = compare_logits(
            torch, f"{VLM} logits kernel vs plain ({kv} cache)", k, p,
            LOGIT_RTOL)
        del k, p
    del plain
    # kernel 6 a forward pass: two norms a layer and the final one
    norms = (2 * L + 1) * ENGINE_GEN
    toks = {}
    for name, kv in (("vlm-engine", "fp32"), ("vlm-int8", "int8")):
        needs = NORM_ATTN + (("int8kv_decode",) if kv == "int8" else ())
        rec, toks[kv] = serve_runs(torch, np, ops, name, model, params,
                                   batch, [], kv, "engine", needs, card, L,
                                   VLM_LEN, 0, runs=1)
        if rec["launches"]["rmsnorm"] != norms:
            fail(f"phase {name}: {rec['launches']['rmsnorm']} rmsnorm "
                 f"launches, want {norms} (2L + 1 a forward pass)")
        out[name.replace("-", "_")] = rec
    eng = Engine(model, batch_size=ENGINE_BATCH, max_len=VLM_LEN,
                 kv_dtype="int8")
    prof = profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8,
                                    timing=False), OUR_KERNELS)
    log_profile("vlm-int8, prefill + 7 decode steps", prof)
    del eng

    # the int8 Engine under pipeshard on one stage, against vlm-int8
    staged = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1)
    name = "serve-vlm-pipeshard"
    eng = Engine(model, batch_size=ENGINE_BATCH, max_len=VLM_LEN,
                 kv_dtype="int8", plan="pipeshard", mesh=staged)
    local = eng.shard_params(params)
    rec, got = serve_runs(torch, np, ops, name, model, local, batch, [],
                          "int8", "engine", NORM_ATTN + ("int8kv_decode",),
                          card, L, VLM_LEN, 0, eng=eng, runs=1)
    rec.update(compare_served(torch, steps, sharding, name, model,
                              (params, local), batch, [], "int8", "engine",
                              eng, toks["int8"], got))
    if not rec["tokens_bit_equal"]:
        fail(f"{name}: tokens differ from vlm-int8's")
    out["serve_vlm_pipeshard"] = rec
    del eng, local, model, params
    torch.cuda.empty_cache()
    log(f"vlm serving: {time.perf_counter() - t_all:.1f}s")

    # training at full width, depth cut
    t_train = time.perf_counter()
    tcfg = dataclasses.replace(cfg, n_layers=TRAIN_VLM_LAYERS)
    if trains_through_kernels(tcfg):
        fail(f"{VLM}: expected training through the plain versions")
    B, S = ENGINE_BATCH, TRAIN_VLM_SEQ
    log(f"train-vlm: {VLM} at full width, reduced: {TRAIN_VLM_LAYERS} of "
        f"{L} layers, {tcfg.param_count() / 1e9:.3f} B params; batch {B} x "
        f"({P} patches + {S} text tokens), {TRAIN_VLM_STEPS} steps; the "
        f"kernels' plain versions")
    model = Model(tcfg, device="cuda", use_kernels=False)

    def train_batch():
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                            device="cuda")
        return {"tokens": t, "labels": t, "patch_embeds": torch.as_tensor(
            patches(B), device="cuda")}

    batches = [train_batch() for _ in range(TRAIN_VLM_STEPS)]
    with torch.no_grad():
        fresh = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        f32 = Model(dataclasses.replace(tcfg, dtype="float32"),
                    device="cuda", use_kernels=False)
        control = float(f32.loss(fresh, batches[0], remat=False)[0])
        del fresh, f32
    torch.cuda.empty_cache()
    text = B * S
    flops = model_flops_per_step(tcfg, text)

    def run_steps(name, step, state):
        def go():
            losses, times = [], []
            for b in batches:
                t0 = time.perf_counter()
                p_, o_, metrics = step(*state, b)
                state[:] = p_, o_
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t0)
            return losses, times

        (losses, times), counts = run_phase(torch, ops, name, go, [])
        if any(counts.values()):
            fail(f"{name}: the plain path launched kernels {counts}")
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite losses {losses}")
        step_s = float(np.mean(times[1:]))
        rec = {"layers": TRAIN_VLM_LAYERS, "batch": B, "patches": P,
               "text": S, "losses": losses, "step_s": times,
               "avg_step_s_steps_2_to_3": step_s,
               "text_tokens_per_s": text / step_s,
               "model_tflops": flops / step_s / 1e12,
               "peak_bytes": PHASES[name]["peak_bytes"], "launches": counts}
        log(f"{name}: losses {losses}; step {step_s * 1e3:.1f} ms (steps 2 "
            f"to {TRAIN_VLM_STEPS}), {text / step_s:.0f} text tokens/s, 6ND "
            f"{rec['model_tflops']:.2f} TFLOP/s (D the text tokens), peak "
            f"memory {rec['peak_bytes'] / 2**30:.2f} GiB, on {card}")
        return rec

    state = [model.init(torch.Generator(device="cuda").manual_seed(SEED))]
    state.append(init_adamw(state[0]))
    one = run_steps("train-vlm", build_train_step(model, TrainConfig(),
                                                  donate=True), state)
    rel = abs(one["losses"][0] - control) / abs(control)
    one["fp32_control_loss"], one["loss1_rel_to_fp32"] = control, rel
    log(f"train-vlm: step-1 loss {one['losses'][0]} against the fp32 "
        f"control's {control}: {rel:.3e} relative ({TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"train-vlm: step-1 loss {one['losses'][0]} vs fp32 {control}")
    out["train_vlm"] = one
    del state
    torch.cuda.empty_cache()

    staged = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1,
                                schedule="1f1b")
    step = build_train_step(model, TrainConfig(microbatches=PIPE_MICRO),
                            plan="pipeshard", mesh=staged, schedule="1f1b",
                            donate=True)
    state = [step.shard_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED)))]
    state.append(step.init_opt_state())
    sharding.reset_collective_counts()
    rec = run_steps("fam-vlm-pipe", step, state)
    rec["collectives_a_step"] = collectives_a_step(torch, TRAIN_VLM_STEPS)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                              one["losses"])]
    rec["loss_rel_diff"] = rel
    log(f"fam-vlm-pipe: held to train-vlm ({one['losses']}) within "
        f"{PIPE_LOSS1_RTOL} at step 1 and {PIPE_LOSS_RTOL} after: relative "
        f"differences {rel}")
    if not (rel[0] <= PIPE_LOSS1_RTOL and max(rel) <= PIPE_LOSS_RTOL):
        fail(f"fam-vlm-pipe: losses {rec['losses']} vs {one['losses']}")
    out["fam_vlm_pipe"] = rec
    del state, step, model, batches
    torch.cuda.empty_cache()
    log(f"vlm training: {time.perf_counter() - t_train:.1f}s; the VLM "
        f"stage {time.perf_counter() - t_all:.1f}s")
    return out, logits, {"params": n_params, "profile_vlm_int8": prof}


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
            "decode_steps": len(st.occupancy), "launches": counts}


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


def check_train_parity(grads, losses, name="train-parity"):
    """Loss, global gradient norm and each leaf's cosine of the kernel
    path against the fp32 plain path, held to ``NOISE_FACTOR`` times the
    bf16 plain path's distance from it (the control); the loss also
    directly against the bf16 plain path.  ``name``: the check's name in
    its messages."""
    k, p, f = (losses[n] for n in ("kernel", "plain", "fp32"))
    if not all(map(lambda x: x == x and abs(x) < float("inf"), (k, p, f))):
        fail(f"{name}: non-finite loss {losses}")
    if not abs(k - p) <= TRAIN_LOSS_RTOL * abs(p):
        fail(f"{name}: loss {k} vs plain {p}, beyond {TRAIN_LOSS_RTOL} "
             f"relative")
    if not abs(k - f) <= NOISE_FACTOR * abs(p - f) + TRAIN_NORM_FLOOR * abs(f):
        fail(f"{name}: loss {k} is {abs(k - f)} from fp32 {f}; the "
             f"bf16 plain path is {abs(p - f)} from it")
    norms = {n: float(sum(g.double().square().sum()
                          for g in grads[n].values()) ** 0.5)
             for n in grads}
    nk, np_, nf = norms["kernel"], norms["plain"], norms["fp32"]
    if not abs(nk - nf) <= NOISE_FACTOR * abs(np_ - nf) \
            + TRAIN_NORM_FLOOR * nf:
        fail(f"{name}: grad norm {nk} is {abs(nk - nf)} from fp32 "
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
            fail(f"{name} {key}: 1 - cos(kernel, fp32) = {1 - ck} > "
                 f"{NOISE_FACTOR} x (1 - cos(plain, fp32) = {1 - cp}) + "
                 f"{TRAIN_COS_FLOOR}")
    log(f"{name}: loss kernel {k:.6f} plain {p:.6f} fp32 {f:.6f}; "
        f"grad norm kernel {nk:.6f} plain {np_:.6f} fp32 {nf:.6f}")
    for key, r in leaves.items():
        log(f"  {key}: cos(kernel, fp32) {r['cos_kernel_fp32']:.6f} "
            f"cos(plain, fp32) {r['cos_plain_fp32']:.6f} cos(kernel, plain) "
            f"{r['cos_kernel_plain']:.6f}")
    log(f"{name}: worst leaf uses {worst:.3f} of its allowance")
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
    # one step's own peak, after warm-up: the last step's, from a reset
    # just before it to the log line just after it (the dry run's
    # prediction is held to it in ``dryrun-vs-card``)
    last = {}

    def before_step(i):
        if i == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            last["phase_peak_before"] = torch.cuda.max_memory_allocated()
            last["held_bytes"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def logged(m):
        if "held_bytes" in last and "peak_bytes" not in last:
            last["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  train-gpt2m: {m}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.cuda.reset_peak_memory_stats()
        res, counts = run_phase(
            torch, ops, "train-gpt2m",
            lambda: train(model, tcfg, loader, steps=TRAIN_STEPS,
                          log_every=1, ckpt_dir=ckpt_dir,
                          ckpt_every=TRAIN_CKPT_AT,
                          on_step_failure=before_step, log_fn=logged),
            needs)
        # the whole phase's peak: the larger of the two windows
        peak = max(torch.cuda.max_memory_allocated(),
                   last["phase_peak_before"])
        PHASES["train-gpt2m"]["peak_bytes"] = peak
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
            "step_peak_bytes": last["peak_bytes"],
            "step_held_bytes": last["held_bytes"],
            "metrics_last": res.metrics_last}
        log(f"train-gpt2m: losses {[round(x, 4) for x in res.losses]}")
        log(f"train-gpt2m: step {step_s * 1e3:.1f} ms (steps 2 to "
            f"{TRAIN_STEPS}), {tokens / step_s:.0f} tokens/s, 6ND "
            f"{rate:.2f} TFLOP/s = {rate * 1e12 / PEAK_BF16_FLOPS:.4f} of "
            f"989, peak memory {peak / 2**30:.2f} GiB; step {TRAIN_STEPS} "
            f"alone {last['peak_bytes']} bytes peak over "
            f"{last['held_bytes']} held before it, on {card}")

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
    phases (``pipe_phases``), the family phases (``family_phases``), the
    serve, elastic and VLM phases (``vlm_phases``; its logit checks and
    trace under ``vlm_logits`` and ``vlm_info``) in the same process
    group.  One more step of the one device, of
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
        out.update(serve_phases(torch, np, ops, card, mesh))
        out.update(serve_family_phases(torch, np, ops, card, mesh))
        out.update(elastic_phases(torch, np, ops, card, mesh))
        vlm, out["vlm_logits"], out["vlm_info"] = vlm_phases(
            torch, np, ops, card, mesh)
        out.update(vlm)
    finally:
        dist.destroy_process_group()
    del ref_params
    torch.cuda.empty_cache()
    return out


def dryrun_phase(torch, ops, card, training, plans):
    """Phase ``dryrun-vs-card``: the dry run held against what
    ``train-gpt2m`` and ``plan-shard`` measured on this card, with no
    step of its own on the card.  Fails past ``DRYRUN_PEAK_RTOL`` on the
    peak, below the roofline's bound on the step, and on any difference
    in the collectives."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BYTES

    def go():
        S = get_config("gpt2m").max_seq_len
        one = dryrun.run_one("gpt2m", ShapeConfig(
            "train_gpt2m", S, TRAIN_BATCH, "train"), None, verbose=False)
        S = get_config(PLAN_ARCH).max_seq_len
        shard = dryrun.run_one(PLAN_ARCH, ShapeConfig(
            "plan_gpt2L", S, TRAIN_BATCH, "train"), "shard",
            mesh_shape=(1, 1, 1), verbose=False)
        return one, shard

    (one, shard), _ = run_phase(torch, ops, "dryrun-vs-card", go, [])
    tg = training["train_gpt2m"]
    predicted, measured = one["memory_per_device_bytes"], \
        tg["step_peak_bytes"]
    rel = (predicted - measured) / measured
    log(f"dryrun-vs-card: gpt2m step peak predicted {predicted:.0f} bytes "
        f"({predicted / 2**30:.3f} GiB; MemTracker's split "
        f"{one['peak_split']}), measured {measured} bytes "
        f"({measured / 2**30:.3f} GiB, {tg['step_held_bytes']} held before "
        f"the step): {rel:+.4f} relative, gate {DRYRUN_PEAK_RTOL}")
    step_s = tg["avg_step_s_steps_2_to_6"]
    bound_s = max(one["compute_s"], one["memory_s"])
    log(f"dryrun-vs-card: gpt2m roofline (predicted from the H100 data "
        f"sheet's constants): compute {one['compute_s'] * 1e3:.3f} ms, "
        f"memory {one['memory_s'] * 1e3:.3f} ms, collective "
        f"{one['collective_s'] * 1e3:.3f} ms, dominant {one['dominant']}; "
        f"measured step {step_s * 1e3:.3f} ms; roofline share of the step "
        f"{bound_s / step_s:.4f}")
    want = plans["plan_shard"]["collectives_a_step"]
    log(f"dryrun-vs-card: gpt2L under shard, collectives a step: dry run "
        + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                    for k, v in shard["collectives"].items())
        + "; plan-shard " + ", ".join(
            f"{k} {v['calls']:g} calls {v['bytes']:.0f} bytes"
            for k, v in want.items()))
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"dryrun-vs-card: {card}; total_memory {total} bytes "
        f"({total / 1e9:.2f} GB) beside the data sheet's {HBM_BYTES:.0f}")
    if not abs(rel) <= DRYRUN_PEAK_RTOL:
        fail(f"dryrun-vs-card: predicted peak {predicted:.0f} vs measured "
             f"{measured}: {rel:+.4f} relative, past {DRYRUN_PEAK_RTOL}")
    if not step_s >= bound_s:
        fail(f"dryrun-vs-card: measured step {step_s} s beats the "
             f"roofline's bound {bound_s} s")
    diff = {k: (shard["collectives"][k], v) for k, v in want.items()
            if shard["collectives"][k]["calls"] != v["calls"]
            or shard["collectives"][k]["bytes"] != v["bytes"]}
    if diff:
        fail(f"dryrun-vs-card: gpt2L shard collectives differ (dry run, "
             f"card): {diff}")
    return {"peak_predicted_bytes": predicted, "peak_measured_bytes": measured,
            "peak_rel_diff": rel, "peak_split": one["peak_split"],
            "step_s": step_s, "compute_s": one["compute_s"],
            "memory_s": one["memory_s"], "roofline_share": bound_s / step_s,
            "collectives_dry": shard["collectives"],
            "collectives_card": want, "trace_s": [one["trace_s"],
                                                  shard["trace_s"]],
            "total_memory": total, "launches": PHASES["dryrun-vs-card"][
                "launches"]}


def serve_phases(torch, np, ops, card, mesh):
    """Phases ``SERVE_PHASES`` in the process group of ``plan_phases``
    on its mesh of one rank, each after its one-device yardstick
    (``serve-one-<kind>``, once a model, KV dtype and engine).  Each
    prints TTFT and decode tokens/s (median and spread of
    ``SERVE_RUNS``), the collectives of a decode step, the kernels'
    launches and the peak memory, and must launch kernel A L times a
    prefill and, with the int8 cache, kernel B L times a decode step.
    One decode step of ``serve-shard`` and of its yardstick is traced."""
    from repro_torch.configs import get_config
    from repro_torch.core import sharding
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine, Engine, Request
    from repro_torch.serve import steps

    out = {}
    t_serve = time.perf_counter()
    staged = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1)
    max_len = ENGINE_PROMPT + ENGINE_GEN + 8
    cont_len = CONT_LENS[1] + CONT_GEN + 8
    for arch in dict.fromkeys(a for _, a, _, _, _ in SERVE_PHASES):
        cfg = get_config(arch)
        L = cfg.n_layers
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        rng = np.random.default_rng(SEED + 7)
        batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                        (ENGINE_BATCH, ENGINE_PROMPT),
                                        dtype=np.int64)}
        lens = rng.integers(CONT_LENS[0], CONT_LENS[1] + 1, CONT_REQUESTS)
        reqs = [Request(i, rng.integers(4, cfg.vocab_size, (int(n),),
                                        dtype=np.int64))
                for i, n in enumerate(lens)]
        refs = {}
        log(f"serve: {arch}'s weights after "
            f"{time.perf_counter() - t_serve:.1f}s")
        for name, _, plan, kv, kind in (p for p in SERVE_PHASES
                                         if p[1] == arch):
            needs = ["flash_attn_fwd"] + \
                (["int8kv_decode"] if kv == "int8" else []) + \
                (["rmsnorm"] if cfg.norm == "rmsnorm" else [])
            tag = f"{'llama-' if arch != PLAN_ARCH else ''}{kind}-{kv}"
            if (kind, kv) not in refs:
                one = f"serve-one-{tag}"
                out[one.replace("-", "_")], refs[(kind, kv)] = serve_runs(
                    torch, np, ops, one, model, params, batch, reqs, kv,
                    kind, needs, card, L, max_len, cont_len, runs=1)
            ref = refs[(kind, kv)]
            t_phase = time.perf_counter()
            on = dict(plan=plan, mesh=mesh)
            if plan == "pipeshard":
                on.update(mesh=staged, stage_layers=SERVE_PIPE_SPLIT)
            if kind == "continuous":
                eng = ContinuousEngine(model, slots=CONT_SLOTS,
                                       max_len=cont_len, kv_dtype=kv, **on)
            else:
                eng = Engine(model, batch_size=ENGINE_BATCH,
                             max_len=max_len, kv_dtype=kv, **on)
            local = eng.shard_params(params)
            # the pipeshard phases run once, as the family phases do
            rec, tokens = serve_runs(torch, np, ops, name, model, local,
                                     batch, reqs, kv, kind, needs, card, L,
                                     max_len, cont_len, eng=eng,
                                     runs=1 if plan == "pipeshard"
                                     or name in SERVE_ONE_RUN
                                     else SERVE_RUNS)
            rec.update(compare_served(torch, steps, sharding, name, model,
                                      (params, local), batch, reqs, kv,
                                      kind, eng, ref, tokens))
            if name == "serve-shard":
                for what, e, p in (("serve-one-engine-fp32 (one device)",
                                    Engine(model, batch_size=ENGINE_BATCH,
                                           max_len=max_len), params),
                                   (name, eng, local)):
                    cache = e._init_cache(ENGINE_BATCH)
                    _, cache = steps.prefill_step(model, p, batch, cache,
                                                  plan=e.plan)
                    tok = torch.ones((ENGINE_BATCH, 1), dtype=torch.long,
                                     device="cuda")
                    prof = profile_window(
                        torch, lambda: steps.serve_step(
                            model, p, cache, tok, plan=e.plan), OUR_KERNELS)
                    log_profile(f"{what}, one decode step", prof)
                    rec.setdefault("profile_decode_step", {})[what] = prof
            out[name.replace("-", "_")] = rec
            log(f"{name}: {time.perf_counter() - t_phase:.1f}s with its "
                f"engine, comparison and trace")
            del eng, local
            torch.cuda.empty_cache()
        del model, params
        torch.cuda.empty_cache()
    log(f"serve phases in {time.perf_counter() - t_serve:.1f}s")
    return out


def serve_family_phases(torch, np, ops, card, mesh):
    """Phases ``serve-<tag>-shard`` and ``serve-<tag>-pipeshard``
    (``SERVE_FAMILIES``) in the process group of ``plan_phases``, each
    after the family's one-device yardstick ``serve-one-<tag>-engine-
    <kv>`` on the same weights and prompts, whose tokens it must give
    (``compare_served``).  Each family's model is built once; each phase
    must launch the family's kernels, kernel A once an attention layer a
    prefill and, with the int8 cache, B once an attention layer a decode
    step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import sharding
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.serve import steps

    out = {}
    t_all = time.perf_counter()
    staged = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1)
    max_len = ENGINE_PROMPT + ENGINE_GEN + 8
    for tag, arch, layers, kv, needs, split in SERVE_FAMILIES:
        t_family = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        # the layers with attention: every one, none, or the hybrid's
        # shared block at the head of each group
        attn = {"ssm": 0, "hybrid": cfg.n_layers // max(
            cfg.hybrid_attn_every, 1)}.get(cfg.family, cfg.n_layers)
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
        rng = np.random.default_rng(SEED + 11)
        batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                        (ENGINE_BATCH, ENGINE_PROMPT),
                                        dtype=np.int64)}
        log(f"serve-{tag}: {arch}, {cfg.n_layers} layers at full width, "
            f"{kv} cache, weights after "
            f"{time.perf_counter() - t_family:.1f}s")
        one = f"serve-one-{tag}-engine-{kv}"
        out[one.replace("-", "_")], ref = serve_runs(
            torch, np, ops, one, model, params, batch, [], kv, "engine",
            needs, card, attn, max_len, 0, runs=1)
        for plan, m, stage_layers in (("shard", mesh, None),
                                      ("pipeshard", staged, split)):
            name = f"serve-{tag}-{plan}"
            eng = Engine(model, batch_size=ENGINE_BATCH, max_len=max_len,
                         kv_dtype=kv, plan=plan, mesh=m,
                         stage_layers=stage_layers)
            local = eng.shard_params(params)
            rec, tokens = serve_runs(torch, np, ops, name, model, local,
                                     batch, [], kv, "engine", needs, card,
                                     attn, max_len, 0, eng=eng, runs=1)
            rec.update(compare_served(torch, steps, sharding, name, model,
                                      (params, local), batch, [], kv,
                                      "engine", eng, ref, tokens))
            out[name.replace("-", "_")] = rec
            del eng, local
            torch.cuda.empty_cache()
        log(f"serve-{tag}: {time.perf_counter() - t_family:.1f}s with its "
            f"weights, yardstick and comparisons")
        del model, params
        torch.cuda.empty_cache()
    log(f"serve family phases in {time.perf_counter() - t_all:.1f}s")
    return out


def serve_runs(torch, np, ops, name, model, params, batch, reqs, kv, kind,
               needs, card, L, max_len, cont_len, eng=None,
               runs=SERVE_RUNS):
    """Phase ``name``: ``runs`` runs of an engine (one device when ``eng``
    is None) with the launches of kernels A and B checked (``L``: the
    model's attention layers).  Returns the record (TTFT and tokens/s,
    their median and spread) and the first run's tokens."""
    from repro_torch.serve import ContinuousEngine, Engine

    if eng is None and kind == "continuous":
        eng = ContinuousEngine(model, slots=CONT_SLOTS, max_len=cont_len,
                               kv_dtype=kv)
    elif eng is None:
        eng = Engine(model, batch_size=ENGINE_BATCH, max_len=max_len,
                     kv_dtype=kv)
    if kind == "continuous":
        def once():
            return eng.run(params, reqs, max_new=CONT_GEN)
    else:
        def once():
            return eng.generate(params, batch, n_tokens=ENGINE_GEN)
    res, counts = run_phase(torch, ops, name,
                            lambda: [once() for _ in range(runs)], needs)
    if kind == "continuous":
        prefills = runs * CONT_REQUESTS
        steps_ = sum(len(r["stats"].occupancy) for r in res)
        ttft = [float(np.median(list(r["stats"].ttft_s.values())))
                for r in res]
        rate = [r["stats"].tokens_per_s for r in res]
        for r in reqs:
            check_tokens(np, res[0]["outputs"][r.uid], (CONT_GEN,),
                         model.cfg.vocab_size, f"{name} request {r.uid}")
        tokens = res[0]["outputs"]
    else:
        prefills, steps_ = runs, runs * (ENGINE_GEN - 1)
        ttft = [r["stats"].prefill_s for r in res]
        rate = [r["stats"].tokens_per_s for r in res]
        tokens = res[0]["tokens"]
        check_tokens(np, tokens, (ENGINE_BATCH, ENGINE_GEN),
                     model.cfg.vocab_size, name)
    want = {"flash_attn_fwd": L * prefills,
            "int8kv_decode": L * steps_ if kv == "int8" else 0}
    for kname, n in want.items():
        if counts[kname] != n:
            fail(f"phase {name}: {counts[kname]} {kname} launches, want {n}"
                 f" (L = {L} a prefill, and a decode step with int8 KV)")
    rec = {"runs": runs, "ttft_s": ttft, "tokens_per_s": rate,
           "ttft_median_s": float(np.median(ttft)),
           "ttft_spread_s": max(ttft) - min(ttft),
           "tokens_per_s_median": float(np.median(rate)),
           "tokens_per_s_spread": max(rate) - min(rate),
           "prefills": prefills, "decode_steps": steps_,
           "peak_bytes": PHASES[name]["peak_bytes"], "launches": counts}
    what = "TTFT p50 of the requests" if kind == "continuous" else "TTFT"
    log(f"{name}: {what} median {rec['ttft_median_s'] * 1e3:.2f} ms "
        f"(spread {rec['ttft_spread_s'] * 1e3:.2f} ms), decode "
        f"{rec['tokens_per_s_median']:.1f} tok/s median (spread "
        f"{rec['tokens_per_s_spread']:.1f}) over {runs} runs, peak "
        f"memory {rec['peak_bytes'] / 2**30:.2f} GiB, on {card}")
    return rec, tokens


def compare_served(torch, steps, sharding, name, model, params, batch,
                   reqs, kv, kind, eng, ref, tokens):
    """The gate of a serve phase: its tokens equal the one-device
    engine's, else the teacher-forced logits of prefill and every decode
    step within ``SERVE_LOGIT_RTOL`` of the largest (of the whole batch,
    or of each request that differs, served alone).  Where the tokens of
    an ``Engine`` phase are equal, its prefill and first decode step run
    once more beside one device (``first_steps``), to record whether
    their logits are bit-equal and the collectives of a decode step."""
    from repro_torch.serve.steps import ServePlan

    if kind == "continuous":
        differ = [r for r in reqs if not np_equal(tokens[r.uid],
                                                  ref[r.uid])]
    else:
        differ = [] if np_equal(tokens, ref) else [None]
    out = {"tokens_bit_equal": not differ,
           "compared": "teacher-forced logits" if differ else "tokens"}
    if kind == "engine":
        out["logits_first_steps_bit_equal"], coll = first_steps(
            torch, steps, sharding, model, params, batch, eng, ref, kv)
        out["logits_first_steps_bit_equal"] &= not differ
        out["collectives_a_decode_step"] = coll
        log(f"{name}: collectives a decode step: " + ", ".join(
            f"{k} {v['calls']:g} calls {v['bytes'] / 1e6:.3f} MB"
            for k, v in coll.items() if v["calls"]))
    cases = [(batch, ref, eng.plan)] if differ and kind == "engine" else []
    for r in differ if kind == "continuous" else ():
        sp = ServePlan(model, eng.plan.plan, eng.plan.mesh,
                       max_len=eng.max_len,
                       stage_layers=eng.plan.stage_layers)
        cases.append(({"tokens": r.prompt[None]}, ref[r.uid][None], sp))
    for b, toks, sp in cases:
        err, scale, _ = steps.teacher_forced(
            model, params[0], params[1], b, toks, sp, kv_dtype=kv)
        out.setdefault("teacher_forced", []).append(
            {"steps": toks.shape[1], "max_abs_err": err,
             "max_abs_logit": scale})
        if not err <= SERVE_LOGIT_RTOL * scale:
            fail(f"{name}: teacher-forced logits differ by {err} > "
                 f"{SERVE_LOGIT_RTOL} x {scale}")
    log(f"{name}: tokens bit-equal to one device: {out['tokens_bit_equal']}"
        f"; compared {out['compared']}; first steps' logits bit-equal: "
        f"{out.get('logits_first_steps_bit_equal')}")
    return out


def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def first_steps(torch, steps, sharding, model, params, batch, eng, ref, kv):
    """Prefill and one decode step of ``batch`` under ``eng``'s plan (with
    this rank's blocks ``params[1]`` of the full ``params[0]``) and on one
    device, the decode step fed the one-device engine's first tokens
    ``ref[:, :1]``.  Returns whether both steps' logits are bit-equal, and
    the collectives of the decode step under the plan
    (``sharding.collective_counts``, reset just before it)."""
    B = ref.shape[0]
    tok = torch.as_tensor(ref[:, :1], device="cuda")
    same, coll = True, None
    for p, sp in ((params[0], None), (params[1], eng.plan)):
        cache = model.init_cache(B, eng.max_len, kv_dtype=kv) if sp is None \
            else sp.init_cache(B, kv_dtype=kv)
        first, cache = steps.prefill_step(model, p, batch, cache, plan=sp)
        torch.cuda.synchronize()
        sharding.reset_collective_counts()
        second, _, _ = steps.serve_step(model, p, cache, tok, plan=sp)
        torch.cuda.synchronize()
        if sp is None:
            want = first, second
        else:
            coll = sharding.collective_counts()
            same = torch.equal(first, want[0]) and torch.equal(second,
                                                               want[1])
    return same, coll


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


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def elastic_phases(torch, np, ops, card, mesh):
    """Phases ``elastic-reshard-pipe``, ``elastic-reshard-flat`` and
    ``elastic-recover`` (see ``ELASTIC_STEPS``) in the process group of
    ``plan_phases``, ``mesh`` its flat mesh of one rank.  Each phase
    counts kernel A's launches: 2 L forward and L backward a microbatch
    of a step (remat).  Each prints the seconds and GB of every
    checkpoint write and restore, the step times before and after the
    reshard, and its peak memory."""
    import dataclasses
    import tempfile

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.costmodel import Workload
    from repro_torch.core.plans import Placement, get_plan
    from repro_torch.data import Loader, PackedDataset
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.launch.replan import build_cli_topology, recover
    from repro_torch.launch.reshard_check import (copy_to, host_state,
                                                  leaves_equal)
    from repro_torch.models import Model
    from repro_torch.train import reshard_checkpoint, reshard_state, train

    cfg = dataclasses.replace(get_config("gpt2m"), n_layers=ELASTIC_LAYERS)
    S, L, K = cfg.max_seq_len, cfg.n_layers, ELASTIC_STEPS
    rng = np.random.default_rng(SEED + 3)
    ds = PackedDataset(rng.integers(0, cfg.vocab_size,
                                    ((K + 2) * TRAIN_BATCH, S + 1))
                       .astype(np.int32), S)
    loader = Loader(ds, global_batch=TRAIN_BATCH, seed=SEED)
    tcfg = TrainConfig(microbatches=ELASTIC_MICRO)
    model = Model(cfg, device="cuda")
    needs = ["flash_attn_fwd", "flash_attn_bwd"]
    a_step = {"flash_attn_fwd": 2 * L, "flash_attn_bwd": L}
    staged = make_pipeline_mesh((1, 1, 1), ("pod", "data", "model"), 1,
                                stage_layers=ELASTIC_SPLIT,
                                schedule="interleaved")
    layouts = {"pipeshard": (staged, Placement(
        (0,), stage_layers=ELASTIC_SPLIT, schedule="interleaved"),
        ELASTIC_MICRO)}
    for flat in ("fsdp", "zero2", "data"):
        layouts[flat] = (mesh, Placement((0,)), 1)
    out = {}

    def expect(name, counts, steps):
        """steps: (plan, steps) of the phase's counted training."""
        for kname, n in a_step.items():
            want = sum(n * layouts[p][2] * k for p, k in steps)
            if counts[kname] != want:
                fail(f"phase {name}: {counts[kname]} {kname} launches, want "
                     f"{want}: {n} a microbatch of a step over {steps}")

    def train_on(plan, **kw):
        m, place, _ = layouts[plan]
        return train(model, tcfg, loader, log_every=0, plan=plan, mesh=m,
                     stage_layers=place.stage_layers,
                     schedule=place.schedule, **kw)

    def reshard(name, src, dst, ckpt_dir):
        def phase():
            res = train_on(src, steps=K, ckpt_dir=ckpt_dir,
                           params=model.init(torch.Generator(
                               device="cuda").manual_seed(SEED)))
            src_rec = {"losses": res.losses, "step_s": res.step_times,
                       "save_s": res.save_times}
            del res
            t0 = time.perf_counter()
            p_r, o_r, step0 = reshard_checkpoint(
                ckpt, model, get_plan(dst), layouts[dst][0],
                placement=layouts[dst][1])
            reshard_s = time.perf_counter() - t0
            after = train_on(dst, steps=K + 1, start_step=K,
                             params=copy_to(p_r, "cuda"),
                             opt_state=copy_to(o_r, "cuda"), sharded=True)
            return src_rec, p_r, o_r, step0, reshard_s, after

        ckpt = os.path.join(ckpt_dir, f"step_{K:08d}")
        (src_rec, p_r, o_r, step0, reshard_s, after), counts = run_phase(
            torch, ops, name, phase, needs)
        expect(name, counts, ((src, K), (dst, 1)))
        peak = PHASES[name]["peak_bytes"]
        gb = _dir_bytes(ckpt) / 1e9
        t0 = time.perf_counter()
        host = host_state(ckpt, model)
        read_s = time.perf_counter() - t0
        ref_p, ref_o = reshard_state(*host, get_plan(dst), cfg,
                                     layouts[dst][0],
                                     placement=layouts[dst][1],
                                     device="cuda")
        (p_ok, p_diff), (o_ok, o_diff) = leaves_equal(p_r, ref_p), \
            leaves_equal(o_r, ref_o)
        del p_r, o_r, ref_p, ref_o
        torch.cuda.empty_cache()
        control = train_on(dst, steps=K + 1, start_step=K,
                           params=copy_to(host[0], "cuda"),
                           opt_state=copy_to(host[1], "cuda"))
        rec = {"src": src, "dst": dst, "step": step0,
               "src_losses": src_rec["losses"],
               "step_s_before": src_rec["step_s"],
               "step_s_after": after.step_times,
               "loss_resharded": after.losses,
               "loss_control": control.losses,
               "params_bitexact": p_ok, "opt_bitexact": o_ok,
               "max_param_diff": p_diff, "max_opt_diff": o_diff,
               "ckpt_gb": gb, "write_s": src_rec["save_s"],
               "reshard_s": reshard_s, "host_read_s": read_s,
               "peak_bytes": peak, "launches": counts}
        log(f"{name}: {src} -> {dst} at step {step0}: params bit-exact "
            f"{p_ok} (max diff {p_diff}), moments {o_ok} ({o_diff}); loss "
            f"after {after.losses} vs control {control.losses}")
        log(f"{name}: checkpoint {gb:.3f} GB written in "
            f"{src_rec['save_s']} s (gather, write, sha256); restored onto "
            f"{dst} in {reshard_s:.2f} s (read, sha256, cut), host read "
            f"{read_s:.2f} s; step before {src_rec['step_s']} s, after "
            f"{after.step_times} s; peak memory {peak / 2**30:.2f} GiB, on "
            f"{card}")
        if not (p_ok and o_ok):
            fail(f"{name}: resharded state not bit-exact against "
                 f"reshard_state (params {p_diff}, moments {o_diff})")
        if after.losses != control.losses:
            fail(f"{name}: loss after the reshard {after.losses} != the "
                 f"control's {control.losses}")
        del control, after
        torch.cuda.empty_cache()
        return rec, host

    # the first phase's checkpoints, which elastic-recover resumes: a
    # TemporaryDirectory, so a failed check leaves no 4 GB behind
    with tempfile.TemporaryDirectory(prefix="elastic_pipe_") as keep:
        out["elastic_reshard_pipe"], host = reshard(
            "elastic-reshard-pipe", "pipeshard", "fsdp", keep)
        with tempfile.TemporaryDirectory() as flat_dir:
            out["elastic_reshard_flat"], _ = reshard(
                "elastic-reshard-flat", "zero2", "pipeshard", flat_dir)

        topo = build_cli_topology("full", ELASTIC_GPUS, 20.2, 3.0)
        wl = Workload(cfg, S, TRAIN_BATCH, steps_per_epoch=K + 2,
                      microbatches=ELASTIC_MICRO)
        run, counts = run_phase(
            torch, ops, "elastic-recover",
            lambda: recover(model, topo, ELASTIC_DEAD, wl, tcfg, loader,
                            ckpt_dir=keep, steps=K + 2, save=False,
                            log_fn=lambda m: log(f"  elastic-recover: {m}")),
            needs)
        rp = run.replan
        if (rp.technique, rp.sites_old) != ELASTIC_WINNER:
            fail(f"elastic-recover: the survivor search picked {rp.technique}@"
                 f"{rp.sites_old}, the reference {ELASTIC_WINNER}")
        expect("elastic-recover", counts, ((rp.technique, 2),))
        control = train_on(rp.technique, steps=K + 2, start_step=K,
                           params=copy_to(host[0], "cuda"),
                           opt_state=copy_to(host[1], "cuda"))
        out["elastic_recover"] = {
            "winner": f"{rp.technique}@{rp.sites_old}", "tflops": rp.tflops,
            "resumed_from": run.resumed_from, "search_s": run.search_s,
            "reshard_s": run.reshard_s, "recovery_s": run.recovery_s,
            "losses": run.result.losses, "loss_control": control.losses,
            "step_s": run.result.step_times,
            "peak_bytes": PHASES["elastic-recover"]["peak_bytes"],
            "launches": counts}
        log(f"elastic-recover: winner {rp.technique}@{rp.sites_old} "
            f"({rp.tflops:.2f} model-TFLOP/s) resumed from step "
            f"{run.resumed_from}; search_s {run.search_s:.4f}, reshard_s "
            f"{run.reshard_s:.2f}, recovery_s {run.recovery_s:.2f}; losses "
            f"{run.result.losses} vs control {control.losses}; steps "
            f"{run.result.step_times} s; peak memory "
            f"{PHASES['elastic-recover']['peak_bytes'] / 2**30:.2f} GiB, on "
            f"{card}")
        if run.resumed_from != K or run.result.losses != control.losses:
            fail(f"elastic-recover: resumed from {run.resumed_from}, losses "
                 f"{run.result.losses} vs the control's {control.losses}")
    del run, control, host, model
    torch.cuda.empty_cache()
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
# kernel 5's row-major library time, kernel B's time with its lse and
# SDPA's over the dequantized cache; and the training shape
EXTRAS = ("tflops", "x_library", "x_bound", "library_row_major_ms",
          "with_lse_ms", "sdpa_dequant_ms", "library_backend")
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
    # MLA's split head dims, q and k of nope + rope over v: minicpm3-4b
    # (96, 64) over 40 heads, deepseek-v2-236b (192, 128) over 128
    for arch in (MINICPM, DSV2):
        c = get_config(arch)
        rows, err = check_flash(
            torch, F, c.n_heads, c.n_kv_heads,
            c.mla.nope_head_dim + c.mla.rope_head_dim, MLA_FLASH_SHAPES,
            Dv=c.mla.v_head_dim)
        flash_rows, flash_err = flash_rows + rows, max(flash_err, err)
    # phi-3-vision's heads of 96 (MHA, 32 heads): kernel A at (96, 96)
    vcfg = get_config(VLM)
    rows, err = check_flash(torch, F, vcfg.n_heads, vcfg.n_kv_heads,
                            vcfg.head_dim, VLM_FLASH_SHAPES)
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
    # kernel B at phi-3-vision's head_dim 96
    rows, err = check_int8kv(torch, F, vcfg.n_heads, vcfg.n_kv_heads,
                             vcfg.head_dim, VLM_INT8_CASES, SEED + 13)
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
    # kernel A and its backward non-causal at Sq != Sk: whisper-small's
    # encoder and cross-attention
    cross_rows, err = check_flash(torch, F, *WHISPER_HEADS, WHISPER_FWD,
                                  causal=False)
    flash_err = max(flash_err, err)
    cross_bwd_rows, err = check_flash_bwd(torch, F, WHISPER_BWD,
                                          causal=False)
    bwd_err = max(bwd_err, err)
    stage("kernel A non-causal checks")

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
    mla, logits_mla = mla_phases(torch, np, ops, card)
    stage("MLA and phi4-mini serving, MLA training")
    logit_err.update(logits_mla)
    # kernel A's launches at each split head-dim pair, and at 128
    at_split = {
        "96x64": mla["mla_engine"]["launches"]["flash_attn_fwd"]
        + mla["mla_continuous"]["launches"]["flash_attn_fwd"],
        "192x128": mla["dsv2_engine"]["launches"]["flash_attn_fwd"]}
    for rec in mla.values():
        if isinstance(rec, dict) and "launches" in rec:
            add(rec["launches"])
    for k in at128:
        at128[k] += mla["phi4mini_engine"]["launches"][k]
    e2e.update(mla)
    whisper, logits_whisper = whisper_phases(torch, np, ops, card)
    stage("whisper-small serving and training")
    logit_err.update(logits_whisper)
    for key in ("whisper_engine", "train_whisper"):
        add(whisper[key]["launches"])
    add(whisper["whisper_parity_launches"])
    e2e.update(whisper)

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
    stage("gpt2L under the plans and the pipeline, serving under the "
          "plans, elasticity and the VLM")
    logit_err.update(plans.pop("vlm_logits"))
    vlm_info = plans.pop("vlm_info")
    for rec in plans.values():
        add(rec["launches"])
    # kernel A's launches at (96, 96) and B's at 96: the VLM's serving
    at96 = {k: sum(plans[p]["launches"][k] for p in (
        "vlm_engine", "vlm_int8", "serve_vlm_pipeshard"))
        for k in ("flash_attn_fwd", "int8kv_decode")}
    for key in ("serve_one_llama_engine_int8", "serve_llama_shard",
                "serve_one_moe_engine_int8", "serve_moe_shard",
                "serve_moe_pipeshard"):
        for k in at128:
            at128[k] += plans[key]["launches"][k]
    e2e.update(plans)
    e2e["dryrun_vs_card"] = dryrun_phase(torch, ops, card, training, plans)
    add(e2e["dryrun_vs_card"]["launches"])
    stage("the dry run against the card")
    e2e["vlm_params"] = vlm_info["params"]
    e2e["profile_vlm_int8"] = vlm_info["profile_vlm_int8"]
    log(f"all phases in {time.perf_counter() - t_start:.1f}s")

    def pick(rows, at):
        return next(r for r in rows if all(r[k] == v for k, v in at.items()))

    def summary(rows, at):
        """A kernel's numbers at one shape (with kernel A's rates)."""
        row = pick(rows, at)
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") + EXTRAS
        return {k: row[k] for k in keys if k in row} | {"at": at}

    def at_head_dim(rows, at, launches, at_96, launches_96):
        """The row of a kernel at head_dim 128 and its launches in the
        phases at that head dim (llama3.2, phi3.5-MoE, phi4-mini), and
        at 96 (phi-3-vision)."""
        return {"128": summary(rows, at) | {"launches": launches},
                "96": summary(rows, at_96) | {"launches": launches_96}}

    def noncausal(rows):
        """Kernel A's (or its backward's) non-causal rows, each with its
        shape."""
        keys = ("B", "Sq", "Sk", "H", "KV", "D", "max_abs_err",
                "lse_max_abs_err", "o32_max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms") + EXTRAS
        return [{k: r[k] for k in keys if k in r} for r in rows]

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
                  at128["flash_attn_fwd"],
                  {"B": ENGINE_BATCH, "S": VLM_PATCHES + ENGINE_PROMPT,
                   "D": 96, "Dv": 96}, at96["flash_attn_fwd"]) | {
                  f"{dk}x{dv}": summary(
                      flash_rows, {"B": 8, "S": 64, "D": dk, "Dv": dv})
                  | {"launches": at_split[f"{dk}x{dv}"]}
                  for dk, dv in ((96, 64), (192, 128))},
              noncausal=noncausal(cross_rows),
              whisper_launches=sum(
                  whisper[key]["launches"]["flash_attn_fwd"]
                  for key in ("whisper_engine", "train_whisper"))
              + whisper["whisper_parity_launches"]["flash_attn_fwd"]),
        entry("flash_attn_bwd", "src/repro_torch/csrc/flash_attn_bwd.cu",
              "src/repro/kernels/flash_attention.py:77", bwd_rows, bwd_err,
              TRAIN_AT, differentiates="src/repro/models/attention.py:36",
              noncausal=noncausal(cross_bwd_rows),
              whisper_launches=whisper["train_whisper"]["launches"][
                  "flash_attn_bwd"]
              + whisper["whisper_parity_launches"]["flash_attn_bwd"]),
        entry("int8kv_decode", "src/repro_torch/csrc/int8kv_attn.cu",
              "src/repro/kernels/quantized.py:145", int8_rows, int8_err,
              {"B": 8, "Sk": 1024, "D": 64,
               "live_keys": int8_rows[1]["live_keys"]},
              by_head_dim=at_head_dim(
                  int8_rows, {"B": 8, "Sk": 1024, "H": 24, "D": 128},
                  at128["int8kv_decode"],
                  {"B": ENGINE_BATCH, "Sk": VLM_LEN, "D": 96,
                   "fills": VLM_INT8_CASES[0][2]}, at96["int8kv_decode"]),
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
              mla_widths={d: summary(rms_rows, {"rows": 512, "d": d,
                                                "dtype": "bfloat16"})
                          for d in RMS_MLA_DS},
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
                       "flash_attn_fwd_noncausal": cross_rows,
                       "flash_attn_bwd_noncausal": cross_bwd_rows,
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
