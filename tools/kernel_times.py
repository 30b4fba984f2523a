#!/usr/bin/env python
"""Time a group of the PyTorch port's hand-written kernels on one NVIDIA
card, through the public wrappers of whichever ``repro_torch`` it is
pointed at, so that two versions of the port compare on one card:

    python tools/kernel_times.py --group GROUP --label NAME --out FILE
                                 [--src DIR] [--sweep] [--no-trace]
    python tools/kernel_times.py --compare FILE [FILE ...]

GROUP is ``decode`` (kernel B, int8-KV decode attention, and kernel 6,
RMSNorm), ``scan`` (kernel 3, the SSD chunked scan, and kernel 4, the
Mamba1 selective scan) or ``int8mm`` (kernel 5, the blocked int8
matmul).  ``--src`` is the ``src`` directory of a checkout
(default: this one's); its wrappers build its own kernels into that
checkout's ``build/``.  To compare a commit with the one before it,
unpack the parent into a directory that git ignores and run the two in
turns, each in a process of its own (parent, change, change, parent),
then compare:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python tools/kernel_times.py --group scan --src build/parent/src \\
        --label parent --out build/kt/parent-1.json
    ...
    python tools/kernel_times.py --compare build/kt/*.json

A run records, each printed as it goes:
  * every shape ``chip_smoke.py`` holds the group's kernels at (and 1 and
    33 RMSNorm rows): the device time of one call (``chip_smoke.time_ms``:
    CUDA events, cold L2), beside chip_smoke's bound for the scans and
    kernel 5, each result first held to its plain version (the scans
    within the scan tolerance, kernel 5 within ``INT8MM_RTOL``, and a
    rerun to the same bits); for ``decode`` a minimal launch timed the
    same way; for ``int8mm`` also ``torch._int_mm`` on the same int8
    operands, w row-major and column-major, and ``wq.t().contiguous()``;
  * with ``--sweep``, each choice of the group's planners forced: kernel
    B cut into 1 to 32 splits of whole tiles; kernel 3's one or two
    stages, kernel 4's lanes a channel; kernel 5 at 4096^3 with blocks
    of 32, 64, 96 and 128 (as many promotions as M N K / block);
  * unless ``--no-trace``, the group's models at full size (random
    weights, seed 0) under ``torch.profiler`` (each kernel's device ms
    and share of the busy time): for ``decode`` a llama3.2-3b ``Engine``
    generate of 8 tokens with an int8 KV cache, and greedy decodes of 16
    tokens by the kernel and the plain paths (``use_kernels=False``),
    keeping each step's tokens and the gap between its two largest
    logits; for ``scan`` one ``Engine`` prefill (8 prompts of 64 tokens)
    of falcon-mamba-7b and one of zamba2-2.7b; for ``int8mm`` one
    ``ops.int8_matmul`` (pad, quantize, kernel 5) at 1024^3 and 4096^3,
    blocks of 64, as the calibration micro-bench calls it.
``--compare`` prints each shape's mean time per label and whether every
run gave the same bits there, each traced kernel's device time, and
where two greedy decodes first part (kernel against plain path in every
run, and each label's kernel path against the others').
"""
import argparse
import contextlib
import hashlib
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RMS_EXTRA_ROWS = (1, 33)
DECODE_TOKENS = 16
# --sweep of kernel B: this many splits (of whole tiles) at the engines'
# caches and 1024 slots, rows partly or fully filled
FORCED_SPLITS = (1, 2, 3, 4, 5, 8, 16, 32)
FORCED_CASES = ((104, (65, 96)), (296, (17, 288)), (1024, (17, 290)),
                (1024, (1024, 1024)))


@contextlib.contextmanager
def forced(module, name, plan):
    """``module.name`` (a planner) replaced by ``plan`` for the block."""
    keep = getattr(module, name)
    setattr(module, name, plan)
    try:
        yield
    finally:
        setattr(module, name, keep)


def close_to(torch, smoke, want):
    """A check: the result within chip_smoke's ``KERNEL_ATOL`` of
    ``want``."""
    def check(fn):
        got = fn()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        return None if err <= smoke.KERNEL_ATOL else \
            f"{err} from the plain version"
    return check


def scan_held(torch, smoke, plain):
    """A check: (y, h) within the scan tolerance of ``plain``, and a
    rerun giving the same bits."""
    def check(fn):
        y, h = fn()
        y2, h2 = fn()
        torch.cuda.synchronize()
        rel = max(smoke.scan_err(torch, y, plain[0]),
                  smoke.scan_err(torch, h, plain[1]))
        if not rel <= 1.0:
            return f"{rel:.3g} x the scan tolerance from the plain version"
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            return "a rerun gave other bits"
        return None
    return check


def digest(torch, out) -> str:
    """sha256 of the bytes of a result (a tensor or a tuple of them)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def time_cases(torch, smoke, cases, suffix=""):
    """Rows {key, ms, bound_ms, digest} of ``(key, fn, check, bound_ms)``
    cases, each checked before it is timed; ``digest`` is the result's
    bits, so that ``--compare`` tells whether two trees agree bit for
    bit."""
    rows = []
    for key, fn, check, bound_ms in cases:
        key += suffix
        bad = check(fn)
        if bad:
            raise SystemExit(f"{key}: {bad}")
        bits = digest(torch, fn())
        ms = smoke.time_ms(torch, fn)
        tail = f" (bound {bound_ms:.5f}, {ms / bound_ms:.2f}x)" \
            if bound_ms else ""
        print(f"{key}: {ms:.4f} ms{tail}", flush=True)
        rows.append({"key": key, "ms": ms, "bound_ms": bound_ms,
                     "digest": bits})
    return rows


# ------------------------------------------------------------------ #
# decode: kernels B and 6

def decode_configs(smoke):
    from repro_torch.configs import get_config
    return [get_config(a) for a in ("gpt2m", smoke.LLAMA, smoke.MOE)]


def int8kv_case(torch, smoke, qz, g, H, KV, D, B, Sk, fills):
    q = torch.randn((B, 1, H, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    kq, ks = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device="cuda"), block=D)
    vq, vs = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device="cuda"), block=D)
    a = (q, kq, ks[..., 0].contiguous(), vq, vs[..., 0].contiguous(),
         smoke.decode_mask(torch, g, B, Sk, fills))
    return (lambda: qz.int8kv_attention_cuda(*a),
            close_to(torch, smoke, qz.int8kv_attention_plain(*a)))


def decode_cases(torch, smoke):
    from repro_torch.kernels import quantized as qz
    from repro_torch.kernels import rmsnorm as rn

    gpt, llama, moe = decode_configs(smoke)
    shapes = [(gpt.n_heads, gpt.n_kv_heads, gpt.head_dim, *c) for c in (
        (8, 104, (65, 96)), (8, 1024, (17, 290)), (8, 1024, (1, 1024)),
        (8, 1024, "mixed"))]
    for c in (llama, moe):
        shapes += [(c.n_heads, c.n_kv_heads, c.head_dim, *x) for x in (
            (8, 1024, (17, 290)), (8, 104, (65, 96)), (8, 296, (17, 288)),
            (8, 296, "mixed"))]
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    out = []
    for H, KV, D, B, Sk, fills in shapes:
        out.append((f"int8kv H={H} KV={KV} D={D} B={B} Sk={Sk} "
                    f"fills={fills}",
                    *int8kv_case(torch, smoke, qz, g, H, KV, D, B, Sk,
                                 fills), None))
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 8)
    for dtype in (torch.bfloat16, torch.float32):
        for d in smoke.RMS_DS:
            for n in RMS_EXTRA_ROWS + smoke.RMS_ROWS:
                x = (torch.randn((n, d), generator=g, device="cuda") * 3
                     + 0.5).to(dtype)
                w = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
                if d > rn.MAX_D:     # a tree whose rows are narrower
                    continue         # (its inputs drawn all the same)
                out.append((f"rmsnorm {str(dtype)[6:]} rows={n} d={d}",
                            lambda x=x, w=w: rn.rmsnorm_cuda(x, w),
                            close_to(torch, smoke, rn.rmsnorm_plain(x, w)),
                            None))
    return out


def decode_times(torch, smoke):
    rows = time_cases(torch, smoke, decode_cases(torch, smoke))
    floor = smoke.launch_floor_ms(torch)
    print(f"minimal launch: {floor:.4f} ms", flush=True)
    return rows + [{"key": "minimal launch", "ms": floor, "bound_ms": None}]


def decode_sweep(torch, smoke):
    """Kernel B's split count forced through its planner
    (``int8kv_splits``): what a tile costs, and where the planner's
    split should fall, at the engines' caches."""
    from repro_torch.kernels import quantized as qz

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 9)
    gpt, llama, _ = decode_configs(smoke)

    def splits(n):
        def plan(B_, KV_, Sk_, n_sm_):
            tiles = -(-Sk_ // qz.KEY_TILE)
            per = -(-tiles // min(n, tiles))
            return -(-tiles // per), per * qz.KEY_TILE
        return plan

    rows = []
    for c in llama, gpt:
        for Sk, fills in FORCED_CASES:
            fn, check = int8kv_case(torch, smoke, qz, g, c.n_heads,
                                    c.n_kv_heads, c.head_dim, 8, Sk, fills)
            done = set()
            for n in FORCED_SPLITS:
                plan = splits(n)(8, c.n_kv_heads, Sk, n_sm)
                if plan in done:
                    continue
                done.add(plan)
                with forced(qz, "int8kv_splits", splits(n)):
                    rows += time_cases(torch, smoke, [(
                        f"int8kv D={c.head_dim} Sk={Sk} fills={fills} "
                        f"splits={plan}", fn, check, None)])
    return rows


def greedy(torch, model, params, batch, steps):
    """Greedy int8-KV decode: per step the tokens [B] and the gap
    between each row's two largest logits."""
    from repro_torch.serve.steps import prefill_step, serve_step

    with torch.no_grad():
        cache = model.init_cache(batch["tokens"].shape[0],
                                 batch["tokens"].shape[1] + steps + 8,
                                 kv_dtype="int8")
        logits, cache = prefill_step(model, params, batch, cache)
        toks, gaps = [], []
        for i in range(steps):
            top = torch.topk(logits.float(), 2, dim=-1).values
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok[:, 0].tolist())
            gaps.append((top[:, 0] - top[:, 1]).tolist())
            if i + 1 < steps:
                logits, _, cache = serve_step(model, params, cache, tok)
    return {"tokens": toks, "gaps": gaps}


def decode_traces(torch, np, smoke):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = get_config(smoke.LLAMA)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(smoke.SEED))
    rng = np.random.default_rng(smoke.SEED + 5)
    batch = {"tokens": rng.integers(4, cfg.vocab_size,
                                    (smoke.ENGINE_BATCH, smoke.ENGINE_PROMPT),
                                    dtype=np.int64)}
    eng = Engine(model, batch_size=smoke.ENGINE_BATCH,
                 max_len=smoke.ENGINE_PROMPT + smoke.ENGINE_GEN + 8,
                 kv_dtype="int8")
    eng.generate(params, batch, n_tokens=8, timing=False)     # warm
    name = "llama3.2-3b int8 generate, 8 tokens"
    prof = smoke.profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8, timing=False),
        smoke.OUR_KERNELS)
    smoke.log_profile(name, prof)
    return {"traces": {name: prof},
            "decodes": {
                "kernels": greedy(torch, model, params, batch, DECODE_TOKENS),
                "plain": greedy(torch, Model(cfg, device="cuda",
                                             use_kernels=False),
                                params, batch, DECODE_TOKENS)}}


# ------------------------------------------------------------------ #
# scan: kernels 3 and 4

def scan_cases(torch, smoke):
    """Every shape ``chip_smoke.py`` holds the scans at
    (``MAMBA1_CASES``, ``SSD_CASES``), with its inputs and its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as ms

    fcfg, zcfg = (get_config(a) for a in ("falcon-mamba-7b", "zamba2-2.7b"))
    sfu = smoke.SFU_PER_SM_CLK * smoke.sm_clock_hz() * \
        torch.cuda.get_device_properties(0).multi_processor_count
    di, ds = fcfg.ssm.expand * fcfg.d_model, fcfg.ssm.d_state
    out = []
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 2)
    for B, S in smoke.MAMBA1_CASES:
        a = smoke.mamba1_inputs(torch, fcfg, g, B, S)
        out.append((f"mamba1_scan B={B} S={S}",
                    lambda a=a: ms.mamba1_scan_cuda(*a),
                    scan_held(torch, smoke, ms.mamba1_scan_plain(*a)),
                    smoke.mamba1_bound(B, S, di, ds, sfu)[0]))
    s = zcfg.ssm
    nh = s.expand * zcfg.d_model // s.head_dim
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 3)
    for B, S, dt_scale in smoke.SSD_CASES:
        a = smoke.ssd_inputs(torch, zcfg, g, B, S, dt_scale)
        out.append((f"ssd_scan B={B} S={S} dt_scale={dt_scale}",
                    lambda a=a: ms.ssd_scan_cuda(*a, chunk=s.chunk),
                    scan_held(torch, smoke, ms.ssd_scan_plain(*a)),
                    smoke.ssd_bound(B, S, nh, s.head_dim, s.d_state,
                                    s.chunk, sfu)[0]))
    return out


def scan_times(torch, smoke):
    return time_cases(torch, smoke, scan_cases(torch, smoke))


def scan_sweep(torch, smoke):
    """Kernel 3's stages and kernel 4's lanes a channel forced through
    their planners (``ssd_plan``, ``mamba1_plan``) at every shape."""
    from repro_torch.kernels import mamba_scan as ms

    if not hasattr(ms, "ssd_plan"):
        raise SystemExit("--sweep needs a checkout with ssd_plan and "
                         "mamba1_plan")
    cases = scan_cases(torch, smoke)
    rows = []
    for name, plans, what in (("ssd_plan", (1, 2), "stages"),
                              ("mamba1_plan", ms.MAMBA1_LANES, "lanes")):
        kern = name[:-len("_plan")]
        mine = [c for c in cases if c[0].startswith(kern + "_scan")]
        for p in plans:
            with forced(ms, name, lambda *_, p=p: p):
                rows += time_cases(torch, smoke, mine,
                                   f" forced {what}={p}")
    return rows


def scan_traces(torch, np, smoke):
    """One traced Engine-shaped prefill (8 prompts of 64 tokens) of each
    SSM-family model at full size."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    traces = {}
    for _, arch, _ in smoke.SSM_MODELS:
        cfg = get_config(arch)
        model = Model(cfg, device="cuda")
        params = model.init(
            torch.Generator(device="cuda").manual_seed(smoke.SEED))
        rng = np.random.default_rng(smoke.SEED)
        batch = {"tokens": rng.integers(
            4, cfg.vocab_size, (smoke.ENGINE_BATCH, smoke.ENGINE_PROMPT),
            dtype=np.int64)}

        def prefill():
            with torch.no_grad():
                cache = model.init_cache(smoke.ENGINE_BATCH,
                                         smoke.ENGINE_PROMPT + 8)
                return model.prefill(params, batch, cache)

        prefill()                                  # warm
        name = f"{arch} Engine prefill"
        traces[name] = smoke.profile_window(torch, prefill, smoke.OUR_KERNELS)
        smoke.log_profile(name, traces[name])
        del model, params
        torch.cuda.empty_cache()
    return {"traces": traces}


# ------------------------------------------------------------------ #
# int8mm: kernel 5

def int8mm_held(torch, smoke, want):
    """A check: the result within ``INT8MM_RTOL`` of the largest plain
    output from ``want``, and a rerun giving the same bits."""
    def check(fn):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= smoke.INT8MM_RTOL * float(want.abs().max()):
            return f"{err} from the plain version"
        return None if torch.equal(got, again) else "a rerun gave other bits"
    return check


def int8mm_cases(torch, smoke, shapes):
    """Each (M, K, N, block) of ``shapes``, on operands made as
    ``chip_smoke.py`` makes them: kernel 5 with its bound,
    ``torch._int_mm`` on the same int8 operands (no per-tile scales)
    with w row-major and column-major, and PyTorch's transpose of wq
    (what kernel 5's phase 1 does instead)."""
    from repro_torch.kernels import quantized as qz
    from repro_torch.kernels.ops import int8_operands

    sm_hz = smoke.sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 5)
    out = []
    for M, K, N, blk in shapes:
        x = torch.randn((M, K), generator=g, device="cuda")
        w = torch.randn((K, N), generator=g, device="cuda")
        blocks = dict(block_m=blk, block_k=blk, block_n=blk)
        a = int8_operands(x, w, **blocks)
        xq, xs, wq, ws = a
        w_cols = wq.t().contiguous().t()
        bound_ms = smoke.int8mm_bound(*xq.shape, wq.shape[1], blk,
                                      xs.numel() + ws.numel(), sm_hz,
                                      n_sm)[0]
        key = f"{M}x{K}x{N} block {blk}"
        out += [(f"int8_matmul {key}",
                 lambda a=a, b=blocks: qz.int8_matmul_cuda(*a, **b),
                 int8mm_held(torch, smoke,
                             qz.int8_matmul_plain(*a, **blocks)),
                 bound_ms),
                (f"torch._int_mm {key}, w row-major",
                 lambda xq=xq, wq=wq: torch._int_mm(xq, wq),
                 lambda fn: None, None),
                (f"torch._int_mm {key}, w column-major",
                 lambda xq=xq, wc=w_cols: torch._int_mm(xq, wc),
                 lambda fn: None, None),
                (f"wq.t().contiguous() {key}",
                 lambda wq=wq: wq.t().contiguous(), lambda fn: None, None)]
    return out


def int8mm_times(torch, smoke):
    return time_cases(torch, smoke,
                      int8mm_cases(torch, smoke, smoke.INT8MM_SHAPES))


def int8mm_sweep(torch, smoke):
    """Kernel 5 has one tile shape; its promotions number M N K / block,
    so 4096^3 at each block size shows what they cost."""
    return time_cases(torch, smoke, [c for c in int8mm_cases(
        torch, smoke, [(4096, 4096, 4096, b) for b in (32, 64, 96, 128)])
        if c[0].startswith("int8_matmul")], " (sweep)")


def int8mm_traces(torch, np, smoke):
    """One traced ``ops.int8_matmul`` (pad, quantize both operands,
    kernel 5) at 1024^3 and 4096^3, blocks of 64, as the calibration
    micro-bench calls it."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 6)
    traces = {}
    for m in (1024, 4096):
        x = torch.randn((m, m), generator=g, device="cuda")
        w = torch.randn((m, m), generator=g, device="cuda")

        def call():
            return ops.int8_matmul(x, w, block_m=64, block_k=64,
                                   block_n=64)

        call()                                     # warm
        name = f"ops.int8_matmul {m}^3 blocks 64"
        traces[name] = smoke.profile_window(torch, call, smoke.OUR_KERNELS)
        smoke.log_profile(name, traces[name])
    return {"traces": traces}


GROUPS = {"decode": (decode_times, decode_sweep, decode_traces),
          "scan": (scan_times, scan_sweep, scan_traces),
          "int8mm": (int8mm_times, int8mm_sweep, int8mm_traces)}


def run(args) -> None:
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA card")

    import chip_smoke as smoke
    import repro_torch

    # the plain versions' matmuls in fp32, as chip_smoke.py holds them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"{card}; {args.label}: {os.path.dirname(repro_torch.__file__)}",
          flush=True)
    times, sweep, traces = GROUPS[args.group]
    res = {"label": args.label, "group": args.group, "card": card,
           "times": times(torch, smoke)}
    if args.sweep:
        res["sweep"] = sweep(torch, smoke)
    if not args.no_trace:
        res.update(traces(torch, np, smoke))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


def first_part(a, b):
    """(step, row, gap in a, gap in b) where two greedy decodes first
    give other tokens, or None."""
    for s, (ta, tb) in enumerate(zip(a["tokens"], b["tokens"])):
        for r, (x, y) in enumerate(zip(ta, tb)):
            if x != y:
                return s, r, a["gaps"][s][r], b["gaps"][s][r]
    return None


def say_part(what, p):
    if p is None:
        print(f"{what}: the same tokens at every step")
    else:
        print(f"{what}: first other token at step {p[0]}, row {p[1]}; gap "
              f"between the two largest logits there {p[2]:.4f} and "
              f"{p[3]:.4f}")


def compare(paths) -> None:
    runs = [json.load(open(p)) for p in paths]
    labels = list(dict.fromkeys(r["label"] for r in runs))
    print(runs[0]["card"])
    for part in ("times", "sweep"):
        ms, bounds = defaultdict(lambda: defaultdict(list)), {}
        bits = defaultdict(set)
        for r in runs:
            for row in r.get(part, ()):
                ms[row["key"]][r["label"]].append(row["ms"])
                bounds[row["key"]] = row.get("bound_ms")
                if row.get("digest"):
                    bits[row["key"]].add(row["digest"])
        for key, by in ms.items():
            cells = "  ".join(
                f"{lab} {sum(by[lab]) / len(by[lab]):.4f}" for lab in labels
                if by.get(lab))
            tail = f" (bound {bounds[key]:.5f})" if bounds[key] else ""
            same = "" if not bits[key] else "; the same bits in every run" \
                if len(bits[key]) == 1 else \
                f"; {len(bits[key])} different results"
            print(f"{key}: {cells} ms{tail}{same}")
    for lab in labels:
        for r in (r for r in runs if r["label"] == lab):
            for name, prof in (r.get("traces") or {}).items():
                if not prof:
                    print(f"{lab} {name}: no device events")
                    continue
                for kern, k in sorted(prof["per_kernel"].items()):
                    print(f"{lab} {name}, {kern}: {k['us'] / 1e3:.3f} ms in "
                          f"{k['count']} launches, share {k['share']:.4f} "
                          f"of {prof['device_busy_us'] / 1e3:.3f} ms busy")
                print(f"{lab} {name}: idle share {prof['idle_share']:.3f}")
            if "decodes" in r:
                say_part(f"{lab} kernel path against plain path",
                         first_part(r["decodes"]["kernels"],
                                    r["decodes"]["plain"]))
    decoded = {r["label"]: r["decodes"] for r in runs if "decodes" in r}
    names = list(decoded)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            say_part(f"{a} kernel path against {b} kernel path",
                     first_part(decoded[a]["kernels"],
                                decoded[b]["kernels"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", choices=sorted(GROUPS),
                    help="the kernels to time")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--label", help="this run's name in --compare")
    ap.add_argument("--out", help="write the run here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="also force each choice of the group's planners")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the traced runs of the full models")
    ap.add_argument("--compare", nargs="+", metavar="FILE",
                    help="print runs written by --out side by side")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
    elif args.group and args.label and args.out:
        run(args)
    else:
        ap.error("give --group, --label and --out, or --compare")


if __name__ == "__main__":
    main()
