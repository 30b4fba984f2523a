#!/usr/bin/env python
"""Time the decode step's two hand-written kernels of the PyTorch port,
kernel B (int8-KV decode attention) and kernel 6 (RMSNorm), on one
NVIDIA card, through the public wrappers of whichever ``repro_torch``
it is pointed at, so that two versions of the port compare on one card:

    python tools/decode_kernels.py --label NAME --out FILE [--src DIR]
                                   [--sweep]
    python tools/decode_kernels.py --compare FILE [FILE ...]

``--src`` is the ``src`` directory of a checkout (default: this one's);
its wrappers build its own kernels into that checkout's ``build/``.  To
compare a commit with the one before it, unpack the parent into a
directory that git ignores and run the two in turns, each in a process
of its own (parent, change, change, parent), then compare:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python tools/decode_kernels.py --src build/parent/src --label parent \\
        --out build/dk/parent-1.json
    ...
    python tools/decode_kernels.py --compare build/dk/*.json

A run records, each printed as it goes:
  * every shape ``chip_smoke.py`` holds the two kernels at (plus 1 and
    33 RMSNorm rows): the device time of one call (``chip_smoke.time_ms``:
    CUDA events, cold L2), each result first held to its plain version;
    and a minimal launch timed the same way;
  * llama3.2-3b at full size (random weights, seed 0) decoding with an
    int8 KV cache: a traced ``Engine`` generate of 8 tokens
    (``torch.profiler``: each kernel's device ms and share of the busy
    time), and a greedy decode of 16 tokens by the kernel path and by
    the plain path (``use_kernels=False``), keeping each step's tokens
    and the gap between its two largest logits;
  * with ``--sweep``, kernel B's current planner forced to cut Sk into
    1 to 32 splits of whole tiles.
``--compare`` prints each shape's mean time per label, and where two
greedy decodes first part (kernel against plain path in every run, and
each label's kernel path against the others'), the step, the row and
the gap between the two largest logits there.
"""
import argparse
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RMS_EXTRA_ROWS = (1, 33)
DECODE_TOKENS = 16
# --sweep: kernel B cut into this many splits (of whole tiles) at the
# engines' caches and 1024 slots, rows partly or fully filled
FORCED_SPLITS = (1, 2, 3, 4, 5, 8, 16, 32)
FORCED_CASES = ((104, (65, 96)), (296, (17, 288)), (1024, (17, 290)),
                (1024, (1024, 1024)))


def int8kv_cases(cfgs):
    """(H, KV, D, B, Sk, fills) as chip_smoke.py's kernel checks."""
    gpt, llama, moe = cfgs
    out = [(gpt.n_heads, gpt.n_kv_heads, gpt.head_dim, *c) for c in (
        (8, 104, (65, 96)), (8, 1024, (17, 290)), (8, 1024, (1, 1024)),
        (8, 1024, "mixed"))]
    for c in (llama, moe):
        out += [(c.n_heads, c.n_kv_heads, c.head_dim, *x) for x in (
            (8, 1024, (17, 290)), (8, 104, (65, 96)), (8, 296, (17, 288)),
            (8, 296, "mixed"))]
    return out


def int8kv_inputs(torch, qz, smoke, g, H, KV, D, B, Sk, fills):
    q = torch.randn((B, 1, H, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    kq, ks = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device="cuda"), block=D)
    vq, vs = qz.quantize(torch.randn((B, Sk, KV, D), generator=g,
                                     device="cuda"), block=D)
    valid = smoke.decode_mask(torch, g, B, Sk, fills)
    return (q, kq, ks[..., 0].contiguous(), vq, vs[..., 0].contiguous(),
            valid)


def timed(torch, smoke, fn, want, what):
    """``fn``'s device time, after holding its result to ``want``."""
    got = fn()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= smoke.KERNEL_ATOL:
        raise SystemExit(f"{what}: {err} from the plain version")
    ms = smoke.time_ms(torch, fn)
    print(f"{what}: {ms:.4f} ms, err {err:.3e}", flush=True)
    return ms


def time_kernels(torch, smoke, qz, rn, cfgs):
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    rows = []
    for H, KV, D, B, Sk, fills in int8kv_cases(cfgs):
        a = int8kv_inputs(torch, qz, smoke, g, H, KV, D, B, Sk, fills)
        key = f"int8kv H={H} KV={KV} D={D} B={B} Sk={Sk} fills={fills}"
        rows.append({"key": key, "ms": timed(
            torch, smoke, lambda: qz.int8kv_attention_cuda(*a),
            qz.int8kv_attention_plain(*a), key)})
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 8)
    for dtype in (torch.bfloat16, torch.float32):
        for d in smoke.RMS_DS:
            for n in RMS_EXTRA_ROWS + smoke.RMS_ROWS:
                x = (torch.randn((n, d), generator=g, device="cuda") * 3
                     + 0.5).to(dtype)
                w = 1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
                key = f"rmsnorm {str(dtype)[6:]} rows={n} d={d}"
                rows.append({"key": key, "ms": timed(
                    torch, smoke, lambda: rn.rmsnorm_cuda(x, w),
                    rn.rmsnorm_plain(x, w), key)})
    floor = smoke.launch_floor_ms(torch)
    print(f"minimal launch: {floor:.4f} ms", flush=True)
    rows.append({"key": "minimal launch", "ms": floor})
    return rows


def sweep(torch, smoke, qz, cfgs):
    """Kernel B's split count forced through its planner
    (``int8kv_splits``): what a tile costs, and where the planner's
    split should fall, at the engines' caches."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED + 9)
    keep, rows = qz.int8kv_splits, []

    def forced(n):
        def plan(B_, KV_, Sk_, n_sm_):
            tiles = -(-Sk_ // qz.KEY_TILE)
            per = -(-tiles // min(n, tiles))
            return -(-tiles // per), per * qz.KEY_TILE
        return plan

    try:
        for c in cfgs[1], cfgs[0]:
            for Sk, fills in FORCED_CASES:
                a = int8kv_inputs(torch, qz, smoke, g, c.n_heads,
                                  c.n_kv_heads, c.head_dim, 8, Sk, fills)
                want, done = qz.int8kv_attention_plain(*a), set()
                for n in FORCED_SPLITS:
                    qz.int8kv_splits = forced(n)
                    plan = qz.int8kv_splits(8, c.n_kv_heads, Sk, n_sm)
                    if plan not in done:
                        done.add(plan)
                        key = (f"int8kv D={c.head_dim} Sk={Sk} "
                               f"fills={fills} splits={plan}")
                        rows.append({"key": key, "ms": timed(
                            torch, smoke,
                            lambda: qz.int8kv_attention_cuda(*a), want,
                            key)})
    finally:
        qz.int8kv_splits = keep
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


def decode(torch, np, smoke):
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
    prof = smoke.profile_window(
        torch, lambda: eng.generate(params, batch, n_tokens=8, timing=False),
        smoke.OUR_KERNELS)
    smoke.log_profile("llama3.2-3b int8 generate, 8 tokens", prof)
    return {"profile": prof,
            "kernels": greedy(torch, model, params, batch, DECODE_TOKENS),
            "plain": greedy(torch, Model(cfg, device="cuda",
                                         use_kernels=False),
                            params, batch, DECODE_TOKENS)}


def run(args) -> None:
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_kernels: needs an NVIDIA card")

    import chip_smoke as smoke
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quantized as qz
    from repro_torch.kernels import rmsnorm as rn

    card = smoke.card_line()
    print(f"{card}; {args.label}: {os.path.dirname(repro_torch.__file__)}",
          flush=True)
    cfgs = [get_config(a) for a in ("gpt2m", smoke.LLAMA, smoke.MOE)]
    res = {"label": args.label, "card": card,
           "times": time_kernels(torch, smoke, qz, rn, cfgs)}
    if args.sweep:
        res["sweep"] = sweep(torch, smoke, qz, cfgs)
    res["decode"] = decode(torch, np, smoke)
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
        ms = defaultdict(lambda: defaultdict(list))
        for r in runs:
            for row in r.get(part, ()):
                ms[row["key"]][r["label"]].append(row["ms"])
        for key, by in ms.items():
            cells = "  ".join(
                f"{lab} {sum(by[lab]) / len(by[lab]):.4f}" for lab in labels
                if by.get(lab))
            print(f"{key}: {cells} ms")
    for lab in labels:
        for r in (r for r in runs if r["label"] == lab):
            prof = r["decode"]["profile"] or {}
            for kern in ("int8kv_decode", "rmsnorm"):
                k = prof.get("per_kernel", {}).get(kern)
                if k:
                    print(f"{lab} traced generate, {kern}: {k['us'] / 1e3:.3f}"
                          f" ms in {k['count']} launches, share "
                          f"{k['share']:.4f}")
            if prof:
                print(f"{lab} traced generate: idle share "
                      f"{prof['idle_share']:.3f}")
            say_part(f"{lab} kernel path against plain path",
                     first_part(r["decode"]["kernels"],
                                r["decode"]["plain"]))
    for i, a in enumerate(labels):
        for b in labels[i + 1:]:
            ra = next(r for r in runs if r["label"] == a)
            rb = next(r for r in runs if r["label"] == b)
            say_part(f"{a} kernel path against {b} kernel path",
                     first_part(ra["decode"]["kernels"],
                                rb["decode"]["kernels"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch to time")
    ap.add_argument("--label", help="this run's name in --compare")
    ap.add_argument("--out", help="write the run here as JSON")
    ap.add_argument("--sweep", action="store_true",
                    help="also force kernel B's split count")
    ap.add_argument("--compare", nargs="+", metavar="FILE",
                    help="print runs written by --out side by side")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
    elif args.label and args.out:
        run(args)
    else:
        ap.error("give --label and --out, or --compare")


if __name__ == "__main__":
    main()
