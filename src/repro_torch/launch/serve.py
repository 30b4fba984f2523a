"""Serving launcher of the port: batched prefill + decode of a ported
model (gpt2m/gpt2L/gpt2l, llama3.2-3b, phi3.5-moe-42b-a6.6b,
falcon-mamba-7b, zamba2-2.7b) on one device, fixed-batch by default,
continuous batching with ``--continuous``.  Weights are random, from
seed 0.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --continuous --trace 12x8..32 --batch 3 --gen 8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --reduced --device cpu --batch 2 --gen 8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --kv-dtype int8
"""
import argparse

from repro_torch.configs import ARCH_CONFIGS


def parse_trace(spec: str, max_prompt: int):
    """``<n>x<lo>..<hi>`` — n requests with prompt lengths uniform in
    [lo, hi] (deterministic, seed 0).  Plain ``<n>`` uses 8..max_prompt."""
    body = spec
    lo, hi = 8, max_prompt
    if "x" in spec:
        body, rng_part = spec.split("x", 1)
        try:
            lo, hi = (int(v) for v in rng_part.split("..", 1))
        except ValueError:
            raise SystemExit(
                f"bad --trace {spec!r}: want <n>x<lo>..<hi> or <n>")
    try:
        n = int(body)
    except ValueError:
        raise SystemExit(f"bad --trace {spec!r}: want <n>x<lo>..<hi> or <n>")
    if not (n >= 1 and 1 <= lo <= hi <= max_prompt):
        raise SystemExit(
            f"bad --trace {spec!r}: need n >= 1 and "
            f"1 <= lo <= hi <= {max_prompt}")
    return n, lo, hi


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2m", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch rows / continuous decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window cache (long-context decode)")
    ap.add_argument("--kv-dtype", default="fp32", choices=("fp32", "int8"),
                    help="int8: quantized KV cache + int8-KV decode kernel "
                         "(dense and MoE families)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching "
                         "(greedy; --batch = slot count)")
    ap.add_argument("--trace", default=None, metavar="N[xLO..HI]",
                    help="continuous request trace: N prompts with "
                         "lengths uniform in [LO, HI] (default "
                         "2x the slot count over 8..--prompt-len)")
    args = ap.parse_args(argv)
    if args.trace and not args.continuous:
        ap.error("--trace only applies with --continuous")

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine, Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen + 8
    header = (f"{cfg.name} [{cfg.family}] device={model.device} "
              f"batch={args.batch} kv={args.kv_dtype}")

    if args.continuous:
        n, lo, hi = parse_trace(args.trace or f"{2 * args.batch}",
                                args.prompt_len)
        prompts = [np.asarray(
            rng.integers(4, min(cfg.vocab_size, 400),
                         (int(rng.integers(lo, hi + 1)),)), np.int32)
            for _ in range(n)]
        eng = ContinuousEngine(model, slots=args.batch, max_len=max_len,
                               kv_dtype=args.kv_dtype, device=args.device)
        res = eng.run(params, [Request(i, p) for i, p in enumerate(prompts)],
                      max_new=args.gen)
        st = res["stats"]
        lens = sorted(len(p) for p in prompts)
        print(f"{header} continuous slots={args.batch}")
        print(f"{n} requests (prompt lens {lens[0]}..{lens[-1]}) | "
              f"{st.n_tokens} tokens in {st.total_s:.2f}s | "
              f"{st.tokens_per_s:.1f} tok/s | "
              f"occupancy {st.mean_occupancy:.2f}/{args.batch} | "
              f"TTFT p50 "
              f"{np.percentile(sorted(st.ttft_s.values()), 50):.3f}s")
        return res

    batch = {"tokens": np.asarray(
        rng.integers(4, min(cfg.vocab_size, 400),
                     (args.batch, args.prompt_len)), np.int32)}
    eng = Engine(model, batch_size=args.batch, max_len=max_len,
                 window=args.window, temperature=args.temperature,
                 kv_dtype=args.kv_dtype, device=args.device)
    out = eng.generate(params, batch, n_tokens=args.gen)
    s = out["stats"]
    print(header)
    print(f"prefill {s.prefill_s * 1e3:.1f} ms | decode "
          f"{s.steps_per_s:.1f} steps/s "
          f"({s.tokens_per_s:.1f} tok/s aggregate)")
    return out


if __name__ == "__main__":
    main()
