"""Serving launcher of the port: batched prefill + decode of a ported
model (gpt2m/gpt2L/gpt2l, llama3.2-3b, phi3.5-moe-42b-a6.6b,
falcon-mamba-7b, zamba2-2.7b, whisper-small, ...) on one device,
fixed-batch by default, continuous batching with ``--continuous``.
Weights are random, from seed 0; whisper-small's frames too, [batch,
1500, 768] x 0.02 from the prompts' generator, as the reference's
launcher makes them (fixed-batch: the encoder-decoder has no continuous
batching), and
phi-3-vision-4.2b's patch embeddings, [batch, 576, 1024] x 0.02
(fixed-batch; its cache holds the 576 patches beside the prompt and the
new tokens, where the reference's launcher sizes it for the text alone).

With ``--plan`` (a ``core.plans.PLANS`` key: data, zero2, shard,
shard_zero, fsdp or pipeshard; every family serves under each) and
``--mesh`` it serves on every rank of a ``torch.distributed`` world:
under ``torch.distributed.run`` it reads ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` and uses NCCL on ``cuda:LOCAL_RANK``, or gloo with
``--device cpu``; started alone, it is a world of one.  Under ``--plan
pipeshard`` the mesh is reshaped into ``--stages`` pipeline stages
(``core.pipeline.pipeline_mesh``: the pod axis first, then the data
axis), whose layers ``--stage-layers`` splits (one count per chunk, a
whole number of chunks a stage; default the even split, one chunk a
stage).  Rank 0 prints.

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.serve --reduced \
        --device cpu --plan shard --mesh 1,1,2 --kv-dtype int8

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 -m repro_torch.launch.serve --reduced \\
        --device cpu --plan pipeshard --mesh 2,1,1 --stages 2

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --continuous --trace 12x8..32 --batch 3 --gen 8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --reduced --device cpu --batch 2 --gen 8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --kv-dtype int8

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper-small --reduced --device cpu --batch 2 --gen 8

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 -m repro_torch.launch.serve --arch whisper-small \\
        --reduced --device cpu --plan shard --mesh 1,1,2 --check

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi-3-vision-4.2b --reduced --device cpu --kv-dtype int8

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --reduced --device cpu --plan pipeshard \\
        --mesh 2,1,1 --stages 2 --layers 4 --check

``--layers`` keeps the first N layers at full width (deepseek-v2-236b's
60 layers hold ~958 GB in fp32); ``--plain-fp32`` computes in fp32
through the kernels' plain versions (``tools/moe_ties.py`` reads where
an MoE model's bf16 routing parts across cards).
"""
import argparse
import dataclasses
import zlib

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.core.plans import PLANS


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
    ap.add_argument("--layers", type=int, default=None,
                    help="depth: the first N layers of the architecture "
                         "(its width unchanged), e.g. a model whose every "
                         "layer does not fit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions)")
    ap.add_argument("--plain-fp32", action="store_true",
                    help="compute in fp32 through the kernels' plain "
                         "versions, no kernel (A takes bf16 only): the "
                         "plan's sums held tighter than bf16's envelope")
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
    ap.add_argument("--runs", type=int, default=1,
                    help="fixed-batch runs; prints each run's prefill and "
                         "decode rate (the first pays the warm-up)")
    ap.add_argument("--check", type=float, nargs="?", const=0.05,
                    default=None, metavar="RTOL",
                    help="under --plan: hold the last run's tokens and "
                         "the teacher-forced logits of every step to the "
                         "one-device engine's, on each rank; exit non-zero "
                         "where a logit differs by more than RTOL (default "
                         "0.05, bf16's envelope) of the largest")
    ap.add_argument("--plan", default=None, choices=sorted(PLANS),
                    help="execution plan; without it, one device")
    ap.add_argument("--mesh", default="1,1,1",
                    help="mesh shape over (pod, data, model), e.g. 1,2,2; "
                         "fewer numbers name the last axes")
    ap.add_argument("--stages", type=int, default=2,
                    help="pipeline stages (pipeshard)")
    ap.add_argument("--stage-layers", default=None,
                    help="layers (the hybrid family's groups) of each "
                         "chunk, e.g. 16,14 (pipeshard; default the even "
                         "split)")
    args = ap.parse_args(argv)
    if args.trace and not args.continuous:
        ap.error("--trace only applies with --continuous")
    if args.plan is None:
        return _serve(args)
    return _serve_on_mesh(args)


def _serve_on_mesh(args):
    """Serve under ``args.plan`` on this rank; rank 0's result, None on
    the other ranks."""
    import torch.distributed as dist

    from repro_torch.core.plans import get_plan
    from repro_torch.launch.mesh import (init_world, make_host_mesh,
                                         make_pipeline_mesh)

    device = init_world(args.device)      # raises without a card
    backend = dist.get_backend()
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
        axes = ("pod", "data", "model")[-len(shape):]
        if get_plan(args.plan).pipeline:
            split = _split(args)
            v = 1 if split is None else len(split) // args.stages
            mesh = make_pipeline_mesh(
                shape, axes, args.stages, stage_layers=split,
                schedule="gpipe" if v <= 1 else f"interleaved{v}")
        else:
            mesh = make_host_mesh(shape, axes)
        res = _serve(args, device, mesh,
                     f" plan={args.plan} mesh={mesh.shape} ({backend}, "
                     f"{dist.get_world_size()} ranks)",
                     main=dist.get_rank() == 0)
    finally:
        dist.destroy_process_group()
    return res


def _split(args):
    """``--stage-layers`` as a tuple, or None."""
    return None if args.stage_layers is None else \
        tuple(int(x) for x in args.stage_layers.split(","))


def _serve(args, device=None, mesh=None, where: str = "", main=True):
    """Run the engine on ``device`` (``args.device``), under
    ``args.plan`` on ``mesh`` when given; prints when ``main``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plans import get_plan
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine, Engine, Request

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.plain_fp32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg, device=device or args.device,
                  use_kernels=not args.plain_fp32)

    def init_params():
        return model.init(torch.Generator(device=model.device).manual_seed(0))

    params = init_params()
    on = dict(device=model.device.type, plan=args.plan, mesh=mesh)
    if args.plan is not None and get_plan(args.plan).pipeline:
        on["stage_layers"] = _split(args)

    rng = np.random.default_rng(0)
    # the VLM's prefill fills its patches before the prompt
    max_len = args.prompt_len + args.gen + 8 + (
        cfg.n_patches if cfg.family == "vlm" else 0)
    header = (f"{cfg.name} [{cfg.family}] device={model.device} "
              f"batch={args.batch} kv={args.kv_dtype}"
              f"{' fp32, plain versions' if args.plain_fp32 else ''}{where}")
    log = print if main else (lambda *a: None)

    if args.continuous:
        n, lo, hi = parse_trace(args.trace or f"{2 * args.batch}",
                                args.prompt_len)
        prompts = [np.asarray(
            rng.integers(4, min(cfg.vocab_size, 400),
                         (int(rng.integers(lo, hi + 1)),)), np.int32)
            for _ in range(n)]
        eng = ContinuousEngine(model, slots=args.batch, max_len=max_len,
                               kv_dtype=args.kv_dtype, **on)
        res = eng.run(eng.shard_params(params),
                      [Request(i, p) for i, p in enumerate(prompts)],
                      max_new=args.gen)
        st = res["stats"]
        lens = sorted(len(p) for p in prompts)
        log(f"{header} continuous slots={args.batch}")
        log(f"{n} requests (prompt lens {lens[0]}..{lens[-1]}) | "
              f"{st.n_tokens} tokens in {st.total_s:.2f}s | "
              f"{st.tokens_per_s:.1f} tok/s | "
              f"occupancy {st.mean_occupancy:.2f}/{args.batch} | "
              f"TTFT p50 "
              f"{np.percentile(sorted(st.ttft_s.values()), 50):.3f}s")
        return res if main else None

    batch = {"tokens": np.asarray(
        rng.integers(4, min(cfg.vocab_size, 400),
                     (args.batch, args.prompt_len)), np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.asarray(
            rng.standard_normal((args.batch, cfg.n_patches, cfg.vision_dim))
            * 0.02, np.float32)
    if cfg.family == "encdec":
        batch["frames"] = np.asarray(
            rng.standard_normal((args.batch, cfg.enc_seq_len, cfg.d_model))
            * 0.02, np.float32)
    eng = Engine(model, batch_size=args.batch, max_len=max_len,
                 window=args.window, temperature=args.temperature,
                 kv_dtype=args.kv_dtype, **on)
    params = eng.shard_params(params)
    if model.device.type == "cuda":      # the peak of serving, not of init
        torch.cuda.reset_peak_memory_stats(model.device)
    log(header)
    for _ in range(args.runs):
        out = eng.generate(params, batch, n_tokens=args.gen)
        s = out["stats"]
        log(f"prefill {s.prefill_s * 1e3:.1f} ms | decode "
            f"{s.steps_per_s:.1f} steps/s "
            f"({s.tokens_per_s:.1f} tok/s aggregate) | tokens crc32 "
            f"{zlib.crc32(np.ascontiguousarray(out['tokens'], np.int64)):08x}")
    if model.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(model.device) / 2**30
        if mesh is None:
            log(f"peak memory {peak:.2f} GiB")
        else:
            import torch.distributed as dist
            peaks = [None] * dist.get_world_size()
            dist.all_gather_object(peaks, peak)
            log("peak memory by rank " + ", ".join(
                f"{p:.2f}" for p in peaks) + " GiB")
    if args.check is not None and eng.plan is not None:
        from repro_torch.serve.steps import teacher_forced
        full = init_params()
        one = Engine(model, batch_size=args.batch, max_len=max_len,
                     window=args.window, kv_dtype=args.kv_dtype,
                     device=model.device.type)
        want = one.generate(full, batch, n_tokens=args.gen)["tokens"]
        err, scale, same = teacher_forced(model, full, params, batch, want,
                                          eng.plan, kv_dtype=args.kv_dtype)
        log(f"against one device on each rank: tokens equal "
            f"{np.array_equal(out['tokens'], want)} | teacher-forced "
            f"logits max |diff| {err:.4g} of max |logit| {scale:.4g}"
            f"{' (bit-equal)' if same else ''}")
        if not err <= args.check * scale:
            raise SystemExit(f"teacher-forced logits differ from one "
                             f"device by {err:.4g} > {args.check} x "
                             f"{scale:.4g}")
    return out if main else None


if __name__ == "__main__":
    main()
