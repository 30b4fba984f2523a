"""Training launcher of the port: pretrain a ported architecture on the
in-repo synthetic corpus (or ``--data-dir``), on one device or under an
execution plan, the counterpart of ``repro.launch.train``.

``--arch`` takes any ported architecture of a token-only family (dense,
MoE, SSM, hybrid); on the card the families whose kernels have no
backward train through the plain versions
(``models.trains_through_kernels``).  The encoder-decoder (whisper)
and the vision-language model (phi-3-vision) raise: the Loader feeds
tokens alone, and these families need frames or patch embeddings beside
them, as the reference's launcher cannot train them either
(``Model.loss`` on a batch with ``frames`` or ``patch_embeds`` trains
them).  Without ``--plan``
it trains on one device.  With ``--plan`` (a ``core.plans.PLANS`` key:
data, zero2, shard, shard_zero, fsdp, pipeshard) and ``--mesh`` it runs
on every rank of a
``torch.distributed`` world: under ``torch.distributed.run`` it reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and uses NCCL on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``; started alone, it is
a world of one.  Under ``--plan pipeshard`` the mesh is reshaped into
``--stages`` pipeline stages (``core.pipeline.pipeline_mesh``: the pod
axis first, then the data axis), each rank's batch is cut into
``--microbatches``, the stages run the tick order ``--schedule`` and
split the layers by ``--stage-layers`` (one count per chunk; default
even).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2m \\
        --steps 100 --seq 1024 --batch 8 --vocab 50257

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2m \\
        --reduced --device cpu --steps 3 --seq 32 --batch 4

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \\
        -m repro_torch.launch.train --arch gpt2m --reduced --device cpu \\
        --plan shard --mesh 1,2,2 --steps 3 --seq 32 --batch 8

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --arch gpt2m --reduced --device cpu \
        --plan pipeshard --mesh 2,1,1 --schedule 1f1b --microbatches 2 \
        --steps 3 --seq 32 --batch 4

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 4 \
        -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b --reduced \
        --device cpu --plan fsdp --mesh 1,2,2 --steps 3 --seq 32 --batch 8
"""
import argparse
import dataclasses

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.core.plans import PLANS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2m", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--docs", type=int, default=500,
                    help="synthetic corpus size (use --data-dir for real)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions)")
    ap.add_argument("--plan", default=None, choices=sorted(PLANS),
                    help="execution plan; without it, one device")
    ap.add_argument("--mesh", default="1,1,1",
                    help="mesh shape over (pod, data, model), e.g. 1,2,2; "
                         "fewer numbers name the last axes")
    ap.add_argument("--stages", type=int, default=2,
                    help="pipeline stages (pipeshard)")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="microbatches a rank's batch is cut into "
                         "(pipeshard)")
    ap.add_argument("--schedule", default="gpipe",
                    help="pipeline tick order: gpipe, 1f1b, interleaved "
                         "or interleaved<v> (pipeshard)")
    ap.add_argument("--stage-layers", default=None,
                    help="layers of each chunk, e.g. 16,14 (pipeshard; "
                         "default the even split)")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import (Loader, Tokenizer, build_dataset,
                                  load_text_dir, synthetic_wikipedia)
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.train import model_flops_per_step, train

    extra = {"encdec": ("an encoder-decoder", "frames"),
             "vlm": ("a vision-language model", "patch_embeds")}.get(
        get_config(args.arch).family)
    if extra is not None:
        raise NotImplementedError(
            f"{args.arch} is {extra[0]}: a training batch needs "
            f"{extra[1]} beside its tokens, and this launcher's Loader "
            f"feeds tokens alone (as the reference's does); train it "
            f"through Model.loss on batches with {extra[1]!r}")
    texts = list(load_text_dir(args.data_dir)) if args.data_dir else \
        list(synthetic_wikipedia(args.docs, seed=args.seed))
    tok = Tokenizer.train(texts, args.vocab)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                              max_seq_len=max(cfg.max_seq_len, args.seq))
    ds = build_dataset(texts, tok, seq_len=args.seq)
    loader = Loader(ds, global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                       total_steps=args.steps, seed=args.seed,
                       microbatches=args.microbatches)
    if args.plan is None:
        model = Model(cfg, device=args.device,
                      use_kernels=trains_through_kernels(cfg))
        print(f"{cfg.name} [{cfg.family}] {cfg.param_count() / 1e6:.1f}M "
              f"params | one device: {model.device}")
        res = train(model, tcfg, loader, steps=args.steps,
                    log_every=max(args.steps // 10, 1),
                    ckpt_dir=args.ckpt_dir)
    else:
        res = _train_on_mesh(args, cfg, tcfg, loader)
        if res is None:
            return None
    flops = model_flops_per_step(cfg, args.batch * args.seq)
    print(f"done: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
          f"{res.tflops(flops):.4f} TFLOP/s avg")
    return res


def _train_on_mesh(args, cfg, tcfg, loader):
    """Train under ``args.plan`` on this rank; the mesh's first rank's
    result, None on the other ranks."""
    import torch.distributed as dist

    from repro_torch.core.plans import get_plan
    from repro_torch.launch.mesh import (init_world, make_host_mesh,
                                         make_pipeline_mesh)
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.train import train

    device = init_world(args.device)           # raises without a card
    model = Model(cfg, device=device, use_kernels=trains_through_kernels(cfg))
    backend = dist.get_backend()
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
        axes = ("pod", "data", "model")[-len(shape):]
        split = None if args.stage_layers is None else \
            tuple(int(x) for x in args.stage_layers.split(","))
        if get_plan(args.plan).pipeline:
            mesh = make_pipeline_mesh(shape, axes, args.stages,
                                      stage_layers=split,
                                      schedule=args.schedule)
        else:
            mesh = make_host_mesh(shape, axes)
        main = dist.get_rank() == mesh.first_rank
        if main:
            print(f"{cfg.name} [{cfg.family}] "
                  f"{cfg.param_count() / 1e6:.1f}M params | plan="
                  f"{args.plan} mesh={mesh.shape} "
                  f"({backend}, {dist.get_world_size()} ranks)")
        res = train(model, tcfg, loader, steps=args.steps,
                    log_every=max(args.steps // 10, 1),
                    ckpt_dir=args.ckpt_dir, plan=args.plan, mesh=mesh,
                    stage_layers=split, schedule=args.schedule)
    finally:
        dist.destroy_process_group()
    return res if main else None


if __name__ == "__main__":
    main()
