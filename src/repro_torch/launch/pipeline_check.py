"""Pipeline parity check of the port (counterpart of
``repro.launch.pipeline_check``, with its flags and JSON keys).

Searches a heterogeneous line topology of one GPU a site (``--gpus``,
e.g. A30,T4) with TFLOP-weighted stage balancing (the port's
``PlanSearch``), realizes each searched pipeshard ``Placement`` as a
``(stage, 1, 1)`` mesh of ``torch.distributed`` ranks, one a site (gloo
with ``--device cpu``, else NCCL with one card a rank), and computes the
pipeline's loss and gradients of one batch beside the unsharded port's
``Model.loss``, under every requested schedule.  Prints one JSON line:

    {"stage_layers": [...], "splits": {...}, "ref_loss": ...,
     "losses": {...}, "ref_gnorm": ..., "gnorms": {...}, "ref_aux": ...,
     "auxes": {...}}

``losses``/``gnorms``/``auxes`` keys: ``searched`` (the searched,
possibly uneven split), plus, when the stack divides the chunk count,
``legacy`` (``stage_layers=None``) and ``even`` (the same equal split
passed explicitly); a schedule other than GPipe suffixes its keys, e.g.
``searched@1f1b``.  The port's pipeline sums its microbatches' losses
and gradients, so it agrees with the unsharded loss to rounding, and
every schedule and split of one layout to the bit.  ``--carrier bf16``
hands bf16 activations between the stages.  The model runs in fp32 on
the CPU, in bf16 on the card (kernel A takes bf16).

``--arch`` takes every ported family.  The MoE family routes each
microbatch as one, so its unsharded yardstick runs the batch in
``--micro`` accumulated microbatches (``grad_accum``).  The hybrid
family's stack is its groups of ``hybrid_attn_every`` layers, while the
search splits layers: it runs the even splits of its groups only (and
reports the searched layer split).  On the card the families whose
kernels have no backward run their plain versions
(``models.trains_through_kernels``).

    PYTHONPATH=src python -m repro_torch.launch.pipeline_check \\
        --device cpu --gpus A30,T4 --layers 6 \\
        --schedules gpipe,1f1b,interleaved
    PYTHONPATH=src python -m repro_torch.launch.pipeline_check \\
        --device cpu --arch zamba2-2.7b --layers 4 --schedules gpipe,1f1b
"""
import argparse
import json
import os
import tempfile


def _gnorm(tree) -> float:
    import torch

    from repro_torch.optim.adamw import tree_leaves
    return float(torch.sqrt(sum(t.double().square().sum()
                                for t in tree_leaves(tree))))


def _rank(rank: int, args, store: str) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.costmodel import Workload, parse_schedule
    from repro_torch.core.search import PlanSearch
    from repro_torch.core.steps import _grad_fn, build_train_step
    from repro_torch.core.topology import Link, Site, line
    from repro_torch.launch.mesh import placement_pipeline_mesh
    from repro_torch.models import Model, trains_through_kernels

    gpus = args.gpus.split(",")
    n_sites = len(gpus)
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device, backend = f"cuda:{rank}", "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = "cpu", "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n_sites)
    try:
        schedules = args.schedules.split(",")
        cfg = dataclasses.replace(
            get_config(args.arch).reduced(), n_layers=args.layers,
            dtype="bfloat16" if args.device == "cuda" else "float32")
        carrier = torch.bfloat16 if args.carrier == "bf16" else \
            torch.float32
        use_kernels = trains_through_kernels(cfg)
        hybrid = cfg.family == "hybrid"
        # the pipeline's stack: layers, or the hybrid's groups
        stack = args.layers // cfg.hybrid_attn_every if hybrid \
            else args.layers
        topo = line("hetline",
                    [Site((g,), name=f"S{i}") for i, g in enumerate(gpus)],
                    [Link(20e-3, 3.0)] * (n_sites - 1))
        wl = Workload(cfg, args.seq, args.batch, steps_per_epoch=1,
                      microbatches=args.micro)
        search = PlanSearch(wl, topo, stage_balance="tflops",
                            schedules=tuple(schedules))

        def searched_placement(sched):
            cand = next(c for c in search.candidates()
                        if c.technique == "pipeshard"
                        and c.sites == tuple(range(n_sites))
                        and c.stage_order == tuple(range(n_sites))
                        and c.schedule == sched)
            return search.placement(cand)

        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
        # ragged/packed-style positions: every example its own offset, so
        # reusing microbatch 0's rows for later microbatches would show
        positions = np.arange(args.seq)[None] \
            + (np.arange(args.batch)[:, None] % 3)
        batch = {"tokens": tokens, "labels": tokens, "positions": positions}
        tcfg = TrainConfig(microbatches=args.micro)

        def fresh(model):
            return model.init(torch.Generator(device=model.device)
                              .manual_seed(0))

        losses, gnorms, auxes, split_report = {}, {}, {}, {}
        for sched in schedules:
            placement = searched_placement(sched)
            _, virt = parse_schedule(sched)
            n_chunks = n_sites * virt
            splits = {} if hybrid else {"searched": placement.stage_layers}
            if stack % n_chunks == 0:
                splits["legacy"] = None
                splits["even"] = (stack // n_chunks,) * n_chunks
            mesh = placement_pipeline_mesh(topo, placement)
            for name, split in splits.items():
                key = name if sched == "gpipe" else f"{name}@{sched}"
                split_report[key] = None if split is None else list(split)
                model = Model(cfg, device=device, use_kernels=use_kernels)
                step = build_train_step(model, tcfg, plan="pipeshard",
                                        mesh=mesh, stage_layers=split,
                                        schedule=sched,
                                        carrier_dtype=carrier)
                loss, metrics, grads = step.grads(
                    step.shard_params(fresh(model)), batch)
                losses[key] = float(loss)
                gnorms[key] = _gnorm(step.gather_params(grads))
                auxes[key] = float(metrics["aux"])
        if rank == 0:
            model = Model(cfg, device=device, use_kernels=use_kernels)
            tb = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
            accum = args.micro if cfg.family == "moe" else 1
            ref_loss, ref_metrics, ref_grads = _grad_fn(
                model, dataclasses.replace(tcfg, grad_accum=accum),
                model.loss)(fresh(model), tb)
            print(json.dumps({
                "stage_layers": list(searched_placement(schedules[0])
                                     .stage_layers or ()),
                "splits": split_report,
                "ref_loss": float(ref_loss),
                "losses": losses,
                "ref_gnorm": _gnorm(ref_grads),
                "gnorms": gnorms,
                "ref_aux": float(ref_metrics["aux"]),
                "auxes": auxes,
            }), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gpus", default="A30,T4",
                    help="one GPU type per site/stage, comma-separated")
    ap.add_argument("--arch", default="gpt2m",
                    help="config name of any ported family")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--schedules", default="gpipe",
                    help="comma-separated pipeline schedules to check "
                         "(gpipe, 1f1b, interleaved, interleaved<v>)")
    ap.add_argument("--carrier", default="fp32", choices=("fp32", "bf16"),
                    help="dtype of the activations and gradients handed "
                         "between stages (core.costmodel.CARRIER_DTYPES)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    from repro_torch import resolve_device
    world = len(args.gpus.split(","))
    if args.device == "cuda":
        resolve_device("cuda")                    # raises without a card
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} stages need as many cards, "
                               f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(args, os.path.join(d, "store")),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
