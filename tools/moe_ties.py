#!/usr/bin/env python
"""Where an MoE model's routing parts between one device and a serving
plan, and whether the plan's logits hold once the routing does not part.

Run under ``torch.distributed.run`` on the plan's ranks, as
``launch/serve.py --plan shard --check`` runs, with its seeded weights
and its prompts at ``--batch 8 --prompt-len 64``:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        tools/moe_ties.py --arch deepseek-v2-236b --layers 2 --mesh 1,1,4

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc_per_node 2 tools/moe_ties.py --arch deepseek-v2-236b \\
        --reduced --device cpu --mesh 1,1,2 --gen 6

Every rank feeds one device's greedy tokens to one device and to the
plan in lockstep (``serve.steps.teacher_forced``), twice, and records
each MoE layer's router output (``models.moe.route``) on both sides:

  * ``free``: the plan routes for itself, as in ``serve --check``.  Of
    each (step, layer) the tokens whose expert sets part; at the first
    that parts, each such token's k-th and (k+1)-th router
    probabilities on both sides, their gap on one device, and the
    largest |probability difference| between the sides over the whole
    call (the noise the plan's other rounding puts on the router);
    and, for scale, the smallest and the median gap of that call;
  * ``replayed``: each of the plan's MoE layers takes one device's
    expert choices at the same step and layer (its gates renormalised
    from its own probabilities at those experts), so only the discrete
    choice is taken from one device.

Rank 0 prints one JSON line: each run's largest |logit difference|
against the largest |logit|, and the readings.  Exits non-zero where
the replayed logits differ by more than 5% (bf16's envelope, as
``serve --check``) of the largest.  The plan is shard, whose ranks hold
every token, so both sides route the same tokens.
"""
import argparse
import dataclasses
import json
import statistics

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_CONFIGS, get_config
from repro_torch.launch.mesh import init_world, make_host_mesh
from repro_torch.models import Model, moe
from repro_torch.serve import Engine
from repro_torch.serve.steps import teacher_forced

BATCH, PROMPT_LEN = 8, 64
RTOL = 0.05


class Router:
    """``moe.route`` with a record of each call, on one device's side or
    the plan's, and, with ``replay``, the plan's calls taking one
    device's choices of the same step and layer.  ``teacher_forced``
    runs each step on one device, then under the plan: ``n_layers``
    calls a side in turn."""

    def __init__(self, real, n_layers: int):
        self.real, self.n, self.replay = real, n_layers, False
        self.calls = {"one": [], "plan": []}

    def __call__(self, xf, params, cfg):
        probs, gates, choices = self.real(xf, params, cfg)
        one, plan = self.calls["one"], self.calls["plan"]
        if (len(one) + len(plan)) // self.n % 2 == 0:
            one.append((probs, choices))
            return probs, gates, choices
        if self.replay:
            choices = one[len(plan)][1]
            gates = probs.gather(-1, choices)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        plan.append((probs, choices))
        return probs, gates, choices


def partings(router, k: int, n_layers: int):
    """The free run's readings: tokens parted per (step, layer), and the
    first call that parts, token by token."""
    parted, first = [], None
    for c, ((p1, c1), (p2, c2)) in enumerate(zip(router.calls["one"],
                                                 router.calls["plan"])):
        differ = (c1.sort(-1).values != c2.sort(-1).values).any(-1)
        parted.append(int(differ.sum()))
        if first is not None or not differ.any():
            continue
        top1 = p1.topk(k + 1, dim=-1)
        gaps = (top1.values[:, k - 1] - top1.values[:, k]).tolist()
        tokens = []
        for t in differ.nonzero().flatten().tolist():
            top2 = p2[t].topk(k + 1)
            tokens.append({
                "token": t,
                "one": {"experts": c1[t].sort().values.tolist(),
                        "kth_and_next": [(int(e), float(v)) for e, v in zip(
                            top1.indices[t, k - 1:], top1.values[t, k - 1:])]},
                "plan": {"experts": c2[t].sort().values.tolist(),
                         "kth_and_next": [(int(e), float(v)) for e, v in zip(
                             top2.indices[k - 1:], top2.values[k - 1:])]},
                "gap_one": gaps[t]})
        first = {"step": c // n_layers, "layer": c % n_layers,
                 "noise": float((p2 - p1).abs().max()),
                 "gap_min": min(gaps), "gap_median": statistics.median(gaps),
                 "tokens_in_call": len(gaps), "parted": tokens}
    return parted, first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-v2-236b",
                    choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions)")
    ap.add_argument("--mesh", default="1,1,4",
                    help="mesh shape over (pod, data, model)")
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)

    device = init_world(args.device)
    try:
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        if cfg.family != "moe":
            raise SystemExit(f"{cfg.name} routes no tokens")
        shape = tuple(int(x) for x in args.mesh.split(","))
        mesh = make_host_mesh(shape, ("pod", "data", "model")[-len(shape):])
        model = Model(cfg, device=device)
        full = model.init(torch.Generator(device=model.device).manual_seed(0))
        rng = np.random.default_rng(0)
        batch = {"tokens": np.asarray(
            rng.integers(4, min(cfg.vocab_size, 400),
                         (BATCH, PROMPT_LEN)), np.int32)}
        max_len = PROMPT_LEN + args.gen + 8
        one = Engine(model, batch_size=BATCH, max_len=max_len,
                     device=model.device.type)
        tokens = one.generate(full, batch, n_tokens=args.gen)["tokens"]
        eng = Engine(model, batch_size=BATCH, max_len=max_len,
                     device=model.device.type, plan="shard", mesh=mesh)
        local = eng.shard_params(full)

        router = Router(moe.route, cfg.n_layers)
        moe.route = router
        try:
            free = teacher_forced(model, full, local, batch, tokens,
                                  eng.plan)
            parted, first = partings(router, cfg.moe.top_k, cfg.n_layers)
            router.calls = {"one": [], "plan": []}
            router.replay = True
            replayed = teacher_forced(model, full, local, batch, tokens,
                                      eng.plan)
        finally:
            moe.route = router.real
        res = {"arch": cfg.name, "layers": cfg.n_layers, "plan": "shard",
               "mesh": list(shape), "dtype": cfg.dtype,
               "free": {"err": free[0], "scale": free[1],
                        "parted_tokens_per_call": parted,
                        "first_parting": first},
               "replayed": {"err": replayed[0], "scale": replayed[1]}}
        if dist.get_rank() == 0:
            print(json.dumps(res))
        if not replayed[0] <= RTOL * replayed[1]:
            raise SystemExit(f"with one device's routing the logits differ "
                             f"by {replayed[0]:.4g} > {RTOL} x "
                             f"{replayed[1]:.4g}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
