"""One rank of the gloo worlds of ``tests/test_torch_pipeline.py``.

Every rank of a world runs the pipeline plan of the port on reduced
fp32 gpt2m models (and, in the world of 2, whisper-small's and
deepseek-v2's, in the world of 4 minicpm3's on a model axis of 2), under
several schedules and layer splits, and rank 0
runs the one-device port beside it on the same params and batch; rank 0
saves what the tests compare (``torch.save`` of plain Python and
numpy).  Imports no JAX.

    python tests/torch_pipeline_worker.py OUT WORLD
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
for p in (SRC, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_plan_family_worker as family_worker  # noqa: E402
import torch_plan_worker as plan_worker  # noqa: E402

AXES = ("pod", "data", "model")
STEPS, SEQ = 3, 16
CKPT_STEPS = 2
# world -> scenarios; a scenario is one layout of the world and the
# (schedule, split) runs on it.  Line-topology scenarios take the
# searched split (``PlanSearch`` over ``gpus``, TFLOP-weighted) as the
# reference's ``pipeline_check`` does; ``legacy`` is no split, ``even``
# the even split spelled out.  Mesh scenarios: (pod, data, model) shapes
# cut into 2 stages; ``arch`` other than gpt2m: the encoder-decoder, its
# batch carrying frames, its encoder on the first stage; MLA, dense
# (minicpm3, its heads cut over the model axis) and MoE (deepseek-v2,
# each microbatch routed as one: its batch's labels all live, and its
# yardstick one device with ``grad_accum`` = the microbatches).
SCENARIOS = {
    2: {"A30,T4": dict(gpus="A30,T4", layers=6, micro=4, batch=8,
                       runs=(("gpipe", "searched"), ("gpipe", "legacy"),
                             ("gpipe", "even"), ("1f1b", "searched"),
                             ("interleaved", "searched"))),
        "whisper": dict(arch="whisper-small", shape=(2, 1, 1), layers=4,
                        micro=4, batch=8,
                        runs=(("gpipe", "legacy"), ("1f1b", "legacy"),
                              ("interleaved", "even"))),
        "dsv2": dict(arch="deepseek-v2-236b", shape=(2, 1, 1), layers=4,
                     micro=4, batch=8,
                     runs=(("gpipe", "legacy"), ("1f1b", "legacy"),
                           ("interleaved", "even")))},
    3: {"A30,A30,T4": dict(gpus="A30,A30,T4", layers=7, micro=4, batch=8,
                           runs=(("gpipe", "searched"),
                                 ("1f1b", "searched"),
                                 ("interleaved", "searched"))),
        "A30,T4,T4": dict(gpus="A30,T4,T4", layers=9, micro=3, batch=6,
                          runs=(("gpipe", "searched"),
                                ("1f1b", "searched")))},
    4: {"mesh2,1,2": dict(shape=(2, 1, 2), layers=8, micro=4, batch=8,
                          runs=(("gpipe", "legacy"), ("1f1b", "legacy"))),
        "mesh2,2,1": dict(shape=(2, 2, 1), layers=8, micro=4, batch=8,
                          runs=(("gpipe", "legacy"),
                                ("interleaved", "even"))),
        "mla": dict(arch="minicpm3-4b", shape=(2, 1, 2), layers=4, micro=4,
                    batch=8, runs=(("gpipe", "legacy"), ("1f1b", "legacy"),
                                   ("interleaved", "even")))},
}


def config(layers: int, arch: str = "gpt2m"):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               n_layers=layers)


def train_config(micro: int):
    return dataclasses.replace(plan_worker.train_config(),
                               microbatches=micro)


def make_batch(vocab: int, batch: int, cfg=None):
    """Tokens, labels (a tenth masked, so the microbatches hold different
    token counts) and ragged positions (``arange + b % 3``, as in
    ``pipeline_check``), from a seed; an encoder-decoder's ``frames``
    [batch, F, d] x 0.02 (``cfg``, either package's config) too.  An MoE
    model's labels are all live: its microbatches, each routed as one,
    then hold equal token counts, as ``grad_accum``'s do."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, vocab, (batch, SEQ))
    if cfg is None or cfg.family != "moe":
        labels[rng.random((batch, SEQ)) < 0.1] = -1
    out = {"tokens": rng.integers(0, vocab, (batch, SEQ)),
           "labels": labels,
           "positions": np.arange(SEQ)[None]
           + (np.arange(batch)[:, None] % 3)}
    if cfg is not None and cfg.family == "encdec":
        out["frames"] = np.asarray(rng.standard_normal(
            (batch, cfg.enc_seq_len, cfg.d_model)) * 0.02, np.float32)
    return out


def scenario_config(sc):
    return config(sc["layers"], sc.get("arch", "gpt2m"))


def line_topology(gpus: str):
    from repro_torch.core.topology import Link, Site, line
    names = gpus.split(",")
    return line("hetline", [Site((g,), name=f"S{i}")
                            for i, g in enumerate(names)],
                [Link(20e-3, 3.0)] * (len(names) - 1))


def searched_placement(gpus: str, layers: int, micro: int, batch: int,
                       schedule: str):
    """The searched pipeshard ``Placement`` over every site in site
    order, as ``launch.pipeline_check`` takes it."""
    from repro_torch.core.costmodel import Workload
    from repro_torch.core.search import PlanSearch
    topo = line_topology(gpus)
    n = len(topo.sites)
    search = PlanSearch(Workload(config(layers), SEQ, batch,
                                 steps_per_epoch=1, microbatches=micro),
                        topo, stage_balance="tflops",
                        schedules=(schedule,))
    cand = next(c for c in search.candidates()
                if c.technique == "pipeshard" and c.sites == tuple(range(n))
                and c.stage_order == tuple(range(n))
                and c.schedule == schedule)
    return search.placement(cand)


def column_sum(mesh, value: float) -> float:
    """``value`` summed over the stage ranks at this rank's (data, model)
    place."""
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.group("stage"))
    return float(t[0])


def per_stage(mesh, value: int):
    """Every stage's ``value`` at this rank's (data, model) place."""
    t = torch.zeros(mesh.shape["stage"], dtype=torch.float64)
    t[mesh.coord["stage"]] = value
    dist.all_reduce(t, group=mesh.group("stage"))
    return [int(x) for x in t]


def digests(tree):
    """Each leaf's bytes, hashed: bit-equality without the arrays."""
    import hashlib
    return {k: hashlib.sha1(v.tobytes()).hexdigest()
            for k, v in plan_worker.numpy_tree(tree).items()}


def leaf_stats(got, want):
    """Per leaf: (max |got - want|, max |want|, max |got|), what the
    tests' leaf-by-leaf tolerance reads."""
    got = plan_worker.numpy_tree(got)
    return {k: (float(np.abs(got[k] - w).max()), float(np.abs(w).max()),
                float(np.abs(got[k]).max())) for k, w in want.items()}


def run_one(sc, schedule, split_name, batch, ref_grads):
    from repro_torch.core import sharding
    from repro_torch.core.costmodel import parse_schedule
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import (
        make_pipeline_mesh, placement_pipeline_mesh)
    from repro_torch.models import Model
    cfg, tcfg = scenario_config(sc), train_config(sc["micro"])
    _, v = parse_schedule(schedule)
    if "gpus" in sc:
        placement = searched_placement(sc["gpus"], sc["layers"],
                                       sc["micro"], sc["batch"], schedule)
        mesh = placement_pipeline_mesh(line_topology(sc["gpus"]),
                                       placement)
        searched = placement.stage_layers
    else:
        mesh = make_pipeline_mesh(sc["shape"], AXES, 2, schedule=schedule)
        searched = None
    n_chunks = mesh.shape["stage"] * v
    split = {"searched": searched, "legacy": None,
             "even": (sc["layers"] // n_chunks,) * n_chunks}[split_name]
    model = Model(cfg, device="cpu")
    step = build_train_step(model, tcfg, plan="pipeshard", mesh=mesh,
                            stage_layers=split, schedule=schedule)
    params = step.shard_params(plan_worker.init_params(model))
    opt = step.init_opt_state()
    sharding.reset_collective_counts()
    loss1, metrics, grads = step.grads(params, batch)
    sends = sharding.collective_counts()["send"]["calls"]
    peaks = per_stage(mesh, step.runner.peak_in_flight)
    params, opt, metrics = step.apply(params, opt, loss1, metrics, grads)
    grads = step.gather_params(grads)
    losses = [float(metrics["loss"])]
    for _ in range(STEPS - 1):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    full = step.gather_params(params)
    return {"split": None if split is None else list(split),
            "n_stages": mesh.shape["stage"], "virt": v,
            "loss1": float(loss1), "losses": losses,
            "grad_stats": None if ref_grads is None
            else leaf_stats(grads, ref_grads),
            "grad_digests": digests(grads), "param_digests": digests(full),
            "param_norm": plan_worker.param_norm(full),
            "sends_a_step": column_sum(mesh, sends),
            "peak_in_flight": peaks}


def run(rank: int, world: int, init: str, out: str) -> None:
    """Every scenario of the world; rank 0 saves per run the losses,
    the step-1 gradients' leaf statistics against the one-device port's,
    digests of those gradients and of the params after ``STEPS`` steps,
    the sends a step and each stage's peak of graphs held."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import placement_pipeline_mesh
    from repro_torch.models import Model
    from repro_torch.train import train
    res = {"world": world, "scenarios": {}}
    for name, sc in SCENARIOS[world].items():
        cfg = scenario_config(sc)
        batch = make_batch(cfg.vocab_size, sc["batch"], cfg)
        rec = {"runs": {}, "batch": batch, "layers": sc["layers"]}
        ref_grads = None
        if rank == 0 and cfg.family == "moe":
            one = family_worker.one_device(cfg, dataclasses.replace(
                train_config(sc["micro"]), grad_accum=sc["micro"]), batch)
        elif rank == 0:
            one = plan_worker.one_device(cfg, train_config(sc["micro"]),
                                         batch)
        if rank == 0:
            ref_grads = one.pop("grads")
            one.pop("params")
            rec["one_device"] = one
        for schedule, split_name in sc["runs"]:
            rec["runs"][f"{split_name}@{schedule}"] = run_one(
                sc, schedule, split_name, batch, ref_grads)
        res["scenarios"][name] = rec
    if world == 2:
        # a pipeshard checkpoint (1F1B, the searched split), written by
        # rank 0 in the one-device layout
        sc = SCENARIOS[2]["A30,T4"]
        cfg = config(sc["layers"])
        placement = searched_placement(sc["gpus"], sc["layers"],
                                       sc["micro"], plan_worker.BATCH,
                                       "1f1b")
        ckpt = os.path.join(os.path.dirname(out), "ckpt")
        train(Model(cfg, device="cpu"), train_config(sc["micro"]),
              plan_worker.make_loader(cfg.vocab_size), steps=CKPT_STEPS,
              ckpt_dir=ckpt, log_every=0, plan="pipeshard",
              mesh=placement_pipeline_mesh(line_topology(sc["gpus"]),
                                           placement),
              stage_layers=placement.stage_layers, schedule="1f1b")
        res["ckpt"] = ckpt
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def spawn(out: str, world: int) -> None:
    """Run ``world`` ranks of ``run``; rank 0 writes ``out``."""
    rdzv = tempfile.mkdtemp(dir=os.path.dirname(out))
    mp.start_processes(run, args=(world, f"file://{rdzv}/store", out),
                       nprocs=world, start_method="fork")


if __name__ == "__main__":
    # torch.utils.checkpoint imports torch._dynamo on its first call
    # (seconds of CPU): once here, before the ranks fork
    import torch._dynamo  # noqa: F401
    spawn(os.path.abspath(sys.argv[1]), int(sys.argv[2]))
