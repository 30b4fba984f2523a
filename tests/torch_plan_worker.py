"""One rank of the gloo worlds of ``tests/test_torch_plans.py``.

Every rank of a world runs every flat plan (data, zero2, shard,
shard_zero) on small fp32 models of the port, beside the one-device
step on the same params and batch; rank 0 saves what the tests compare
(``torch.save`` of plain Python and numpy).  Imports no JAX: the
one-device port is the yardstick here, and the other port tests hold
it to the JAX reference.

    python tests/torch_plan_worker.py OUT WORLD MESH     # e.g. 4 1,2,2
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

AXES = ("pod", "data", "model")
PLAN_NAMES = ("data", "zero2", "shard", "shard_zero")
# name -> (arch, overrides of its reduced config): MHA with every leaf
# cut under shard; GQA; a vocab (509) that divides no model axis, so the
# table and logits stay whole, with one kv head, so wk and wv stay whole
# while the q heads are cut; and the SSM family, which runs under data
# and zero2 only
CASES = {"gpt2m": ("gpt2m", {}),
         "llama_gqa": ("llama3.2-3b", {"n_kv_heads": 2}),
         "vocab509": ("llama3.2-3b", {"n_kv_heads": 1, "vocab_size": 509}),
         "falcon": ("falcon-mamba-7b", {})}
STEPS, BATCH, SEQ = 3, 8, 16
# the collective count a layer: gpt2m at these depths under shard
COUNT_LAYERS = (2, 3)
CKPT_STEPS = 2


def plans_of(case: str):
    return PLAN_NAMES[:2] if case == "falcon" else PLAN_NAMES


def case_config(name: str, **extra):
    from repro_torch.configs import get_config
    arch, kw = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw, **extra)


def train_config():
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def make_batch(vocab: int):
    """Tokens and labels from a seed, a tenth of the labels masked (so
    the ranks' slices hold different token counts)."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, vocab, (BATCH, SEQ))
    labels[rng.random((BATCH, SEQ)) < 0.1] = -1
    return {"tokens": rng.integers(0, vocab, (BATCH, SEQ)), "labels": labels}


def make_loader(vocab: int):
    from repro_torch.data import Loader
    from repro_torch.data.pipeline import PackedDataset
    rng = np.random.default_rng(1)
    ds = PackedDataset(rng.integers(0, vocab, (4 * BATCH, SEQ + 1))
                       .astype(np.int32), SEQ)
    return Loader(ds, global_batch=BATCH, seed=0)


def init_params(model):
    return model.init(torch.Generator().manual_seed(0))


def numpy_tree(tree):
    from repro_torch.convert import flatten
    return {k: v.detach().numpy().copy() for k, v in flatten(tree).items()}


def param_norm(tree) -> float:
    from repro_torch.optim.adamw import tree_leaves
    return float(torch.sqrt(sum(t.double().square().sum()
                                for t in tree_leaves(tree))))


def one_device(cfg, tcfg, batch):
    from repro_torch.core.steps import build_train_step, value_and_grad
    from repro_torch.models import Model
    from repro_torch.optim import init_adamw
    model = Model(cfg, device="cpu")
    params = init_params(model)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, _, grads = value_and_grad(lambda p, b: model.loss(p, b), params, tb)
    step = build_train_step(model, tcfg)
    opt, losses = init_adamw(params), []
    for _ in range(STEPS):
        params, opt, metrics = step(params, opt, tb)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "grads": numpy_tree(grads),
            "params": numpy_tree(params), "param_norm": param_norm(params)}


def under_plan(cfg, tcfg, batch, plan, mesh):
    from repro_torch.core.sharding import gather_tree
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    model = Model(cfg, device="cpu")
    step = build_train_step(model, tcfg, plan=plan, mesh=mesh)
    params = step.shard_params(init_params(model))
    opt = step.init_opt_state()
    _, _, grads = step.grads(params, batch)
    grads = gather_tree(grads, step.update_specs, mesh)
    losses = []
    for _ in range(STEPS):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    full = step.gather_params(params)
    axis = model.model_axis
    out = {"losses": losses, "grads": numpy_tree(grads),
           "params": numpy_tree(full), "param_norm": param_norm(full),
           "model_axis": None if axis is None else {
               k: getattr(axis, k) for k in ("size", "rank", "vocab",
                                             "positions", "heads",
                                             "kv_heads", "mlp")}}
    if plan == "zero2":
        from repro_torch.convert import flatten
        from repro_torch.core.sharding import spec_axes
        shapes = flatten(step._shapes)
        specs, m, v = (flatten(t) for t in (step.opt_specs, opt.m, opt.v))
        out["moments"] = {k: (tuple(shapes[k].shape), tuple(m[k].shape),
                              tuple(v[k].shape), mesh.count(spec_axes(s))
                              if spec_axes(s) else 1)
                          for k, s in specs.items()}
    return out


@contextmanager
def world_of_one():
    """A gloo world of one rank in this process, started (and ended)
    here where there is none."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def mesh_of_one(plan: str):
    """The mesh of one rank a plan runs on: (pod, data, model), or one
    stage of it for a pipeline."""
    from repro_torch.core.plans import get_plan
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    if get_plan(plan).pipeline:
        return make_pipeline_mesh((1, 1, 1), AXES, 1)
    return make_host_mesh((1, 1, 1), AXES)


def steps_at_world_of_one(cfg, plan: str, steps: int = 2):
    """``steps`` steps of ``plan`` at a gloo world of one in this process
    (one microbatch under pipeshard, so that the MoE family routes the
    batch as one device does) and of one device, from ``init_params``
    on ``make_batch``: (the plan's losses, one device's, whether the
    params after are bit-equal)."""
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    tcfg = dataclasses.replace(train_config(), microbatches=1)
    batch = {k: torch.as_tensor(v)
             for k, v in make_batch(cfg.vocab_size).items()}
    out = []
    with world_of_one():
        for p in (plan, None):
            model = Model(cfg, device="cpu")
            step = build_train_step(model, tcfg, plan=p,
                                    mesh=None if p is None
                                    else mesh_of_one(p))
            params = init_params(model)
            if p is not None:
                params = step.shard_params(params)
                opt = step.init_opt_state()
            else:
                from repro_torch.optim import init_adamw
                opt = init_adamw(params)
            losses = []
            for _ in range(steps):
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["loss"]))
            if p is not None:
                params = step.gather_params(params)
            out.append((losses, numpy_tree(params)))
    (got, got_p), (want, want_p) = out
    return got, want, all(np.array_equal(got_p[k], v)
                          for k, v in want_p.items())


def layer_counts(mesh):
    """Collectives of one shard step (remat) of gpt2m at two depths."""
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim.adamw import tree_leaves
    out = {}
    for L in COUNT_LAYERS:
        cfg = case_config("gpt2m", n_layers=L)
        model = Model(cfg, device="cpu")
        step = build_train_step(model, train_config(), plan="shard",
                                mesh=mesh)
        params = step.shard_params(init_params(model))
        opt = step.init_opt_state()
        sharding.reset_collective_counts()
        step(params, opt, make_batch(cfg.vocab_size))
        out[L] = {"counts": sharding.collective_counts(),
                  "layer_numel": sum(t.numel() for t in
                                     tree_leaves(params["layers"])),
                  "batch_axes": step.batch_axes(BATCH)}
    return out


def run(rank: int, world: int, shape, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.train import train
    mesh = make_host_mesh(shape, AXES)
    res = {"world": world, "shape": tuple(shape), "cases": {}}
    tcfg = train_config()
    for name in CASES:
        cfg = case_config(name)
        batch = make_batch(cfg.vocab_size)
        rec = {"one_device": one_device(cfg, tcfg, batch)}
        for plan in plans_of(name):
            rec[plan] = under_plan(cfg, tcfg, batch, plan, mesh)
        res["cases"][name] = rec
    res["layer_counts"] = layer_counts(mesh)
    # a shard-plan checkpoint, written by rank 0 in the one-device layout
    cfg = case_config("gpt2m")
    ckpt = os.path.join(os.path.dirname(out), "ckpt")
    train(Model(cfg, device="cpu"), tcfg, make_loader(cfg.vocab_size),
          steps=CKPT_STEPS, ckpt_dir=ckpt, log_every=0, plan="shard",
          mesh=mesh)
    res["ckpt"] = ckpt
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def spawn(out: str, world: int, shape) -> None:
    """Run ``world`` ranks of ``run``; rank 0 writes ``out``."""
    rdzv = tempfile.mkdtemp(dir=os.path.dirname(out))
    mp.start_processes(run, args=(world, tuple(shape),
                                  f"file://{rdzv}/store", out),
                       nprocs=world, start_method="fork")


if __name__ == "__main__":
    spawn(os.path.abspath(sys.argv[1]), int(sys.argv[2]),
          [int(x) for x in sys.argv[3].split(",")])
