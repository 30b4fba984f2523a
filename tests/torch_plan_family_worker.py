"""One rank of the gloo worlds of ``tests/test_torch_plan_families.py``.

Every rank of a world runs the flat plans of each case on the mesh of
its world, and on worlds 2 and 4 the pipeline plan of the SSM, hybrid,
MoE, vision-language and encoder-decoder families on two stages; the
world of one also runs the
one-device port of every case on the same params and batch, the
yardstick of every world (one device computes the same bits in every
process); the world of 2 also runs deepseek-v2's top-6 combine over a
model axis of 2.  Rank 0 saves what the tests compare (``torch.save`` of plain
Python and numpy).  Imports no JAX.

    python tests/torch_plan_family_worker.py OUT WORLD
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

import torch_plan_worker as plan_worker  # noqa: E402

AXES = ("pod", "data", "model")
# world -> the flat plans' mesh, and the (pod, data, model) shape a
# pipeline cuts into two stages (2 stages; 2 stages x data 2)
FLAT = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 2, 2)}
PIPE = {2: (2, 1, 1), 4: (2, 2, 1)}
FLAT_PLANS = ("data", "zero2", "shard", "shard_zero", "fsdp")
SSM_PLANS = ("shard", "shard_zero", "fsdp")
# name -> (arch, overrides of its reduced config, flat plans): the MoE
# family's four experts cut over a model axis of two, three experts that
# stay whole, and a shared expert, which takes the dense MLP's cut;
# zamba2 with three heads of 128, which a model axis of two cannot cut,
# so each rank computes its Mamba2 layers whole (the last three on the
# world of 2 alone, a model axis of two); the vision-language family,
# its batch carrying patch embeddings, and the encoder-decoder, its
# batch carrying frames (``with_extras``)
CASES = {
    "gpt2m": ("gpt2m", {}, ("fsdp",)),
    "moe": ("phi3.5-moe-42b-a6.6b", {}, FLAT_PLANS),
    "moe_e3": ("phi3.5-moe-42b-a6.6b", {"n_experts": 3}, ("shard",)),
    "moe_shared": ("phi3.5-moe-42b-a6.6b", {"n_shared_experts": 1},
                   ("shard",)),
    "falcon": ("falcon-mamba-7b", {}, SSM_PLANS),
    "zamba2": ("zamba2-2.7b", {}, SSM_PLANS),
    "zamba2_nh3": ("zamba2-2.7b", {"d_model": 192, "head_dim": 128},
                   ("shard",)),
    "vlm": ("phi-3-vision-4.2b", {}, FLAT_PLANS),
    "whisper": ("whisper-small", {}, FLAT_PLANS),
    "mla": ("minicpm3-4b", {}, FLAT_PLANS),
    "mla_q": ("minicpm3-4b", {"q_lora_rank": 32}, ("shard",)),
    "dsv2": ("deepseek-v2-236b", {}, FLAT_PLANS),
    "dsv2_top6": ("deepseek-v2-236b", {"n_experts": 8, "top_k": 6},
                  ("shard",)),
}
# the MoE cases route each batch rank's tokens on their own: their
# yardstick is the one-device port with grad_accum = the batch ranks
# (1, 2 or 4 over the worlds' plans), on a batch whose groups hold
# equal token counts
MOE_ACCUM = {"moe": (1, 2, 4), "moe_e3": (1,), "moe_shared": (1,),
             "dsv2": (1, 2, 4), "dsv2_top6": (1, 2)}
ONLY_ON = {"moe_e3": 2, "moe_shared": 2, "zamba2_nh3": 2}
# the pipeline's cases: zamba2 at 4 layers (2 groups, one a stage)
PIPE_CASES = {"falcon": ("falcon-mamba-7b", {}),
              "zamba2": ("zamba2-2.7b", {"n_layers": 4}),
              "moe": ("phi3.5-moe-42b-a6.6b", {}),
              "vlm": ("phi-3-vision-4.2b", {}),
              "whisper": ("whisper-small", {}),
              "mla": ("minicpm3-4b", {}),
              "dsv2": ("deepseek-v2-236b", {})}
SCHEDULES = ("gpipe", "1f1b")
# two microbatches: 1F1B's stage 1 alternates (F B F B) where GPipe
# runs both forwards first
MICRO = 2
# the MoE drop cases: a capacity factor of 0.5 over 8 sequences of 32
# tokens, so that experts drop tokens on a shard of 2 or 4 sequences
# (capacity 17 of ~32 choices an expert, 33 of ~64), on the world (65 of
# ~128) and on a pipeline microbatch of 2 sequences (17 of ~32)
DROP_FACTOR, DROP_SEQ, DROP_MICRO = 0.5, 32, 4
DROP_PLANS = ("data", "shard")
# fsdp's gathers: gpt2m at two depths that cut alike, one step
COUNT_LAYERS = (2, 4)
# the collectives a step of each rank counts, for the dry run's
# (``launch/dryrun.py``) to equal: reduced gpt2m in bf16 (its kernel
# path on the meta device takes bf16), on the world of 4's flat mesh and
# its two stages
DRY_PLANS = ("data", "zero2", "shard", "pipeshard")
CKPT_STEPS = 2


def config(arch: str, **kw):
    """The reduced config of ``arch`` in fp32; ``n_experts``,
    ``n_shared_experts``, ``capacity_factor`` and ``head_dim`` reach the
    MoE and SSM sub-configs."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    moe = {k: kw.pop(k) for k in ("n_experts", "n_shared_experts",
                                  "capacity_factor", "top_k") if k in kw}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    if "q_lora_rank" in kw:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=kw.pop("q_lora_rank")))
    if "head_dim" in kw:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=kw.pop("head_dim")))
    return dataclasses.replace(cfg, **kw)


def case_config(name: str):
    arch, kw, _ = CASES[name]
    return config(arch, **kw)


def train_config(**kw):
    return dataclasses.replace(plan_worker.train_config(), **kw)


def drop_batch(vocab: int):
    """8 sequences of ``DROP_SEQ`` tokens and labels, a tenth masked."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, vocab, (plan_worker.BATCH, DROP_SEQ))
    labels[rng.random(labels.shape) < 0.1] = -1
    return {"tokens": rng.integers(0, vocab, labels.shape),
            "labels": labels}


def with_extras(cfg, batch):
    """``batch`` with a vision-language model's ``patch_embeds`` [B, P,
    vision_dim], or an encoder-decoder's ``frames`` [B, F, d] (x 0.02,
    from a seed), as their launchers make them; the batch itself for the
    other families."""
    rng = np.random.default_rng(4)
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        return dict(batch, patch_embeds=np.asarray(rng.standard_normal(
            (B, cfg.n_patches, cfg.vision_dim)) * 0.02, np.float32))
    if cfg.family == "encdec":
        return dict(batch, frames=np.asarray(rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)) * 0.02, np.float32))
    return batch


def unmasked(batch):
    """``batch`` with every label live: grad_accum divides each
    microbatch by its own token count, a pipeline by the whole batch's,
    which agree when the counts are equal."""
    return dict(batch, labels=np.where(batch["labels"] < 0,
                                       batch["tokens"], batch["labels"]))


def axis_record(axis):
    if axis is None:
        return None
    return {k: getattr(axis, k) for k in
            ("size", "rank", "vocab", "positions", "heads", "kv_heads",
             "mlp", "experts", "shared_experts", "d_inner", "ssm_cut")}


def one_device(cfg, tcfg, batch):
    """The one-device port: the step-1 gradients (of ``grad_accum``
    microbatches, as the step takes them) and ``STEPS`` steps."""
    from functools import partial

    from repro_torch.core.steps import _grad_fn
    from repro_torch.models import Model
    from repro_torch.optim import adamw_update, init_adamw, lr_at
    model = Model(cfg, device="cpu")
    params = plan_worker.init_params(model)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    # the one-device step's operations (``core.steps._one_device_step``)
    grad_fn = _grad_fn(model, tcfg, partial(model.loss, remat=tcfg.remat))
    opt, losses = init_adamw(params), []
    for i in range(plan_worker.STEPS):
        loss, _, g = grad_fn(params, tb)
        if i == 0:
            grads = plan_worker.numpy_tree(g)
        params, opt, _ = adamw_update(g, opt, params, tcfg,
                                      lr_at(opt.step, tcfg))
        losses.append(float(loss))
    return {"losses": losses, "grads": grads,
            "params": plan_worker.numpy_tree(params),
            "param_norm": plan_worker.param_norm(params)}


def under_plan(cfg, tcfg, batch, plan, mesh, **kw):
    """``STEPS`` steps under ``plan``: the step-1 loss, metrics and
    gradients (gathered, the one-device layout), the losses, the params
    after (gathered), the batch ranks and the model axis the step
    set."""
    from repro_torch.core.sharding import gather_tree
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    model = Model(cfg, device="cpu")
    step = build_train_step(model, tcfg, plan=plan, mesh=mesh, **kw)
    params = step.shard_params(plan_worker.init_params(model))
    opt = step.init_opt_state()
    out = step.grads(params, batch)
    loss1, metrics, grads = out
    full_g = step.gather_params(grads) if plan == "pipeshard" \
        else gather_tree(grads, step.update_specs, mesh)
    params, opt, last = step.apply(params, opt, *out)
    losses = [float(last["loss"])]
    for _ in range(plan_worker.STEPS - 1):
        params, opt, last = step(params, opt, batch)
        losses.append(float(last["loss"]))
    full = step.gather_params(params)
    axes = step.batch_axes(batch["tokens"].shape[0])
    # this rank's step-1 gradient blocks of the SSM leaves cut over the
    # model axis, and their specs (shard: the model axis alone)
    blocks = {}
    if plan == "shard" and model.model_axis is not None:
        from repro_torch.convert import flatten
        cut = dict(model.model_axis.ssm_cut)
        specs = flatten(step.param_specs)
        blocks = {k: (g.numpy().copy(), specs[k])
                  for k, g in flatten(grads).items()
                  if "/mamba/" in k and k.rsplit("/", 1)[1] in cut}
    return {"loss1": float(loss1),
            "metrics1": {k: float(v) for k, v in metrics.items()},
            "losses": losses, "grads": plan_worker.numpy_tree(full_g),
            "params": plan_worker.numpy_tree(full),
            "param_norm": plan_worker.param_norm(full),
            "batch_parts": mesh.count(axes) if axes else 1,
            "model_axis": axis_record(model.model_axis),
            "rank": dist.get_rank(), "blocks": blocks}


def case_batch(name: str, vocab: int):
    batch = with_extras(case_config(name), plan_worker.make_batch(vocab))
    return unmasked(batch) if name in MOE_ACCUM else batch


def flat_cases(mesh, world: int):
    tcfg = train_config()
    out = {}
    for name, (_, _, plans) in CASES.items():
        if ONLY_ON.get(name, world) != world:
            continue
        cfg = case_config(name)
        batch = case_batch(name, cfg.vocab_size)
        out[name] = {plan: under_plan(cfg, tcfg, batch, plan, mesh)
                     for plan in plans}
    return out


def pipe_case(name: str):
    """(config, batch, grad_accum of its yardstick): the MoE family's is
    the one-device port with ``grad_accum`` = m, which routes each
    microbatch as one, as pipeshard does, on a batch whose microbatches
    hold equal token counts."""
    arch, kw = PIPE_CASES[name]
    cfg = config(arch, **kw)
    batch = with_extras(cfg, plan_worker.make_batch(cfg.vocab_size))
    if cfg.family == "moe":
        return cfg, unmasked(batch), MICRO
    return cfg, batch, 1


def references():
    """The one-device port of every case: ``flat[name][grad_accum]``,
    ``pipe[name]``, and the losses of three ``train`` steps of gpt2m
    (``fsdp_checkpoint``'s yardstick)."""
    from repro_torch.models import Model
    from repro_torch.train import train
    flat = {}
    for name in CASES:
        cfg = case_config(name)
        batch = case_batch(name, cfg.vocab_size)
        flat[name] = {a: one_device(cfg, train_config(grad_accum=a), batch)
                      for a in MOE_ACCUM.get(name, (1,))}
    pipe = {}
    for name in PIPE_CASES:
        cfg, batch, accum = pipe_case(name)
        if PIPE_CASES[name] == CASES.get(name, (None, None))[:2]:
            pipe[name] = flat[name][accum]   # the same config and batch
            continue
        pipe[name] = one_device(cfg, train_config(grad_accum=accum), batch)
    cfg = case_config("gpt2m")
    losses = train(Model(cfg, device="cpu"), train_config(),
                   plan_worker.make_loader(cfg.vocab_size),
                   steps=CKPT_STEPS + 1, log_every=0).losses
    return {"flat": flat, "pipe": pipe, "train": losses}


def pipe_cases(mesh):
    """Each pipeline case under each schedule."""
    out = {}
    for name in PIPE_CASES:
        cfg, batch, _ = pipe_case(name)
        out[name] = {sched: under_plan(
            cfg, train_config(microbatches=MICRO), batch, "pipeshard",
            mesh, schedule=sched) for sched in SCHEDULES}
    return out


def drop_cases(flat_mesh, pipe_mesh):
    """The MoE family with dropping experts: the step-1 loss and metrics
    of ``DROP_PLANS`` on the flat mesh and of pipeshard (1F1B,
    ``DROP_MICRO`` microbatches) on the staged one, with the batch."""
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    cfg = config("phi3.5-moe-42b-a6.6b", capacity_factor=DROP_FACTOR)
    batch = drop_batch(cfg.vocab_size)
    runs = [(plan, flat_mesh, {}, train_config()) for plan in DROP_PLANS]
    runs.append(("pipeshard", pipe_mesh, {"schedule": "1f1b"},
                 train_config(microbatches=DROP_MICRO)))
    out = {"batch": batch}
    for plan, mesh, kw, tcfg in runs:
        model = Model(cfg, device="cpu")
        step = build_train_step(model, tcfg, plan=plan, mesh=mesh, **kw)
        loss, metrics, _ = step.grads(
            step.shard_params(plan_worker.init_params(model)), batch)
        out[plan] = {"loss": float(loss), "batch_axes": step.batch_axes(
            plan_worker.BATCH),
            **{k: float(v) for k, v in metrics.items()}}
    return out


def donated():
    """Two one-device steps of reduced gpt2m, functional and with
    ``donate``: whether they give the same losses, params and moments,
    and whether each returned the params it was given."""
    from repro_torch.convert import flatten
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    from repro_torch.optim import init_adamw
    cfg = case_config("gpt2m")
    batch = {k: torch.as_tensor(v)
             for k, v in plan_worker.make_batch(cfg.vocab_size).items()}
    runs, in_place = [], []
    for donate in (False, True):
        model = Model(cfg, device="cpu")
        step = build_train_step(model, train_config(), donate=donate)
        params = plan_worker.init_params(model)
        opt = init_adamw(params)
        given = flatten(params)["layers/mlp/w_up"]
        losses = []
        for _ in range(2):
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
        in_place.append(flatten(params)["layers/mlp/w_up"] is given)
        runs.append((losses, flatten(params), flatten(opt.m),
                     flatten(opt.v)))
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(runs[1][i][k], t) for i in (1, 2, 3)
        for k, t in runs[0][i].items())
    return {"same_bits": same, "in_place": in_place}


def builds():
    """Whether ``build_train_step`` builds every plan of ``PLANS`` for a
    model of each family (world 1; pipeshard on one stage): True, or
    the error's text."""
    from repro_torch.core.plans import PLANS
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    from repro_torch.models import Model
    out = {}
    for arch in ("gpt2m", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
                 "zamba2-2.7b", "phi-3-vision-4.2b", "whisper-small",
                 "minicpm3-4b", "deepseek-v2-236b"):
        for name, plan in PLANS.items():
            mesh = make_pipeline_mesh((1, 1, 1), AXES, 1) if plan.pipeline \
                else make_host_mesh((1, 1, 1), AXES)
            try:
                build_train_step(Model(config(arch), device="cpu"),
                                 train_config(), plan=name, mesh=mesh)
                out[(arch, name)] = True
            except NotImplementedError as e:
                out[(arch, name)] = str(e)
    return out


def top6_combine(mesh):
    """deepseek-v2's routed experts at top-6 of 8 (no shared expert, so
    that the combine is all the layer adds), the experts cut over the
    model axis of ``mesh``, and on one device, on the same tokens: both
    outputs, and of each token the experts on each model rank."""
    from repro_torch.core.sharding import ModelAxis
    from repro_torch.models import moe
    cfg = case_config("dsv2_top6")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=0))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)), dtype=torch.float32)
    M, r = mesh.shape["model"], mesh.coord["model"]
    E = cfg.moe.n_experts // M
    axis = ModelAxis(group=mesh.group("model"), size=M, rank=r, vocab=False,
                     positions=False, heads=False, kv_heads=False, mlp=False,
                     experts=True)
    mine = {k: v[r * E:(r + 1) * E] if k != "router" else v
            for k, v in p.items()}
    cut, _ = moe.moe_forward(x, mine, cfg, model_axis=axis)
    whole, _ = moe.moe_forward(x, p, cfg)
    choices = moe.route(x.reshape(-1, cfg.d_model), p, cfg)[2]
    # the control: each rank's partial sum, its experts' contributions
    # added in order (another rank's experts, their weights zeroed, add
    # zeros), then the ranks' sums added
    partial = 0
    for q in range(M):
        other = torch.tensor([e for e in range(cfg.moe.n_experts)
                              if e // E != q])
        masked = {k: v if k == "router" else v.index_fill(0, other, 0.0)
                  for k, v in p.items()}
        partial = partial + moe.moe_forward(x, masked, cfg)[0]
    return {"cut": cut.numpy(), "whole": whole.numpy(),
            "partial": partial.numpy(),
            "per_rank": [((choices // E) == q).sum(-1).numpy()
                         for q in range(M)]}


def fsdp_layout(mesh):
    """gpt2m under fsdp: each leaf's block and whole shapes and the
    spec's axes, and one step's collectives at two depths."""
    from repro_torch.convert import flatten
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    out = {"counts": {}}
    for L in COUNT_LAYERS:
        cfg = config("gpt2m", n_layers=L)
        model = Model(cfg, device="cpu")
        step = build_train_step(model, train_config(), plan="fsdp",
                                mesh=mesh)
        params = step.shard_params(plan_worker.init_params(model))
        opt = step.init_opt_state()
        if L == COUNT_LAYERS[0]:
            shapes, specs = flatten(step._shapes), flatten(step.param_specs)
            local, m = flatten(params), flatten(opt.m)
            out["leaves"] = {k: (tuple(shapes[k].shape),
                                 tuple(local[k].shape), tuple(m[k].shape),
                                 specs[k]) for k in shapes}
        sharding.reset_collective_counts()
        step(params, opt, plan_worker.make_batch(cfg.vocab_size))
        out["counts"][L] = sharding.collective_counts()
    return out


def dry_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gpt2m").reduced(),
                               dtype="bfloat16")


def dry_counts(flat, staged):
    """Every rank's ``collective_counts()`` of one step of each of
    ``DRY_PLANS`` (pipeshard on the staged mesh, ``MICRO``
    microbatches)."""
    from repro_torch.core import sharding
    from repro_torch.core.steps import build_train_step
    from repro_torch.models import Model
    cfg = dry_config()
    batch = plan_worker.make_batch(cfg.vocab_size)
    out = {}
    for plan in DRY_PLANS:
        model = Model(cfg, device="cpu")
        step = build_train_step(
            model, train_config(microbatches=MICRO), plan=plan,
            mesh=staged if plan == "pipeshard" else flat)
        params = step.shard_params(plan_worker.init_params(model))
        opt = step.init_opt_state()
        sharding.reset_collective_counts()
        step(params, opt, batch)
        mine = sharding.collective_counts()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[plan] = every
    return out


def fsdp_checkpoint(mesh, root: str):
    """gpt2m trains ``CKPT_STEPS`` steps under fsdp and writes a
    checkpoint (gathered, the one-device layout), which shard restores
    and runs the next step of."""
    from repro_torch.models import Model
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import restore_checkpoint, train
    cfg = case_config("gpt2m")
    tcfg = train_config()
    loader = plan_worker.make_loader(cfg.vocab_size)
    ckpt = os.path.join(root, "ckpt")
    whole = train(Model(cfg, device="cpu"), tcfg, loader, steps=CKPT_STEPS,
                  ckpt_dir=ckpt, log_every=0, plan="fsdp", mesh=mesh)
    like = tree_map(torch.empty_like, plan_worker.init_params(
        Model(cfg, device="cpu")))
    params, opt, _ = restore_checkpoint(
        os.path.join(ckpt, f"step_{CKPT_STEPS:08d}"), like, init_adamw(like))
    again = train(Model(cfg, device="cpu"), tcfg, loader,
                  steps=CKPT_STEPS + 1, params=params, opt_state=opt,
                  start_step=CKPT_STEPS, log_every=0, plan="shard",
                  mesh=mesh)
    return {"fsdp_losses": whole.losses, "shard_losses": again.losses,
            "ckpt": ckpt}


def run(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    flat = make_host_mesh(FLAT[world], AXES)
    res = {"world": world, "flat": flat_cases(flat, world)}
    if world == 1:
        res["builds"] = builds()
        res["donated"] = donated()
        res["one_device"] = references()
    if world == 2:
        res["top6"] = top6_combine(flat)
    if world in PIPE:
        # two stages; GPipe's and 1F1B's meshes are one
        staged = make_pipeline_mesh(PIPE[world], AXES, 2)
        res["pipe"] = pipe_cases(staged)
    if world == 4:
        res["dry_counts"] = dry_counts(flat, staged)
        res["drops"] = drop_cases(flat, staged)
        res["fsdp"] = fsdp_layout(flat)
        res["fsdp_ckpt"] = fsdp_checkpoint(flat, os.path.dirname(out))
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
