"""Cross-plan reshard and chaos-recovery parity check of the port
(counterpart of ``repro.launch.reshard_check``).

Two modes, one JSON report on stdout (the reference's keys, and a few
more):

  * **place** (default): train a few steps under a SOURCE plan on a line
    topology of single-GPU sites (one rank a site: site i is rank i),
    checkpoint, then ``reshard_checkpoint`` onto a DESTINATION (plan x
    placement x stage_layers) layout.  Checks:
      - every resharded block — params and AdamW moments — is bit-exact
        against the host-side reference re-placement
        (``train.reshard.reshard_state``: ``params_bitexact``,
        ``opt_bitexact``) and against the destination step's own cut of
        the restored state (``layout_bitexact``); ``split_leaves`` counts,
        for each destination rank, the leaves it holds only a block of;
      - the blocks gathered back are the checkpoint's, bit for bit
        (``host_bitexact``);
      - one further step under the destination from the resharded state
        gives exactly the loss of a control that restored the same
        checkpoint without the reshard code (``loss_resharded``,
        ``loss_control``); the source plan's own continuation is
        reported beside them (``loss_src_continue``).

        PYTHONPATH=src python -m torch.distributed.run --standalone \\
            --nproc_per_node 2 -m repro_torch.launch.reshard_check \\
            --device cpu --src-plan zero2 --src-sites 0,1 \\
            --dst-plan fsdp --dst-sites 0

  * **chaos** (``--chaos``): a two-site pipeshard run is killed at
    ``--kill-step`` (``kill_site_at``), replanned onto the survivor,
    resharded and resumed (``train.replan.train_elastic``); the dead
    site's rank leaves the run.  Checks the resharded state is
    bit-exact against the host reference and the resumed losses equal
    a control on the survivors' mesh started from the same checkpoint.

The world needs a rank for every site the check names (two at least);
under ``torch.distributed.run`` NCCL on ``cuda:LOCAL_RANK``, or gloo
with ``--device cpu``.  ``check`` runs a parsed command line on a world
that is already up (the tests' forked gloo ranks).  ``--full`` takes
the architecture at its full width (``--layers`` 0: its full depth).
"""
import argparse
import json
import os
import shutil
import tempfile


def _sites(spec: str):
    return tuple(int(x) for x in spec.split(",") if x.strip() != "")


def _split(spec):
    return None if not spec else tuple(int(x) for x in spec.split(","))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2m")
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default the reduced one)")
    ap.add_argument("--layers", type=int, default=0,
                    help="layers (0: 4 reduced, the config's with --full)")
    ap.add_argument("--dtype", default=None,
                    help="compute dtype (default the config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, kernels) or cpu (gloo)")
    ap.add_argument("--steps", type=int, default=2,
                    help="source-run steps before the checkpoint")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # place mode
    ap.add_argument("--src-plan", default="zero2")
    ap.add_argument("--src-sites", default="0,1")
    ap.add_argument("--src-order", default="")
    ap.add_argument("--src-layers", default="",
                    help="source stage_layers, e.g. 2,2 (pipeline only)")
    ap.add_argument("--src-schedule", default="gpipe")
    ap.add_argument("--dst-plan", default="fsdp")
    ap.add_argument("--dst-sites", default="0")
    ap.add_argument("--dst-order", default="")
    ap.add_argument("--dst-layers", default="")
    ap.add_argument("--dst-schedule", default="gpipe")
    # chaos mode
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--kill-step", type=int, default=3)
    ap.add_argument("--dead", default="1")
    ap.add_argument("--total-steps", type=int, default=6)
    ap.add_argument("--ckpt-every", type=int, default=2)
    return ap.parse_args(argv)


def leaves_equal(a, b):
    """(every leaf bit-equal, largest absolute difference) of two trees
    of tensors of one structure."""
    import torch

    from repro_torch.train.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    if sorted(fa) != sorted(fb):
        return False, float("inf")
    exact, diff = True, 0.0
    for k, x in fa.items():
        y = fb[k].to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False, float("inf")
        exact = exact and torch.equal(x, y)
        if x.numel():
            diff = max(diff, float((x.double() - y.double()).abs().max()))
    return exact, diff


def copy_to(tree, device):
    """A fresh copy of a tree of tensors (an ``AdamWState`` too) on
    ``device``: every control and continuation takes its own, since a
    step at a world of one may hand back the tensors it was given."""
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map
    if isinstance(tree, AdamWState):
        return AdamWState(*(copy_to(t, device) for t in tree))
    return tree_map(lambda t: t.to(device, copy=True), tree)


def split_leaves(model, params, opt):
    """How many of this rank's params and moments are blocks smaller
    than the whole leaf (a stage's rows, or a cut over a mesh axis)."""
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.reshard import state_templates
    p_like, o_like = state_templates(model)
    return sum(t.numel() < flatten(like)[k].numel()
               for tree, like in ((params, p_like), (opt.m, o_like.m),
                                  (opt.v, o_like.v))
               for k, t in flatten(tree).items())


def host_state(ckpt, model):
    """The checkpoint in the one-device layout on the host (no sha256:
    ``reshard_checkpoint`` checked the same files)."""
    import torch

    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import restore_checkpoint
    from repro_torch.train.reshard import state_templates
    p_like, o_like = state_templates(model)
    cpu = (lambda t: torch.empty(t.shape, dtype=t.dtype))
    params, opt, _ = restore_checkpoint(
        ckpt, tree_map(cpu, p_like),
        type(o_like)(cpu(o_like.step), tree_map(cpu, o_like.m),
                     tree_map(cpu, o_like.v)), verify=False)
    return params, opt


def _shared_dir() -> str:
    """A temporary checkpoint directory every rank of the world uses."""
    import torch.distributed as dist
    path = [tempfile.mkdtemp(prefix="reshard_check_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, src=0)
    return path[0]


def build(args, device):
    """(model, topology, loader) of a parsed command line."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.topology import Link, Site, line
    from repro_torch.data import (Loader, Tokenizer, build_dataset,
                                  synthetic_wikipedia)
    from repro_torch.models import Model, trains_through_kernels

    texts = list(synthetic_wikipedia(60, seed=args.seed))
    tok = Tokenizer.train(texts, 256)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    layers = args.layers or (cfg.n_layers if args.full else 4)
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              vocab_size=tok.vocab_size,
                              max_seq_len=max(cfg.max_seq_len, args.seq))
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    ds = build_dataset(texts, tok, seq_len=args.seq)
    loader = Loader(ds, global_batch=args.batch, seed=args.seed)
    model = Model(cfg, device=device, use_kernels=trains_through_kernels(cfg))
    named = _sites(args.src_sites) + _sites(args.dst_sites)
    n_sites = max([2] + [s + 1 for s in named])
    topo = line("elastic-line",
                [Site(("A30",), name=f"V{i + 1}") for i in range(n_sites)],
                [Link(20e-3, 3.0)] * (n_sites - 1))
    return model, topo, loader


def check(args, device):
    """Run the check on this rank of a world that is up; the report on
    the rank that prints it, None on the others.  That rank is the last
    to use the checkpoints (the place mode's ranks gather to it, the
    chaos mode's survivors too), so it removes the checkpoints."""
    model, topo, loader = build(args, device)
    ckpt_dir = _shared_dir()
    run = run_chaos if args.chaos else run_place
    report = run(args, model, topo, loader, ckpt_dir)
    if report is not None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return report


def run_place(args, model, topo, loader, ckpt_dir):
    import time

    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.core.plans import Placement, get_plan
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import placement_mesh
    from repro_torch.train import reshard_checkpoint, reshard_state, train

    def _place(sites, order, layers, schedule):
        return Placement(sites, _sites(order) if order else None,
                         _split(layers), schedule=schedule)

    src_plan, dst_plan = get_plan(args.src_plan), get_plan(args.dst_plan)
    src_place = _place(_sites(args.src_sites), args.src_order,
                       args.src_layers, args.src_schedule)
    dst_place = _place(_sites(args.dst_sites), args.dst_order,
                       args.dst_layers, args.dst_schedule)
    # one rank a single-GPU site: rank i <-> site i
    src_mesh = placement_mesh(topo, src_plan, src_place,
                              ranks=list(src_place.sites))
    dst_mesh = placement_mesh(topo, dst_plan, dst_place,
                              ranks=list(dst_place.sites))
    k = args.steps
    tcfg = TrainConfig(warmup_steps=1, total_steps=k + 1, seed=args.seed,
                       microbatches=args.micro)
    dev = model.device

    def run(plan, mesh, place, params, opt, sharded=False):
        return train(model, tcfg, loader, steps=k + 1, start_step=k,
                     params=params, opt_state=opt, sharded=sharded,
                     log_every=0, stage_layers=place.stage_layers,
                     schedule=place.schedule, plan=plan, mesh=mesh).losses

    mine = {}
    if src_mesh.holds_me:
        res = train(model, tcfg, loader, steps=k, log_every=0,
                    ckpt_dir=ckpt_dir, stage_layers=src_place.stage_layers,
                    schedule=src_place.schedule, plan=src_plan,
                    mesh=src_mesh)
        mine.update(src_losses=res.losses, save_s=res.save_times)
        del res
    dist.barrier()                  # the checkpoint is whole on disk
    ckpt = os.path.join(ckpt_dir, f"step_{k:08d}")
    if dst_mesh.holds_me:
        t0 = time.perf_counter()
        params_r, opt_r, step0 = reshard_checkpoint(
            ckpt, model, dst_plan, dst_mesh, placement=dst_place)
        mine["reshard_s"] = time.perf_counter() - t0
        params_h, opt_h = host_state(ckpt, model)
        params_ref, opt_ref = reshard_state(
            params_h, opt_h, dst_plan, model.cfg, dst_mesh,
            placement=dst_place, device=dev)
        mine["p"] = leaves_equal(params_r, params_ref)
        mine["o"] = leaves_equal(opt_r, opt_ref)
        mine["split"] = split_leaves(model, params_r, opt_r)
        del params_ref, opt_ref
        step_fn = build_train_step(model, tcfg, plan=dst_plan, mesh=dst_mesh,
                                   stage_layers=dst_place.stage_layers,
                                   schedule=dst_place.schedule)
        own_p = step_fn.shard_params(copy_to(params_h, dev))
        own_o = step_fn.shard_opt_state(copy_to(opt_h, dev))
        mine["layout"] = leaves_equal(params_r, own_p)[0] and \
            leaves_equal(opt_r, own_o)[0]
        del own_p, own_o
        mine["host"] = leaves_equal(step_fn.gather_params(params_r),
                                    params_h)[0]
        mine["step"] = step0
        mine["loss_resharded"] = run(dst_plan, dst_mesh, dst_place,
                                     copy_to(params_r, dev),
                                     copy_to(opt_r, dev), sharded=True)
        del params_r, opt_r
        mine["loss_control"] = run(dst_plan, dst_mesh, dst_place,
                                   copy_to(params_h, dev),
                                   copy_to(opt_h, dev))
    if src_mesh.holds_me:
        params_h, opt_h = host_state(ckpt, model)
        mine["loss_src_continue"] = run(src_plan, src_mesh, src_place,
                                        copy_to(params_h, dev),
                                        copy_to(opt_h, dev))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() != 0:
        return None
    dst = [every[r] for r in dst_mesh.ranks]
    first_dst, first_src = every[dst_mesh.first_rank], \
        every[src_mesh.first_rank]
    return {
        "mode": "place", "step": first_dst["step"],
        "src": f"{args.src_plan}@{src_place.sites}",
        "dst": f"{args.dst_plan}@{dst_place.sites}",
        "params_bitexact": all(r["p"][0] for r in dst),
        "opt_bitexact": all(r["o"][0] for r in dst),
        "host_bitexact": all(r["host"] for r in dst),
        "layout_bitexact": all(r["layout"] for r in dst),
        "max_param_diff": max(r["p"][1] for r in dst),
        "max_opt_diff": max(r["o"][1] for r in dst),
        "dst_ranks": len(dst), "split_leaves": [r["split"] for r in dst],
        "loss_resharded": first_dst["loss_resharded"],
        "loss_control": first_dst["loss_control"],
        "loss_src_continue": first_src["loss_src_continue"],
        "src_losses": first_src["src_losses"],
        "save_s": first_src["save_s"],
        "reshard_s": max(r["reshard_s"] for r in dst),
    }


def run_chaos(args, model, topo, loader, ckpt_dir):
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.core.plans import Placement, get_plan
    from repro_torch.train import (kill_site_at, reshard_checkpoint,
                                   reshard_state, train, train_elastic)

    dead = _sites(args.dead)
    total = args.total_steps
    tcfg = TrainConfig(warmup_steps=1, total_steps=total, seed=args.seed,
                       microbatches=args.micro)
    run = train_elastic(
        model, topo, "pipeshard", Placement((0, 1)), tcfg, loader,
        steps=total, ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
        on_step_failure=kill_site_at(args.kill_step, dead),
        log_every=0, log_fn=lambda s: None)
    if run.left:                    # a dead site's rank: nothing more
        return None
    rp, mesh = run.replan, run.mesh
    ckpt = os.path.join(ckpt_dir, f"step_{run.resumed_from:08d}")
    plan = get_plan(rp.technique)
    dev = model.device
    # the survivors' mesh: a new one would need the dead ranks' groups
    params_r, opt_r, _ = reshard_checkpoint(ckpt, model, plan, mesh,
                                            placement=rp.placement)
    params_h, opt_h = host_state(ckpt, model)
    params_ref, opt_ref = reshard_state(params_h, opt_h, plan, model.cfg,
                                        mesh, placement=rp.placement,
                                        device=dev)
    mine = {"p": leaves_equal(params_r, params_ref),
            "o": leaves_equal(opt_r, opt_ref)}
    del params_r, opt_r, params_ref, opt_ref
    control = train(model, tcfg, loader, steps=total,
                    start_step=run.resumed_from,
                    params=copy_to(params_h, dev),
                    opt_state=copy_to(opt_h, dev), log_every=0,
                    stage_layers=rp.placement.stage_layers,
                    schedule=rp.placement.schedule, plan=plan, mesh=mesh)
    every = [None] * len(mesh.ranks)
    dist.all_gather_object(every, mine, group=mesh.group(mesh.axis_names))
    if dist.get_rank() != mesh.first_rank:
        return None
    return {
        "mode": "chaos", "failed": run.failed,
        "kill_step": args.kill_step, "dead": list(dead),
        "technique": rp.technique, "sites_old": list(rp.sites_old),
        "resumed_from": run.resumed_from, "steps_lost": run.steps_lost,
        "params_bitexact": all(r["p"][0] for r in every),
        "opt_bitexact": all(r["o"][0] for r in every),
        "max_param_diff": max(r["p"][1] for r in every),
        "max_opt_diff": max(r["o"][1] for r in every),
        "losses_pre": run.pre.losses, "losses_post": run.result.losses,
        "losses_control": control.losses,
        "search_s": run.search_s, "reshard_s": run.reshard_s,
        "recovery_s": run.recovery_s,
    }


def main(argv=None) -> None:
    args = parse(argv)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world
    dev = init_world(args.device)
    try:
        report = check(args, dev)
        if report is not None:
            print(json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
