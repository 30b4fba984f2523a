"""One rank of the gloo worlds of ``tests/test_torch_elastic.py``.

Every rank of a world runs ``repro_torch.launch.reshard_check`` on the
world's scenarios in turn (reduced gpt2m in fp32, 4 layers unless the
scenario says otherwise, seq 16, batch 8, 4 microbatches), recording
every checkpoint it writes; the world of 2 also reshards a reduced
whisper-small state and a reduced deepseek-v2 state from shard to
pipeshard and back (``whisper_reshard``, ``dsv2_reshard``); each world
ends with a chaos drill, after which
its dead and spare ranks take part in nothing.  Each rank saves its
reports and records to ``OUT.<rank>`` (``torch.save`` of plain Python).
Imports no JAX.

    python tests/torch_elastic_worker.py OUT WORLD
"""
from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

COMMON = ["--device", "cpu", "--dtype", "float32", "--seq", "16",
          "--batch", "8", "--micro", "4"]
CHAOS = ["--chaos", "--kill-step", "3", "--dead", "1", "--total-steps", "6",
         "--ckpt-every", "2"]
# world -> (name, reshard_check arguments), run in this order; a chaos
# drill comes last, since its dead ranks take part in nothing after it
SCENARIOS = {
    2: (("zero2_to_fsdp", ["--src-plan", "zero2", "--src-sites", "0,1",
                           "--dst-plan", "fsdp", "--dst-sites", "0"]),
        # destinations that cut leaves across both ranks: fsdp's params
        # and moments, zero2's moments, over the (pod, data) axes
        ("data_to_fsdp2", ["--src-plan", "data", "--src-sites", "0",
                           "--dst-plan", "fsdp", "--dst-sites", "0,1"]),
        ("pipe_to_zero2", ["--src-plan", "pipeshard", "--src-sites", "0,1",
                           "--dst-plan", "zero2", "--dst-sites", "0,1"]),
        ("stage_order_reversal", ["--src-plan", "pipeshard",
                                  "--src-sites", "0,1",
                                  "--dst-plan", "pipeshard",
                                  "--dst-sites", "0,1", "--dst-order", "1,0",
                                  "--layers", "4"]),
        ("chaos", CHAOS)),
    3: (("data_to_pipe331", ["--src-plan", "data", "--src-sites", "0",
                             "--dst-plan", "pipeshard",
                             "--dst-sites", "0,1,2", "--dst-layers", "3,3,1",
                             "--layers", "7"]),
        ("pipe2_to_pipe3", ["--src-plan", "pipeshard", "--src-sites", "0,1",
                            "--dst-plan", "pipeshard", "--dst-sites",
                            "0,1,2", "--layers", "6"]),
        # two sites, three ranks: rank 2 is on no site (a spare)
        ("chaos_spare", CHAOS)),
}


def reshard_legs(root: str, cfg, leaves):
    """A reduced state of ``cfg`` (fp32 params from seed 0, AdamW
    moments drawn from seed 1, step 3) written as a checkpoint, resharded
    onto shard over a model axis of 2, gathered and written again,
    resharded onto pipeshard over 2 stages, gathered and written again,
    and resharded onto shard once more.  Each reshard is held to the
    host-side reference re-placement (``reshard_state``) and to the
    step's own cut of the state; each gather to the state written.
    Returns, per leg, whether each held bit for bit, and this rank's
    shapes of the ``leaves`` (paths)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.plans import Placement, get_plan
    from repro_torch.core.sharding import subtree
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    from repro_torch.launch.reshard_check import host_state, leaves_equal
    from repro_torch.models import Model
    from repro_torch.optim import AdamWState, init_adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import (reshard_checkpoint, reshard_state,
                                   save_checkpoint)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    opt = init_adamw(params)
    opt = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                     m=tree_map(lambda t: torch.randn(t.shape, generator=g),
                                opt.m),
                     v=tree_map(lambda t: torch.rand(t.shape, generator=g),
                                opt.v))
    axes = ("pod", "data", "model")
    legs = (("shard", make_host_mesh((1, 1, 2), axes), None),
            ("pipeshard", make_pipeline_mesh((2, 1, 1), axes, 2),
             Placement((0, 1))),
            ("shard", make_host_mesh((1, 1, 2), axes), None))
    out, first = [], None
    if dist.get_rank() == 0:
        save_checkpoint(root, 0, params, opt)
    dist.barrier()
    for i, (name, mesh, place) in enumerate(legs):
        ckpt = os.path.join(root, f"step_{i:08d}")
        plan = get_plan(name)
        got_p, got_o, _ = reshard_checkpoint(ckpt, model, plan, mesh,
                                             placement=place)
        host_p, host_o = host_state(ckpt, model)
        ref_p, ref_o = reshard_state(host_p, host_o, plan, cfg, mesh,
                                     placement=place, device="cpu")
        step = build_train_step(model, TrainConfig(), plan=name, mesh=mesh)
        own = step.shard_params(host_p)
        rec = {"plan": name,
               "params_bitexact": leaves_equal(got_p, ref_p)[0],
               "opt_bitexact": leaves_equal(got_o.m, ref_o.m)[0]
               and leaves_equal(got_o.v, ref_o.v)[0],
               "layout_bitexact": leaves_equal(got_p, own)[0],
               "shapes": {k: tuple(subtree(got_p, k).shape)
                          for k in leaves}}
        whole_p = step.gather_params(got_p)
        whole_o = step.gather_opt_state(got_o)
        rec["gathered_bitexact"] = leaves_equal(whole_p, host_p)[0] \
            and leaves_equal(whole_o.m, host_o.m)[0] \
            and leaves_equal(whole_o.v, host_o.v)[0]
        if first is None:
            first = got_p
        elif name == "shard":
            rec["round_trip_bitexact"] = leaves_equal(got_p, first)[0]
        out.append(rec)
        if dist.get_rank() == 0:
            save_checkpoint(root, i + 1, whole_p, whole_o)
        dist.barrier()
    return {"legs": out, "n_layers": cfg.n_layers, "heads": cfg.n_heads}


def whisper_reshard(root: str):
    """``reshard_legs`` of a reduced whisper-small state: under pipeshard
    the first stage holds the encoder's stack, the second none of it.
    Each leg also gives this rank's shapes of the encoder's and the
    decoder's first attention's ``wq``."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("whisper-small").reduced(),
                              dtype="float32")
    enc, dec = "encoder/layers/attn/wq", "layers/self_attn/wq"
    rep = reshard_legs(root, cfg, (enc, dec))
    for leg in rep["legs"]:
        leg["encoder_wq"], leg["decoder_wq"] = (leg["shapes"][enc],
                                                leg["shapes"][dec])
    return dict(rep, n_enc=cfg.n_enc_layers)


# deepseek-v2's leaves whose cuts the reshard moves: MLA's heads
# (``w_uq``), its latent's down-projection (whole under shard) and the
# routed experts
DSV2_LEAVES = ("layers/mla/w_uq", "layers/mla/w_dkv", "layers/moe/w_up")


def dsv2_reshard(root: str):
    """``reshard_legs`` of a reduced deepseek-v2 state (MLA and the MoE
    family), at 4 layers."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                              dtype="float32", n_layers=4)
    return dict(reshard_legs(root, cfg, DSV2_LEAVES),
                experts=cfg.moe.n_experts)


def run(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    import importlib

    import repro_torch.train as train_pkg
    from repro_torch.launch import reshard_check
    # the modules (the package exports functions of the same names)
    loop = importlib.import_module("repro_torch.train.loop")
    replan = importlib.import_module("repro_torch.train.replan")

    writes = []                 # (scenario, step) of every save here
    runs = {}                   # scenario -> (failed, left) of this rank
    name = None

    def recording(save):
        def wrapped(ckpt_dir, step, *a, **kw):
            writes.append((name, int(step)))
            return save(ckpt_dir, step, *a, **kw)
        return wrapped

    loop.save_checkpoint = recording(loop.save_checkpoint)
    replan.save_checkpoint = recording(replan.save_checkpoint)
    elastic = train_pkg.train_elastic

    def train_elastic(*a, **kw):
        res = elastic(*a, **kw)
        runs[name] = {"failed": res.failed, "left": res.left,
                      "losses_pre": res.pre.losses if res.pre else None}
        return res

    train_pkg.train_elastic = train_elastic
    reports = {}
    if world == 2:
        root = os.path.join(os.path.dirname(out), "whisper")
        reports["whisper"] = whisper_reshard(root)
        reports["dsv2"] = dsv2_reshard(os.path.join(os.path.dirname(out),
                                                    "dsv2"))
    for name, argv in SCENARIOS[world]:
        reports[name] = reshard_check.check(
            reshard_check.parse(COMMON + argv), torch.device("cpu"))
    torch.save({"rank": rank, "reports": reports, "writes": writes,
                "runs": runs}, f"{out}.{rank}")
    dist.destroy_process_group()


def spawn(out: str, world: int) -> None:
    """Run ``world`` ranks of ``run``; each writes ``out.<rank>``."""
    rdzv = tempfile.mkdtemp(dir=os.path.dirname(out))
    mp.start_processes(run, args=(world, f"file://{rdzv}/store", out),
                       nprocs=world, start_method="fork")


if __name__ == "__main__":
    # torch.utils.checkpoint imports torch._dynamo on its first call
    # (seconds of CPU): once here, before the ranks fork
    import torch._dynamo  # noqa: F401
    spawn(os.path.abspath(sys.argv[1]), int(sys.argv[2]))
