"""One rank of the gloo worlds of ``tests/test_torch_elastic.py``.

Every rank of a world runs ``repro_torch.launch.reshard_check`` on the
world's scenarios in turn (reduced gpt2m in fp32, 4 layers unless the
scenario says otherwise, seq 16, batch 8, 4 microbatches), recording
every checkpoint it writes; each world ends with a chaos drill, after
which its dead and spare ranks take part in nothing.  Each rank saves its
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
