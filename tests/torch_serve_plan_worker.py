"""One rank of the gloo worlds of ``tests/test_torch_serve_plans.py``.

Every rank of a world serves reduced fp32 models of the dense family
through ``Engine`` and ``ContinuousEngine`` under each flat plan, on each
mesh of its world, and the world of one also runs the one-device engines on the
same params and prompts, the yardstick of every world (one device
computes the same bits in every process).  The engines' step functions are wrapped to record the logits
of every step.  Rank 0 saves what the tests compare (``torch.save`` of
plain Python and numpy).  Imports no JAX.

    python tests/torch_serve_plan_worker.py OUT WORLD
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
if SRC not in sys.path:
    sys.path.insert(0, SRC)

AXES = ("pod", "data", "model")
# world -> its meshes over (pod, data, model), each running one half of
# ``SPLIT`` (the world of one both on its one mesh)
MESHES = {1: ((1, 1, 1), (1, 1, 1)), 2: ((1, 1, 2), (1, 2, 1)),
          4: ((1, 2, 2), (1, 1, 4))}
PLANS = ("data", "zero2", "shard", "shard_zero", "fsdp")
# name -> (arch, overrides of its reduced config): MHA (4 heads, vocab
# 512, every leaf cut); GQA (4 heads over 2 kv heads, which a model axis
# of 4 leaves whole); one kv head and a vocab (509) that divides no
# model axis, so the table and logits stay whole
CASES = {"gpt2m": ("gpt2m", {}),
         "llama_gqa": ("llama3.2-3b", {"n_kv_heads": 2}),
         "vocab509": ("llama3.2-3b", {"n_kv_heads": 1, "vocab_size": 509})}
# the Engine's cache layouts, (max_len, window, prompt length): a ring
# of 16 slots, which a model axis of 1, 2 or 4 cuts; one of 15, which
# it cuts only at 1; a window of 8 slots under a prompt of 10 and 6 new
# tokens, so that prefill and decode wrap the ring across the blocks
LAYOUTS = {"divides": (16, 0, 7), "ragged": (15, 0, 7),
           "window": (32, 8, 10)}
# the ContinuousEngine's: 4 slots (not the stack's depth of 2), two
# capacities, the second not cut by a model axis of 2 or 4
CONT_LAYOUTS = {"divides": 32, "ragged": 31}
BATCH, GEN, SLOTS = 4, 5, 4
REQUEST_LENS = (3, 9, 12, 7, 14)
# the engines each mesh of a world runs, (Engine KV dtype, continuous KV
# dtype, continuous layout), so that every plan and case meets both KV
# dtypes on each world; on worlds 2 and 4 each mesh runs a plan's cases
# under a rotation of the Engine's layouts (``rotated``), so that every
# plan meets every layout on each mesh and each case two of them
SPLIT = ({"engine": "fp32", "cont": ("int8", "divides")},
         {"engine": "int8", "cont": ("fp32", "ragged")})
COUNT_LAYERS = (2, 3)
# a batch (and slots) as deep as the stack (reduced gpt2m's 2 layers),
# whose layer dim ``cache_spec`` takes for the batch (it finds the batch
# by size): the runtime lays out its own cache; served by the Engine
# (fp32 KV) and the ContinuousEngine (int8 KV) under each plan of
# DEEP_PLANS on the mesh of the same index of the world of 2
DEEP = 2
DEEP_PLANS = ("shard", "data")


def case_config(name: str, **extra):
    from repro_torch.configs import get_config
    arch, kw = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **kw, **extra)


def init_params(model):
    return model.init(torch.Generator().manual_seed(0))


def prompts(vocab: int, layout: str, batch: int = BATCH):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(4, vocab, (batch, LAYOUTS[layout][2]))}


def requests(vocab: int):
    from repro_torch.serve import Request
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(4, vocab, (n,)))
            for i, n in enumerate(REQUEST_LENS)]


class Recorder:
    """Wraps the engines' step functions: every step's logits (the whole
    batch's, as every rank sees them) in call order."""

    def __init__(self):
        from repro_torch.serve import engine
        self.engine, self.logits = engine, []
        self.saved = {k: getattr(engine, k) for k in
                      ("prefill_step", "serve_step", "decode_slots_step")}

    def __enter__(self):
        for name, fn in self.saved.items():
            def wrapped(*a, _fn=fn, **kw):
                out = _fn(*a, **kw)
                self.logits.append(out[0].detach().numpy().copy())
                return out
            setattr(self.engine, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.engine, name, fn)


def engine_run(model, params, layout, kv, plan=None, mesh=None,
               batch=BATCH):
    """(tokens, logits of each step, this rank's cache leaf shapes)."""
    from repro_torch.serve import Engine
    max_len, window, _ = LAYOUTS[layout]
    eng = Engine(model, batch_size=batch, max_len=max_len, window=window,
                 kv_dtype=kv, device="cpu", plan=plan, mesh=mesh)
    with Recorder() as rec:
        out = eng.generate(eng.shard_params(params),
                           prompts(model.cfg.vocab_size, layout, batch), GEN)
    cache = eng._init_cache(batch)
    shapes = {f: tuple(getattr(cache, f).shape) for f in cache._fields}
    return {"tokens": out["tokens"], "logits": rec.logits, "shapes": shapes}


def continuous_run(model, params, layout, kv, plan=None, mesh=None,
                   slots=SLOTS):
    from repro_torch.serve import ContinuousEngine
    ce = ContinuousEngine(model, slots=slots, max_len=CONT_LAYOUTS[layout],
                          buckets=(8, 16), kv_dtype=kv, device="cpu",
                          plan=plan, mesh=mesh)
    res = ce.run(ce.shard_params(params), requests(model.cfg.vocab_size),
                 max_new=GEN)
    return {uid: np.asarray(t) for uid, t in res["outputs"].items()}


def one_device():
    """Every engine of every case without a plan."""
    from repro_torch.models import Model
    out = {}
    for name in CASES:
        model = Model(case_config(name), device="cpu")
        params = init_params(model)
        for kv in ("fp32", "int8"):
            for layout in LAYOUTS:
                out[(name, "engine", kv, layout)] = engine_run(
                    model, params, layout, kv)
            for layout in CONT_LAYOUTS:
                out[(name, "cont", kv, layout)] = continuous_run(
                    model, params, layout, kv)
    return out


def deep_runs(plan=None, mesh=None):
    """The Engine and the ContinuousEngine at a batch and slots as deep as
    the stack (``DEEP``)."""
    from repro_torch.models import Model
    model = Model(case_config("gpt2m"), device="cpu")
    assert model.cfg.n_layers == DEEP
    params = init_params(model)
    return {"engine": engine_run(model, params, "divides", "fp32", plan,
                                 mesh, batch=DEEP),
            "cont": continuous_run(model, params, "divides", "int8", plan,
                                   mesh, slots=DEEP)}


def rotated(case: int, plan: int, turn: int):
    """The Engine's layout of a case under a plan on the mesh ``turn`` of
    a world of more than one rank."""
    return (tuple(LAYOUTS)[(case + plan + turn) % len(LAYOUTS)],)


def under_plans(mesh, split, turn=None):
    """The engines of ``split`` under every plan, every case: the Engine
    in every layout, or in the ``rotated`` one of mesh ``turn``."""
    from repro_torch.models import Model
    out = {}
    for c, name in enumerate(CASES):
        model = Model(case_config(name), device="cpu")
        params = init_params(model)
        kv = split["engine"]
        ckv, clayout = split["cont"]
        for p, plan in enumerate(PLANS):
            for layout in LAYOUTS if turn is None else rotated(c, p, turn):
                out[(name, "engine", kv, layout, plan)] = engine_run(
                    model, params, layout, kv, plan, mesh)
            out[(name, "cont", ckv, clayout, plan)] = continuous_run(
                model, params, clayout, ckv, plan, mesh)
    return out


def decode_counts(mesh):
    """The collectives of one decode step of gpt2m under shard at two
    depths (int8 cache of 16 slots)."""
    from repro_torch.core import sharding
    from repro_torch.models import Model
    from repro_torch.serve.steps import ServePlan, prefill_step, serve_step
    out = {}
    for L in COUNT_LAYERS:
        model = Model(case_config("gpt2m", n_layers=L), device="cpu")
        sp = ServePlan(model, "shard", mesh, max_len=16)
        params = sp.shard_params(init_params(model))
        cache = sp.init_cache(BATCH, kv_dtype="int8")
        batch = prompts(model.cfg.vocab_size, "divides")
        logits, cache = prefill_step(model, params, batch, cache, plan=sp)
        tok = torch.argmax(logits, -1)[:, None]
        sharding.reset_collective_counts()
        serve_step(model, params, cache, tok, plan=sp)
        out[L] = sharding.collective_counts()
    return out


def run(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_host_mesh
    res = {"world": world, "meshes": []}
    if world == 1:
        res["one_device"] = one_device()
        res["deep"] = {None: deep_runs()}
    for turn, (shape, split) in enumerate(zip(MESHES[world], SPLIT)):
        mesh = make_host_mesh(shape, AXES)
        res["meshes"].append({"shape": shape, "split": split,
                              "runs": under_plans(
                                  mesh, split, None if world == 1 else turn),
                              "counts": decode_counts(mesh)})
        if world == 2:
            plan = DEEP_PLANS[turn]
            res.setdefault("deep", {})[(plan, shape)] = deep_runs(plan, mesh)
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def spawn(out: str, world: int) -> None:
    """Run ``world`` ranks of ``run``; rank 0 writes ``out``."""
    rdzv = tempfile.mkdtemp(dir=os.path.dirname(out))
    mp.start_processes(run, args=(world, f"file://{rdzv}/store", out),
                       nprocs=world, start_method="fork")


if __name__ == "__main__":
    spawn(os.path.abspath(sys.argv[1]), int(sys.argv[2]))
