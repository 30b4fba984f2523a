"""One rank of the gloo worlds of ``tests/test_torch_serve_families.py``.

Every rank of a world serves reduced fp32 models of the dense, MoE, SSM,
hybrid, vision-language and encoder-decoder families and the two MLA
models (minicpm3-4b, deepseek-v2-236b) through ``Engine``
and (but the vision-language and encoder-decoder ones, which it refuses)
``ContinuousEngine`` on each mesh of its world: the MoE, SSM and hybrid
families under the flat plans (data, zero2, shard, shard_zero, fsdp),
the vision-language, encoder-decoder and MLA ones under shard, every
family under pipeshard.  The world of one also runs the
one-device engines on the same params and prompts, the yardstick of
every world (one device computes the same bits in every process), and
for the MoE drop case one device on each group of rows the plans route
apart.  The engines' step functions are wrapped to record the logits of
every step.  Rank 0 saves what the tests compare (``torch.save`` of
plain Python and numpy).  Imports no JAX.

    python tests/torch_serve_family_worker.py OUT WORLD
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

from torch_serve_plan_worker import Recorder  # noqa: E402

AXES = ("pod", "data", "model")
FLAT_PLANS = ("data", "zero2", "shard", "shard_zero", "fsdp")
PLANS = FLAT_PLANS + ("pipeshard",)
# name -> (arch, overrides of its reduced config): depth raised so that
# three stages have a layer each (the hybrid's stack is its 4 groups of
# 2 Mamba2 layers)
CASES = {"dense": ("gpt2m", {"n_layers": 4}),
         "moe": ("phi3.5-moe-42b-a6.6b", {"n_layers": 4}),
         "ssm": ("falcon-mamba-7b", {"n_layers": 4}),
         "hybrid": ("zamba2-2.7b", {"n_layers": 8}),
         "vlm": ("phi-3-vision-4.2b", {"n_layers": 4}),
         "encdec": ("whisper-small", {"n_layers": 4}),
         "mla": ("minicpm3-4b", {"n_layers": 4}),
         "dsv2": ("deepseek-v2-236b", {"n_layers": 4})}
# the MoE family's cases, which route tokens: a pipeline routes the whole
# batch as one, so its yardstick is one device on the whole batch
ROUTED = ("moe", "dsv2")
# the families with a KV cache serve both KV dtypes
KV_DTYPES = {"dense": ("fp32", "int8"), "moe": ("fp32", "int8"),
             "ssm": ("fp32",), "hybrid": ("fp32",),
             "vlm": ("fp32", "int8"), "encdec": ("fp32",),
             "mla": ("fp32",), "dsv2": ("fp32",)}
# the families under every flat plan; and each family's flat plans (the
# vision-language one's batch carries patches, the encoder-decoder's
# frames, which shard cuts with the rows, and the encoder-decoder's
# cross cache holds a rank's block of the frames; the MLA models' heads
# and latent cache are cut under shard, the plans that cut nothing more
# are held at a world of one against the reference; the plans' cut of
# the dense stack is the dense family's, held by
# tests/test_torch_serve_plans.py)
FLAT_CASES = ("moe", "ssm", "hybrid")
FLAT_RUNS = {**{n: FLAT_PLANS for n in FLAT_CASES}, "vlm": ("shard",),
             "encdec": ("shard",), "mla": ("shard",), "dsv2": ("shard",)}
# the families ContinuousEngine serves: a vision-language or an
# encoder-decoder request would need its own patches or frames beside
# its prompt
CONTINUOUS = ("dense", "moe", "ssm", "hybrid", "mla", "dsv2")
# batch and slots: 6, unlike every stack depth (4 layers, 4 groups, 2
# layers a group) and the conv window (d_conv - 1 = 3), so that
# ``cache_spec`` finds the batch; a data axis of 2 cuts them in 3
BATCH, SLOTS, PROMPT, MAX_LEN, GEN = 6, 6, 7, 16, 5
# a batch as deep as the stack (4 layers; the hybrid's 4 groups), whose
# stack dim ``cache_spec`` takes for the batch (it finds the batch by
# size) while the runtime lays out its own cache: every family's Engine
# (fp32 KV) under the plan of each of these meshes of the world of 2
DEEP = 4
DEEP_PLANS = {(1, 1, 2): "shard", (2, 1, 1): "pipeshard"}
# a model axis of 3, which divides the SSM conv state's window of 3 rows,
# so that ``cache_spec`` cuts it while a rank keeps every row of it for
# its channels: these families' Engine (fp32 KV, BATCH rows) under shard
# on (1, 1, 3), in the world of 3
CONV_CASES = ("ssm", "hybrid")
# the vision-language family's patches and the encoder-decoder's frames,
# x 0.02 from their own seed
PATCH_SEED = 2
CONT_LEN, BUCKETS = 32, (8, 16)
REQUEST_LENS = (3, 9, 12, 7, 14)
# the mesh runs of a world: (kind, (pod, data, model), stages, split
# name or None).  The flat meshes are tests/test_torch_serve_plans.py's;
# pipeshard at 2 stages, at 3 with an uneven split, at 2 stages with a
# model or a data axis of 2, and at one stage of two chunks
FLAT = "flat"
PIPE = "pipeshard"
SPLITS = {"even": None,
          "uneven3": {"dense": (2, 1, 1), "moe": (1, 2, 1), "ssm": (1, 1, 2),
                      "hybrid": (2, 1, 1), "vlm": (1, 1, 2),
                      "encdec": (1, 2, 1), "mla": (1, 2, 1),
                      "dsv2": (2, 1, 1)},
          "chunks2": {"dense": (3, 1), "moe": (1, 3), "ssm": (2, 2),
                      "hybrid": (1, 3), "vlm": (3, 1), "encdec": (1, 3),
                      "mla": (2, 2), "dsv2": (3, 1)}}
MESHES = {1: ((PIPE, (1, 1, 1), 1, "chunks2"),),
          2: ((FLAT, (1, 1, 2), 0, None), (FLAT, (1, 2, 1), 0, None),
              (PIPE, (2, 1, 1), 2, "even")),
          3: ((PIPE, (3, 1, 1), 3, "uneven3"),),
          4: ((FLAT, (1, 2, 2), 0, None), (FLAT, (1, 1, 4), 0, None),
              (PIPE, (2, 1, 2), 2, "even"), (PIPE, (2, 2, 1), 2, "even"))}
# the MoE drop case: a capacity factor of 0.5 over a batch of 64, so
# that experts drop tokens at prefill and at decode whether the batch
# routes as one (capacity 17 of ~32 choices an expert a decode step) or
# in 2 or 4 groups of rows (16 of ~16 or ~8); served by the Engine
# under data and shard on the meshes with a data axis, and under
# pipeshard with one
DROP_BATCH, DROP_FACTOR = 64, 0.5
DROP_GROUPS = (1, 2, 4)
DROP_PLANS = ("data", "shard")
# the collectives of one decode step: each family under shard at two
# depths on a model axis of 2, and under pipeshard on every staged mesh
COUNT_DEPTHS = {"dense": (4, 5), "moe": (4, 5), "ssm": (4, 5),
                "hybrid": (8, 10), "vlm": (4, 5), "encdec": (4, 5),
                "mla": (4, 5), "dsv2": (4, 5)}


def case_config(name: str, **extra):
    from repro_torch.configs import get_config
    arch, kw = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               **{**kw, **extra})


def drop_config():
    cfg = case_config("moe")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DROP_FACTOR))


def init_params(model):
    return model.init(torch.Generator().manual_seed(0))


def max_len(cfg) -> int:
    """The engines' cache: ``MAX_LEN``, and a vision-language model's
    patches before the prompt."""
    return MAX_LEN + cfg.n_patches


def prompts(cfg, batch: int = BATCH):
    """The prompts of a batch of ``cfg``'s model (either package's
    config), with a vision-language model's patch embeddings or an
    encoder-decoder's frames."""
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(4, cfg.vocab_size, (batch, PROMPT))}
    extra = {"vlm": ("patch_embeds", (cfg.n_patches, cfg.vision_dim)),
             "encdec": ("frames", (cfg.enc_seq_len, cfg.d_model))}
    if cfg.family in extra:
        key, shape = extra[cfg.family]
        out[key] = np.asarray(np.random.default_rng(
            PATCH_SEED).standard_normal((batch,) + shape) * 0.02,
            np.float32)
    return out


def requests(vocab: int):
    from repro_torch.serve import Request
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(4, vocab, (n,)))
            for i, n in enumerate(REQUEST_LENS)]


def leaves(fn, *caches):
    """{path: fn(*leaves)} over caches of one structure (paths
    ``ssm/conv``, ``attn/k``, or ``k``)."""
    from repro_torch.core.sharding import map_cache
    out = {}

    def walk(cs, pre):
        if isinstance(cs[0], dict):
            for k in cs[0]:
                walk([c[k] for c in cs], f"{pre}{k}/")
        else:
            map_cache(lambda name, *ls: out.__setitem__(pre + name, fn(*ls)),
                      *cs)
    walk(caches, "")
    return out


def layout(eng, batch):
    """Per leaf: this rank's shape, the one-device shape and
    ``cache_spec``'s entry of each dim."""
    m, sp = eng.model, eng.plan
    whole = m.init_cache(batch, sp.max_len, window=sp.window,
                         kv_dtype=eng.kv_dtype, device="meta")
    specs = sp.plan.cache_spec(whole, m.cfg, sp.mesh, batch)
    return leaves(lambda w, spec, mine: (tuple(mine.shape), tuple(w.shape),
                                         tuple(spec)),
                  whole, specs, eng._init_cache(batch))


def engine_run(model, params, kv, plan=None, mesh=None, split=None,
               batch=BATCH):
    """(tokens, logits of each step, this rank's cache layout)."""
    from repro_torch.serve import Engine
    eng = Engine(model, batch_size=batch, max_len=max_len(model.cfg),
                 kv_dtype=kv, device="cpu", plan=plan, mesh=mesh,
                 stage_layers=split)
    with Recorder() as rec:
        out = eng.generate(eng.shard_params(params),
                           prompts(model.cfg, batch), GEN)
    res = {"tokens": out["tokens"], "logits": rec.logits}
    if plan is not None:
        res["layout"] = layout(eng, batch)
    return res


def continuous_run(model, params, kv, plan=None, mesh=None, split=None):
    from repro_torch.serve import ContinuousEngine
    ce = ContinuousEngine(model, slots=SLOTS, max_len=CONT_LEN,
                          buckets=BUCKETS, kv_dtype=kv, device="cpu",
                          plan=plan, mesh=mesh, stage_layers=split)
    res = ce.run(ce.shard_params(params), requests(model.cfg.vocab_size),
                 max_new=GEN)
    return {uid: np.asarray(t) for uid, t in res["outputs"].items()}


class DropCounter:
    """Wraps ``moe.route``: for every routing of T tokens, whether some
    expert took more choices than the capacity ``moe_forward`` gives."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.saved = moe.route

    def __enter__(self):
        def wrapped(xf, params, cfg):
            out = self.saved(xf, params, cfg)
            m, T = cfg.moe, xf.shape[0]
            cap = min(max(int(m.capacity_factor * T * m.top_k
                              / m.n_experts) + 1, min(T, 16)), T)
            most = int(torch.bincount(out[2].reshape(-1),
                                      minlength=m.n_experts).max())
            self.calls.append((T, most > cap))
            return out
        self.moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.saved


def in_groups(model, params, batch, groups, kv="fp32"):
    """The one-device Engine on ``groups`` equal groups of the rows of
    ``batch`` (every leaf's), each a batch of its own: tokens and every
    step's logits concatenated over the groups, and whether an expert
    dropped tokens at prefill and at decode."""
    from repro_torch.serve import Engine
    n = batch["tokens"].shape[0] // groups
    toks, logits, drops = [], [], []
    for g in range(groups):
        eng = Engine(model, batch_size=n, max_len=max_len(model.cfg),
                     kv_dtype=kv, device="cpu")
        with Recorder() as rec, DropCounter() as dc:
            toks.append(eng.generate(
                params, {k: v[g * n:(g + 1) * n] for k, v in batch.items()},
                GEN)["tokens"])
        logits.append(rec.logits)
        drops += dc.calls
    return {"tokens": np.concatenate(toks),
            "logits": [np.concatenate(s) for s in zip(*logits)],
            "decode_drops": any(d for T, d in drops if T == n),
            "prefill_drops": any(d for T, d in drops if T == n * PROMPT)}


def one_device():
    """Every engine of every case without a plan; the Engine of the
    families that route no tokens on each half of the rows (the rows a
    data axis of 2 gives a rank); and the MoE drop case's Engine on 1, 2
    and 4 groups of rows."""
    from repro_torch.models import Model
    out = {}
    for name in CASES:
        model = Model(case_config(name), device="cpu")
        params = init_params(model)
        out[(name, "deep", "fp32")] = engine_run(model, params, "fp32",
                                                 batch=DEEP)
        for kv in KV_DTYPES[name]:
            out[(name, "engine", kv)] = engine_run(model, params, kv)
            if name in CONTINUOUS:
                out[(name, "cont", kv)] = continuous_run(model, params, kv)
            if name not in ROUTED:
                out[(name, "halves", kv)] = in_groups(
                    model, params, prompts(model.cfg), 2, kv)
    model = Model(drop_config(), device="cpu")
    params = init_params(model)
    batch = prompts(model.cfg, DROP_BATCH)
    for groups in DROP_GROUPS:
        out[("drop", "engine", groups)] = in_groups(model, params, batch,
                                                    groups)
    return out


def conv_window_runs(world: int):
    """The SSM and hybrid Engine under shard on a model axis of
    ``world`` (3 divides the conv window of 3 rows)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    mesh = make_host_mesh((1, 1, world), AXES)
    out = {}
    for name in CONV_CASES:
        model = Model(case_config(name), device="cpu")
        out[name] = engine_run(model, init_params(model), "fp32", "shard",
                               mesh)
    return out


def deep_runs(plan, mesh):
    """Every family's Engine at a batch as deep as the stack."""
    from repro_torch.models import Model
    out = {}
    for name in CASES:
        model = Model(case_config(name), device="cpu")
        out[name] = engine_run(model, init_params(model), "fp32", plan, mesh,
                               batch=DEEP)
    return out


def mesh_of(kind, shape, stages):
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    if kind == FLAT:
        return make_host_mesh(shape, AXES)
    return make_pipeline_mesh(shape, AXES, stages)


def under_plans(kind, mesh, split_name, turn):
    """Every case's engines on ``mesh``: under its flat plans
    (``FLAT_RUNS``) or under pipeshard (every family).  The Engine
    serves one KV dtype and the ContinuousEngine the other, by ``turn``,
    so that each family with a KV cache meets both on each world (the
    vision-language family, which has no ContinuousEngine, meets them
    through the Engine over the meshes)."""
    from repro_torch.core.plans import get_plan
    from repro_torch.models import Model
    out = {}
    runs = FLAT_RUNS if kind == FLAT else {n: ("pipeshard",) for n in CASES}
    for name, plans in runs.items():
        model = Model(case_config(name), device="cpu")
        params = init_params(model)
        kvs = KV_DTYPES[name]
        split = None if SPLITS[split_name or "even"] is None \
            else SPLITS[split_name][name]
        for p, plan in enumerate(plans):
            kv = kvs[(p + turn) % len(kvs)]
            ckv = kvs[(p + turn + 1) % len(kvs)]
            out[(name, "engine", kv, plan)] = engine_run(
                model, params, kv, plan, mesh, split)
            if name in CONTINUOUS:
                out[(name, "cont", ckv, plan)] = continuous_run(
                    model, params, ckv, plan, mesh, split)
    if mesh.shape.get("data", 1) > 1:
        model = Model(drop_config(), device="cpu")
        params = init_params(model)
        for plan in DROP_PLANS if kind == FLAT else ("pipeshard",):
            run = engine_run(model, params, "fp32", plan, mesh,
                             batch=DROP_BATCH)
            axes = get_plan(plan).batch_axes(mesh, DROP_BATCH)
            # the groups of rows the plan routes apart
            run["groups"] = 1 if plan == "pipeshard" else \
                mesh.count(axes) if axes else 1
            out[("drop", "engine", "fp32", plan)] = run
    return out


def decode_counts(kind, mesh, split_name):
    """The collectives of one decode step (fp32 KV): under shard, each
    family at the two depths of ``COUNT_DEPTHS``; under pipeshard, each
    family at its case's depth."""
    from repro_torch.core import sharding
    from repro_torch.models import Model
    from repro_torch.serve.steps import ServePlan, prefill_step, serve_step
    out = {}
    for name in CASES:
        depths = COUNT_DEPTHS[name] if kind == FLAT \
            else (case_config(name).n_layers,)
        for L in depths:
            model = Model(case_config(name, n_layers=L), device="cpu")
            split = None if kind == FLAT or SPLITS[split_name] is None \
                else SPLITS[split_name][name]
            sp = ServePlan(model, "shard" if kind == FLAT else "pipeshard",
                           mesh, max_len=max_len(model.cfg),
                           stage_layers=split)
            params = sp.shard_params(init_params(model))
            cache = sp.init_cache(BATCH)
            batch = prompts(model.cfg)
            logits, cache = prefill_step(model, params, batch, cache,
                                         plan=sp)
            tok = torch.argmax(logits, -1)[:, None]
            sharding.reset_collective_counts()
            serve_step(model, params, cache, tok, plan=sp)
            out[(name, L)] = sharding.collective_counts()
    return out


def run(rank: int, world: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {"world": world, "meshes": []}
    if world == 1:
        res["one_device"] = one_device()
    if world == 3:
        res["conv_window"] = conv_window_runs(world)
    for turn, (kind, shape, stages, split_name) in enumerate(MESHES[world]):
        mesh = mesh_of(kind, shape, stages)
        rec = {"kind": kind, "shape": shape, "stages": stages,
               "split": split_name,
               "runs": under_plans(kind, mesh, split_name, turn)}
        if kind == PIPE or shape == (1, 1, 2):
            rec["counts"] = decode_counts(kind, mesh, split_name)
        if world == 2 and shape in DEEP_PLANS:
            rec["deep"] = deep_runs(DEEP_PLANS[shape], mesh)
        # every rank's cache layouts and counts (the ranks' rows, blocks
        # and stages differ)
        mine = {"coord": dict(mesh.coord), "counts": rec.get("counts"),
                "layouts": {k: r["layout"] for k, r in rec["runs"].items()
                            if k[1] == "engine"}}
        every = [None] * world
        dist.all_gather_object(every, mine)
        rec["ranks"] = every
        res["meshes"].append(rec)
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
