"""Serving under every plan for every family: the MoE, SSM and hybrid
families under the flat plans (data, zero2, shard, shard_zero, fsdp),
the Multi-head Latent Attention models (minicpm3-4b, deepseek-v2-236b:
a rank's heads, the latent cache's ring cut over the model axis) under
shard, the vision-language family (its batch carrying patch embeddings, its
cache the patches too) and the encoder-decoder (its batch carrying
frames, its cross cache a rank's block of the frames) under shard, and
pipeshard for the dense, MoE, SSM, hybrid, vision-language,
encoder-decoder and MLA models.

* Reference parity: at a world of one, every family under every plan of
  ``PLANS`` gives the JAX reference ``Engine``'s tokens under the same
  plan, on a ``(data, model)`` mesh of one device or a ``(stage, data,
  model)`` mesh of ``(1, 1, 1)``.
* Numerics: gloo worlds of 1, 2, 3 and 4 ranks, one spawn each
  (``tests/torch_serve_family_worker.py``), in fp32 on reduced configs
  with depth raised to 4 layers (the hybrid: 4 groups of 2): the flat
  meshes (1,1,2), (1,2,1), (1,2,2) and (1,1,4) over (pod, data, model),
  and pipeshard at 2 stages (2,1,1), at 3 stages with an uneven split,
  at (2,1,2) and (2,2,1), and at one stage of two chunks.  Both engines
  (the vision-language and encoder-decoder families: ``Engine``, as the
  reference) give the
  one-device port's greedy tokens in both KV dtypes where the family
  has a KV cache, every step's logits within ``FP32_LOGIT_ATOL``
  (fp32 KV) or ``INT8_LOGIT_RTOL`` of the largest (int8 KV), and
  pipeshard with a model axis of one is bit-equal (a handoff is a copy).
* The MoE family routes as the reference: each batch rank's rows on
  their own under the flat plans, the whole batch under pipeshard; its
  yardstick is the one-device port on each group of rows the plan routes
  apart, concatenated, held on a case whose experts drop tokens at
  prefill and at decode.
* Structure: the collectives of a decode step a layer under shard, and
  under pipeshard each stage's collectives, handoffs and the logits'
  broadcast; each rank's cache leaves against ``cache_spec``, with the
  differences that change memory only, among them a batch as deep as
  the stack and a model axis of 3 that ``cache_spec`` would have cut the
  SSM conv window over, both served with one device's tokens; the
  refusal that stays (a config not ported); the launcher under
  ``torch.distributed.run``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_serve_family_worker as worker  # noqa: E402

WORLDS = (1, 2, 3, 4)
# fp32 KV: the plans' sums in other orders (the model axis's partial
# sums, the merge of the ring's blocks, matmuls of other shapes)
FP32_LOGIT_ATOL = 1e-5
# int8 KV: an fp32 rounding difference upstream of the cache can move a
# cached value across an int8 rounding boundary (see
# tests/test_torch_serve_plans.py)
INT8_LOGIT_RTOL = 1e-3
# the entry point beside the worlds, in the reduced configs' bf16, each
# rank's check against one device held to the bf16 envelope (5% of the
# largest logit): gpt2m on two stages, and phi3.5-MoE under fsdp on a
# model axis of two with the int8 cache; and in fp32 (``--plain-fp32``,
# the plain versions), the launcher itself holding the check to 1e-4:
# deepseek-v2 (MLA, top-6 routing reduced to top-2) under shard on a
# model axis of two
LAUNCH = ["torch.distributed.run", "--nproc_per_node", "2", "--standalone",
          "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
          "--batch", "4", "--gen", "6", "--check"]
LAUNCHES = {"pipeshard": ["--plan", "pipeshard", "--mesh", "2,1,1",
                          "--stages", "2"],
            "moe_fsdp": ["--arch", "phi3.5-moe-42b-a6.6b", "--plan", "fsdp",
                         "--mesh", "1,1,2", "--kv-dtype", "int8"],
            "dsv2_fp32": ["--arch", "deepseek-v2-236b", "--plan", "shard",
                          "--mesh", "1,1,2", "--plain-fp32", "--check",
                          "1e-4"]}
BF16_LOGIT_RTOL = 5e-2
# tools/moe_ties.py beside them: where reduced deepseek-v2's bf16 routing
# parts under shard on a model axis of two, and the check with one
# device's expert choices replayed
TIES = [os.path.join(os.path.dirname(HERE), "tools", "moe_ties.py"),
        "--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu",
        "--mesh", "1,1,2", "--gen", "6"]
AXES = ("pod", "data", "model")
# the reference's Engine runs in the background beside the worlds, in
# processes of this module's ``__main__``, each over these families
REFERENCE_SPLIT = (("dense", "vlm"), ("moe",), ("ssm",), ("hybrid",),
                   ("encdec",), ("mla", "dsv2"))


# ------------------------------------------------------------------ #
# the four worlds, the reference's Engine and the launcher, started at
# once in the background

@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("serve_families")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d / "out.pt", subprocess.Popen(
            [sys.executable, os.path.join(HERE,
                                          "torch_serve_family_worker.py"),
             str(d / "out.pt"), str(world)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for i, families in enumerate(REFERENCE_SPLIT):
        path = root / f"reference{i}.pt"
        procs[f"reference{i}"] = (path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path)]
            + list(families), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, extra in LAUNCHES.items():
        procs[name] = (None, subprocess.Popen(
            [sys.executable, "-m"] + LAUNCH + extra, env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs["moe_ties"] = (None, subprocess.Popen(
        [sys.executable, "-m"] + LAUNCH[:4] + TIES, env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_early(_started):
    """Start the worlds before the first test of the module."""


@pytest.fixture(scope="module")
def worlds(_started):
    out = {}
    for world in WORLDS:
        path, proc = _started[world]
        log, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, log[-4000:]
        out[world] = torch.load(path, weights_only=False)
    return out


def _meshes(worlds, world, kind=None):
    return [m for m in worlds[world]["meshes"]
            if kind is None or m["kind"] == kind]


def _close(got, want, kv, what):
    """Tokens equal; every step's logits within the KV dtype's
    tolerance."""
    np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                  err_msg=what)
    assert len(got["logits"]) == len(want["logits"]) == worker.GEN, what
    top = max(np.abs(w).max() for w in want["logits"])
    tol = FP32_LOGIT_ATOL if kv == "fp32" else INT8_LOGIT_RTOL * top
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert a.shape == b.shape, what
        err = np.abs(a - b).max()
        assert err <= tol, f"{what} step {step}: {err} > {tol}"


# ------------------------------------------------------------------ #
# a world of one in this process: the reference's Engine, the plans

@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of one rank in this process, its flat mesh and its
    staged mesh of one stage."""
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield {"flat": make_host_mesh((1, 1, 1), AXES),
           "staged": make_pipeline_mesh((1, 1, 1), AXES, 1)}
    if started:
        dist.destroy_process_group()


def _port_mesh(one_rank, plan):
    return one_rank["staged" if plan == "pipeshard" else "flat"]


def reference_tokens(families):
    """The reference's params of each family (numpy) and {(family, plan):
    tokens} of its Engine under each plan of ``PLANS`` on a mesh of one
    device ((data, model), or (stage, data, model) for pipeshard), on
    the worker's configs and prompts."""
    from repro.launch.mesh import make_host_mesh
    from repro.models import Model as JModel
    from repro.serve import Engine as JEngine
    params, tokens = {}, {}
    for name in families:
        arch, kw = worker.CASES[name]
        jm = JModel(dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                        dtype="float32", **kw))
        with jax.set_mesh(make_host_mesh((1, 1), ("data", "model"))):
            jp = jm.init(jax.random.key(0))
        params[name] = jax.tree.map(np.asarray, jp)
        batch = worker.prompts(jm.cfg)
        batch["tokens"] = batch["tokens"].astype(np.int32)
        for plan in worker.PLANS:
            axes = ("stage", "data", "model") if plan == "pipeshard" \
                else ("data", "model")
            mesh = make_host_mesh((1,) * len(axes), axes)
            tokens[(name, plan)] = JEngine(
                jm, jplans.get_plan(plan), mesh, batch_size=worker.BATCH,
                max_len=worker.max_len(jm.cfg)).generate(
                jp, batch, worker.GEN)["tokens"]
    return {"params": params, "tokens": tokens}


@pytest.fixture(scope="module")
def reference(_started):
    """The reference's params of each family (the port's tensors) and
    its Engine's tokens under each plan."""
    params, tokens = {}, {}
    for i in range(len(REFERENCE_SPLIT)):
        path, proc = _started[f"reference{i}"]
        log, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, log[-4000:]
        got = torch.load(path, weights_only=False)
        params.update({k: convert.params_from_numpy(v)
                       for k, v in got["params"].items()})
        tokens.update(got["tokens"])
    return params, tokens


@pytest.mark.parametrize("plan", worker.PLANS)
@pytest.mark.parametrize("family", list(worker.CASES))
def test_engine_at_a_world_of_one_equals_reference_engine(
        one_rank, reference, family, plan):
    """The reference's Engine under ``plan`` on a mesh of one device
    against the port's Engine under ``plan`` at a gloo world of one, on
    the reference's params."""
    from repro_torch.serve import Engine
    params, tokens = reference
    model = TModel(worker.case_config(family), device="cpu")
    eng = Engine(model, batch_size=worker.BATCH,
                 max_len=worker.max_len(model.cfg), device="cpu", plan=plan,
                 mesh=_port_mesh(one_rank, plan))
    got = eng.generate(eng.shard_params(params[family]),
                       worker.prompts(model.cfg), worker.GEN)["tokens"]
    np.testing.assert_array_equal(got, tokens[(family, plan)])


@pytest.mark.parametrize("plan", sorted(tplans.PLANS))
@pytest.mark.parametrize("family", list(worker.CASES))
def test_serve_plan_builds_for_every_family_and_plan(one_rank, family,
                                                     plan):
    """``ServePlan`` builds, cuts the params and gives both caches for
    every (family, plan) pair; nothing raises ``NOT_YET`` any more."""
    from repro_torch.serve.steps import ServePlan
    model = TModel(worker.case_config(family), device="cpu")
    sp = ServePlan(model, plan, _port_mesh(one_rank, plan),
                   max_len=worker.MAX_LEN)
    local = sp.shard_params(worker.init_params(model))
    assert set(local) == set(sp.param_specs)
    for kv in worker.KV_DTYPES[family]:
        for slots in (False, True):
            cache = sp.init_cache(worker.BATCH, kv_dtype=kv, slots=slots)
            want = model.init_slot_cache if slots else model.init_cache
            want = want(worker.BATCH, worker.MAX_LEN, kv_dtype=kv,
                        device="meta")
            for leaf, (a, b) in worker.leaves(
                    lambda a, b: (a.shape, b.shape), cache, want).items():
                assert a == b, (leaf, kv, slots)
    assert (sp.server is not None) == (plan == "pipeshard")


def test_pipeshard_stage_rows_and_chunks(one_rank):
    """At one stage of two chunks a rank holds every layer (no padded
    row); a split that is not a whole number of chunks a stage raises;
    stage_layers under a flat plan raises."""
    from repro_torch.serve.steps import ServePlan
    model = TModel(worker.case_config("dense"), device="cpu")
    sp = ServePlan(model, "pipeshard", one_rank["staged"],
                   max_len=worker.MAX_LEN, stage_layers=(3, 1))
    assert list(sp.stage_rows) == [0, 1, 2, 3]
    assert sp.server.spans == [(0, 3), (3, 1)]
    local = sp.shard_params(worker.init_params(model))
    assert local["layers"]["attn"]["wq"].shape[0] == 4
    with pytest.raises(ValueError, match="does not partition"):
        ServePlan(model, "pipeshard", one_rank["staged"],
                  max_len=worker.MAX_LEN, stage_layers=(3, 2))
    with pytest.raises(ValueError, match="only a pipeline plan"):
        ServePlan(model, "shard", one_rank["flat"], max_len=worker.MAX_LEN,
                  stage_layers=(3, 1))


@pytest.mark.parametrize("family", list(worker.CASES))
def test_a_batch_as_deep_as_the_stack_raises_for_every_family(worlds,
                                                              family):
    """``cache_spec`` finds the batch dim by size: at a batch as deep as
    the stack (4 layers; the hybrid's 4 groups) it takes the stack dim,
    while the runtime lays out its own cache.  Under shard on (1, 1, 2)
    and pipeshard on (2, 1, 1) the Engine gives one device's tokens at
    that batch, every step's logits within ``FP32_LOGIT_ATOL``.  (Named
    for the refusal it held until the runtime laid out its own cache.)"""
    want = worlds[1]["one_device"][(family, "deep", "fp32")]
    plans = []
    for m in _meshes(worlds, 2):
        if "deep" not in m:
            continue
        got = m["deep"][family]
        plans.append(worker.DEEP_PLANS[m["shape"]])
        assert got["tokens"].shape == (worker.DEEP, worker.GEN)
        _close(got, want, "fp32", f"deep {family} {m['shape']}")
        for leaf, (mine, whole, spec) in got["layout"].items():
            # the true batch dim is this rank's rows of every stack row
            if leaf.endswith("index"):
                continue
            assert worker.DEEP in mine, (leaf, mine)
    assert sorted(plans) == ["pipeshard", "shard"]


def test_a_config_not_ported_is_refused():
    """Every config of the reference's registry is ported (the
    vision-language one serves under shard and pipeshard in the worlds);
    a name the registry does not hold raises."""
    from repro_torch.configs import ARCH_CONFIGS, get_config
    assert sorted(ARCH_CONFIGS) == sorted(jconfigs.ARCH_CONFIGS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("phi-3-vision-8b")


def test_a_model_axis_that_cuts_the_conv_window_is_refused(worlds):
    """On a model axis of 3, ``cache_spec`` cuts the SSM conv state's 3
    rows of window (the dim after the batch) over ``model``; a rank keeps
    the whole window for the channels it computes, and the SSM and
    hybrid families give one device's tokens, every step's logits within
    ``FP32_LOGIT_ATOL``.  (Named for the refusal it held until the
    runtime laid out its own cache.)"""
    got = worlds[3]["conv_window"]
    assert set(got) == set(worker.CONV_CASES) == {"ssm", "hybrid"}
    one = worlds[1]["one_device"]
    for name, run in got.items():
        _close(run, one[(name, "engine", "fp32")], "fp32",
               f"conv window {name}")
        conv = [v for k, v in run["layout"].items() if k.endswith("conv")]
        assert conv, run["layout"]
        for mine, whole, spec in conv:
            at = spec.index("model")
            assert whole[at] == 3 and mine[at] == 3, (mine, whole, spec)


# ------------------------------------------------------------------ #
# numerics against the one-device port

def _engine_cases(worlds, world):
    """(mesh, key, run) of every Engine run of a world but the drop
    case."""
    for m in worlds[world]["meshes"]:
        for key, run in m["runs"].items():
            if key[1] == "engine" and key[0] != "drop":
                yield m, key, run


@pytest.mark.parametrize("world", WORLDS)
def test_engine_tokens_and_logits_equal_one_device(worlds, world):
    one = worlds[1]["one_device"]
    n = 0
    for m, key, run in _engine_cases(worlds, world):
        _close(run, one[(key[0], "engine", key[2])], key[2],
               f"world {world} mesh {m['shape']} {key}")
        n += 1
    per_mesh = {worker.FLAT: sum(map(len, worker.FLAT_RUNS.values())),
                worker.PIPE: len(worker.CASES)}
    assert n == sum(per_mesh[m["kind"]] for m in _meshes(worlds, world))


@pytest.mark.parametrize("world", WORLDS)
def test_pipeshard_with_a_model_axis_of_one_is_bit_equal(worlds, world):
    """The stage handoffs are copies: on every pipeshard mesh with a
    model axis of one, every step's logits are bit-equal to one device's
    on the same rows.  With a data axis of 2 each rank runs half the
    batch, so the yardstick is the one-device port on each half (on the
    CPU the plain Mamba2 path rounds a row in a batch of 3 apart from
    the same row in a batch of 6, by ~3e-6 in the hidden state), but
    for the MoE family, which routes the whole batch as one."""
    one = worlds[1]["one_device"]
    n = 0
    for m, key, run in _engine_cases(worlds, world):
        if m["kind"] != worker.PIPE or m["shape"][2] != 1:
            continue
        name, _, kv, _ = key
        halves = m["shape"][1] > 1 and name not in worker.ROUTED
        want = one[(name, "halves" if halves else "engine", kv)]
        np.testing.assert_array_equal(run["tokens"], want["tokens"])
        for a, b in zip(run["logits"], want["logits"]):
            assert np.array_equal(a, b), (m["shape"], key)
        n += 1
    assert n == len(worker.CASES) * sum(
        m["shape"][2] == 1 for m in _meshes(worlds, world, worker.PIPE))


@pytest.mark.parametrize("world", WORLDS)
def test_continuous_tokens_equal_one_device(worlds, world):
    one = worlds[1]["one_device"]
    n = 0
    for m in worlds[world]["meshes"]:
        for key, got in m["runs"].items():
            name, kind, kv, plan = key
            if kind != "cont":
                continue
            want = one[(name, "cont", kv)]
            assert got.keys() == want.keys() == set(
                range(len(worker.REQUEST_LENS)))
            for uid, w in want.items():
                assert w.shape == (worker.GEN,)
                np.testing.assert_array_equal(
                    got[uid], w, err_msg=f"world {world} mesh "
                    f"{m['shape']} {key} request {uid}")
            n += 1
    assert n == sum(sum(len(p) for f, p in worker.FLAT_RUNS.items()
                        if f in worker.CONTINUOUS)
                    if m["kind"] == worker.FLAT else len(worker.CONTINUOUS)
                    for m in _meshes(worlds, world))


def test_every_family_meets_every_plan_and_kv_dtype(worlds):
    """Over the worlds, each family with a KV cache serves both KV
    dtypes through both engines (the vision-language family through
    ``Engine``) under every plan it runs, and every family runs
    pipeshard on every staged mesh, the MoE, SSM and hybrid families
    every flat plan on every flat mesh and the vision-language family
    shard on every flat mesh."""
    seen = set()

    def engines(name):
        return ("engine", "cont") if name in worker.CONTINUOUS \
            else ("engine",)

    for world in WORLDS:
        for m in worlds[world]["meshes"]:
            keys = {k for k in m["runs"] if k[0] != "drop"}
            runs = worker.FLAT_RUNS if m["kind"] == worker.FLAT \
                else {n: ("pipeshard",) for n in worker.CASES}
            assert {(k[0], k[1], k[3]) for k in keys} == {
                (n, e, p) for n, plans in runs.items() for e in engines(n)
                for p in plans}
            seen |= keys
    for name, kvs in worker.KV_DTYPES.items():
        plans = worker.FLAT_RUNS.get(name, ()) + ("pipeshard",)
        for plan in plans:
            for kind in engines(name):
                assert {k[2] for k in seen if k[0] == name and k[1] == kind
                        and k[3] == plan} == set(kvs), (name, kind, plan)


# ------------------------------------------------------------------ #
# the MoE family's routing, with drops

def test_moe_drop_yardsticks_drop_at_decode_and_differ(worlds):
    """The drop case's one-device yardsticks: the whole batch and two
    groups of rows drop tokens at prefill and at decode, and routing in
    one, two or four groups gives other tokens, so the per-shard
    comparison below tells the routings apart."""
    one = worlds[1]["one_device"]
    y = {g: one[("drop", "engine", g)] for g in worker.DROP_GROUPS}
    for g in (1, 2):
        assert y[g]["decode_drops"] and y[g]["prefill_drops"], g
    assert y[4]["prefill_drops"]
    for a, b in ((1, 2), (2, 4), (1, 4)):
        assert not np.array_equal(y[a]["tokens"], y[b]["tokens"]), (a, b)


def test_moe_routes_as_the_reference_with_drops(worlds):
    """Under data and shard on the meshes with a data axis the MoE family
    routes each batch rank's rows with their own capacity (data on
    (1,2,2) also cuts the batch over model: 4 groups), under pipeshard
    the whole batch as one; each gives its yardstick's tokens and
    logits."""
    one = worlds[1]["one_device"]
    groups = {}
    for world in WORLDS:
        for m in worlds[world]["meshes"]:
            for key, run in m["runs"].items():
                if key[0] != "drop":
                    continue
                want = one[("drop", "engine", run["groups"])]
                _close(run, want, "fp32", f"mesh {m['shape']} {key}")
                groups[(m["shape"], key[3])] = run["groups"]
    assert groups == {((1, 2, 1), "data"): 2, ((1, 2, 1), "shard"): 2,
                      ((1, 2, 2), "data"): 4, ((1, 2, 2), "shard"): 2,
                      ((2, 2, 1), "pipeshard"): 1}


# ------------------------------------------------------------------ #
# structure: collectives, handoffs, cache layouts

# a decode step's collectives a layer (a group of 2 Mamba2 layers and
# the shared block for the hybrid) under shard on a model axis of 2:
# attention gathers q, k and v over the heads and the blocks' partials
# (2 all-gathers) and adds its output and the MLP's or the experts'
# (2 all-reduces); the encoder-decoder's cross-attention gathers q over
# the heads and the frames' blocks' partials and adds its output (2
# all-gathers, 1 all-reduce more); Mamba1 gathers in_proj whole for use
# and adds x_proj's and out_proj's partial sums; Mamba2 gathers in_proj,
# conv_w and conv_b and adds the gated norm's mean square and out_proj's
# partial sums
PER_LAYER = {"dense": (2, 2), "moe": (2, 2), "ssm": (2, 1),
             "hybrid": (2 + 2 * 2, 2 + 2 * 3), "vlm": (2, 2),
             "encdec": (3, 4), "mla": (2, 2), "dsv2": (3, 2)}


def _shard_counts(worlds):
    """family -> (a layer's all-reduces and all-gathers, the embedding's
    all-reduces, the head's all-gathers) under shard on (1,1,2)."""
    m = next(m for m in worlds[2]["meshes"] if m["shape"] == (1, 1, 2))
    out = {}
    for name in worker.CASES:
        lo, hi = worker.COUNT_DEPTHS[name]
        c0, c1 = m["counts"][(name, lo)], m["counts"][(name, hi)]
        n = (hi - lo) // (2 if name == "hybrid" else 1)
        ar = (c1["all_reduce"]["calls"] - c0["all_reduce"]["calls"]) / n
        ag = (c1["all_gather"]["calls"] - c0["all_gather"]["calls"]) / n
        stack = lo // (2 if name == "hybrid" else 1)
        out[name] = (ar, ag, c0["all_reduce"]["calls"] - ar * stack,
                     c0["all_gather"]["calls"] - ag * stack)
    return out


def test_shard_decode_collectives_a_layer(worlds):
    counts = _shard_counts(worlds)
    for name, (ar, ag, emb, head) in counts.items():
        assert (ar, ag) == PER_LAYER[name], (name, counts[name])
        # the embedding's lookup (and the position table's of gpt2m and
        # whisper's decoder; the VLM's projector, whole on every rank,
        # adds none); the vocab-cut logits' gather
        assert emb == (2 if name in ("dense", "encdec") else 1), name
        assert head == 1, name


def _stage_lengths(split, stages, v, family):
    from repro_torch.core.pipeline import stage_rows
    cfg = worker.case_config(family)
    length = cfg.n_layers // (cfg.hybrid_attn_every or 1)
    split = split or (length // stages,) * stages
    return [len(stage_rows(split, stages, v, s)) for s in range(stages)]


@pytest.mark.parametrize("world", WORLDS)
def test_pipeshard_decode_handoffs_and_collectives(worlds, world):
    """One decode step under pipeshard, on every rank: a stage sends its
    last chunk's hidden state to the next chunk's stage and receives its
    first chunk's (a handoff within a rank is no send), the last stage's
    logits reach every stage by one broadcast (none on one stage), and
    inside a stage the model axis costs shard's collectives for each of
    its layers, the MoE layers one all-gather more (the whole batch's
    expert counts), the first stage the embedding's all-reduces, the
    last the logits' all-gather, and a data axis of 2 one all-gather of
    the rows."""
    shard = _shard_counts(worlds)
    for m in _meshes(worlds, world, worker.PIPE):
        S = m["stages"]
        for rank in m["ranks"]:
            s = rank["coord"]["stage"]
            for name in worker.CASES:
                split = None if worker.SPLITS[m["split"]] is None \
                    else worker.SPLITS[m["split"]][name]
                v = 1 if split is None else len(split) // S
                n_s = _stage_lengths(split, S, v, name)[s]
                c = rank["counts"][(name, worker.case_config(name)
                                    .n_layers)]
                calls = {k: c[k]["calls"] for k in c}
                chunks = S * v
                sends = sum(1 for ch in range(chunks - 1)
                            if ch % S == s and (ch + 1) % S != s)
                recvs = sum(1 for ch in range(1, chunks)
                            if ch % S == s and (ch - 1) % S != s)
                ar, ag, emb, head = shard[name]
                ag += name in worker.ROUTED
                want = {"all_reduce": ar * n_s + (emb if s == 0 else 0),
                        "all_gather": ag * n_s
                        + (head if s == S - 1 else 0)
                        + (m["shape"][1] > 1),
                        "reduce_scatter": 0, "broadcast": int(S > 1),
                        "send": sends, "recv": recvs}
                assert calls == want, (m["shape"], s, name, calls, want)
    if world == 3:
        m = _meshes(worlds, 3, worker.PIPE)[0]
        assert [r["counts"][("dense", 4)]["send"]["calls"]
                for r in m["ranks"]] == [1, 1, 0]


def _spec_shape(shape, spec, mesh_shape):
    """The block of a leaf of ``shape`` cut by ``spec`` on a mesh."""
    out = list(shape)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)) if e else ():
            out[d] //= mesh_shape[a]
    return tuple(out)


@pytest.mark.parametrize("world", (2, 3, 4))
def test_cache_layout_against_cache_spec(worlds, world):
    """Each rank's cache leaves are ``cache_spec``'s blocks but where
    the layout changes memory only: a pipeline stage holds its layers'
    rows of the stack dim (``cache_spec`` keeps it whole over
    ``stage``); with ``d_inner`` cut a rank's conv state holds the
    inputs of its channels (Mamba1: 256 of 512; Mamba2: its 256 x
    channels and the whole B and C, 272 of 528), where ``cache_spec``
    keeps it whole; under data and zero2 a rank holds its rows where the
    batch axes take ``model`` too (``cache_spec`` cuts the batch over
    the data axes only).  Every such difference is listed here."""
    seen = set()
    for m in worlds[world]["meshes"]:
        names = {"pod": m["shape"][0], "data": m["shape"][1],
                 "model": m["shape"][2]}
        if m["kind"] == worker.PIPE:
            names = {"stage": m["stages"],
                     "data": m["shape"][0] * m["shape"][1] // m["stages"],
                     "model": m["shape"][2]}
        for rank in m["ranks"]:
            for key, lay in rank["layouts"].items():
                name, _, kv, plan = key
                if name == "drop":
                    continue
                cfg = worker.case_config(name)
                for leaf, (mine, whole, spec) in lay.items():
                    want = _spec_shape(whole, spec, names)
                    for d, (a, b) in enumerate(zip(mine, want)):
                        if a == b:
                            continue
                        if d == 0 and plan == "pipeshard":
                            what = "stage rows"
                        elif leaf.endswith("conv") and d == len(mine) - 1:
                            di = cfg.ssm.expand * cfg.d_model
                            n = names["model"]
                            wide = di // n + (0 if cfg.ssm.version == 1
                                              else 2 * cfg.ssm.d_state)
                            assert a == wide and b == whole[d], \
                                (key, leaf, mine, want)
                            what = "conv channels"
                        elif plan in ("data", "zero2"):
                            assert a * names["model"] == b, (key, leaf)
                            what = "rows over model"
                        else:
                            raise AssertionError(
                                f"{m['shape']} {key} {leaf}: {mine} "
                                f"against cache_spec's {want}")
                        seen.add((what, name))
    want = {2: {("rows over model", n) for n in worker.FLAT_CASES}
            | {("conv channels", n) for n in ("ssm", "hybrid")}
            | {("stage rows", n) for n in worker.CASES},
            3: {("stage rows", n) for n in worker.CASES},
            4: {("conv channels", n) for n in ("ssm", "hybrid")}
            | {("stage rows", n) for n in worker.CASES}}
    assert seen == want[world]


# ------------------------------------------------------------------ #
# the launcher

@pytest.mark.parametrize("name", list(LAUNCHES))
def test_launcher_serves_under_torchrun_on_gloo(_started, name):
    proc = _started[name][1]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 3, out             # rank 0 prints, once
    plan = LAUNCHES[name][LAUNCHES[name].index("--plan") + 1]
    assert f"plan={plan}" in lines[0] and "(gloo, 2 ranks)" in lines[0]
    if plan == "pipeshard":
        assert "'stage': 2" in lines[0], out
    assert lines[1].startswith("prefill ") and "tok/s" in lines[1]
    words = lines[2].split()
    diff = float(words[words.index("|diff|") + 1])
    scale = float(words[words.index("|logit|") + 1])
    assert lines[2].startswith("against one device on each rank")
    assert 0 <= diff <= BF16_LOGIT_RTOL * scale, lines[2]


def test_moe_ties_reads_the_parting_and_replays_the_routing(_started):
    proc = _started["moe_ties"][1]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    # a prefill and five decode steps, each over two MoE layers
    assert len(res["free"]["parted_tokens_per_call"]) == 6 * 2
    first = res["free"]["first_parting"]
    assert first is None or all(t["one"]["experts"] != t["plan"]["experts"]
                                for t in first["parted"])
    assert 0 <= res["replayed"]["err"] \
        <= BF16_LOGIT_RTOL * res["replayed"]["scale"]


if __name__ == "__main__":
    # python tests/test_torch_serve_families.py OUT FAMILY...: the
    # reference's params and tokens of ``reference_tokens``
    torch.save(reference_tokens(sys.argv[2:]), sys.argv[1])
