"""Serving under the flat plans (data, zero2, shard, shard_zero, fsdp):
the engines on a mesh, with ``cache_spec``'s context-parallel KV cache.

* Numerics: gloo worlds of 1, 2 and 4 ranks, one spawn each
  (``tests/torch_serve_plan_worker.py``; meshes (1,1,1), (1,1,2),
  (1,2,1), (1,2,2) and (1,1,4) over (pod, data, model)), in fp32 on
  reduced gpt2m (MHA), llama3.2 with 2 kv heads (GQA, the vocab cut) and
  llama3.2 with one kv head and a vocab of 509 (table and logits whole):
  every plan's ``Engine`` (fp32 and int8 KV, a ring of 16 slots, one of
  15 and a window of 8 that wraps across the blocks) and
  ``ContinuousEngine`` give the one-device port's greedy tokens, with
  every step's logits within ``FP32_LOGIT_ATOL`` (fp32 KV) or
  ``INT8_LOGIT_RTOL`` of the largest logit (int8 KV).  The other port
  tests hold the one-device port to the JAX reference.
* A rank's cache under shard holds ``capacity / model`` slots of every
  KV head where ``model`` divides the capacity; a decode step costs two
  all-gathers and two all-reduces a layer.
* ``Plan.cache_spec`` equals the reference's on device-free meshes; the
  log-sum-exp merge of blocks equals whole-cache attention; each plan's
  ``Engine`` at a world of one equals the reference's ``Engine`` under
  the same plan on a (1, 1) mesh; the launcher serves under
  ``torch.distributed.run``; a plan needs its mesh; ``serve.placement``
  equals the reference's.  Pipeshard and the MoE, SSM and hybrid
  families are ``tests/test_torch_serve_families.py``'s.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.kernels import quantized as tq  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_serve_plan_worker as worker  # noqa: E402

WORLDS = (1, 2, 4)
# fp32 KV: the plans' sums in other orders (the model axis's partial
# sums, the merge of the ring's blocks, matmuls of other shapes)
FP32_LOGIT_ATOL = 1e-5
# int8 KV: an fp32 rounding difference upstream of the cache can move a
# cached value across an int8 rounding boundary, one step of 1/127 of
# its row's absmax; the one-device engine itself moves a logit by 7.6e-5
# of the largest when it runs one row of gpt2m's window case alone
# instead of in a batch of 4
INT8_LOGIT_RTOL = 1e-3
# the entry point, run beside the worlds on gloo, in the reduced config's
# bf16, its check against one device held to the bf16 envelope of the
# card's first-step logits (5% of the largest: the model axis adds its
# ranks' bf16 partial sums)
LAUNCHER = ["torch.distributed.run", "--nproc_per_node", "2",
            "--standalone", "-m", "repro_torch.launch.serve", "--reduced",
            "--device", "cpu", "--plan", "shard", "--mesh", "1,1,2",
            "--kv-dtype", "int8", "--batch", "4", "--gen", "6", "--check"]
BF16_LOGIT_RTOL = 5e-2
# the launcher alone (a world of one) with a limit no run meets
LIMIT_CHECK = ["repro_torch.launch.serve", "--reduced", "--device", "cpu",
               "--plan", "shard", "--batch", "3", "--gen", "3",
               "--check", "-1"]
SPEC_MESHES = ((1, 1, 1), (1, 1, 2), (1, 2, 1), (1, 2, 2), (1, 1, 4))
AXES = ("pod", "data", "model")


# ------------------------------------------------------------------ #
# the three worlds and the launcher, started at once in the background

@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("serve_plans")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d / "out.pt", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_serve_plan_worker.py"),
             str(d / "out.pt"), str(world)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    procs["torchrun"] = (None, subprocess.Popen(
        [sys.executable, "-m"] + LAUNCHER, env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs["limit"] = (None, subprocess.Popen(
        [sys.executable, "-m"] + LIMIT_CHECK, env=env, cwd=root,
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


def _runs(worlds, world, kind=None):
    """(mesh shape, key, run) of every run under a plan of a world."""
    for m in worlds[world]["meshes"]:
        for key, run in m["runs"].items():
            if kind is None or key[1] == kind:
                yield m["shape"], key, run


# ------------------------------------------------------------------ #
# cache_spec against the reference

def _configs(arch="gpt2m"):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(tconfigs.get_config(arch).reduced(),
                                dtype="float32"))


@pytest.mark.parametrize("plan", sorted(tplans.PLANS))
def test_cache_spec_matches_reference(plan):
    """Every mesh shape, both KV dtypes, the Engine's and the slot cache,
    batches of 4, 1 and 2 (as deep as the stack: both find the batch on
    the layer dim), rings of 16, 15 and a window of 8."""
    from repro.models import Model as JModel
    jcfg, tcfg = _configs()
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    n = 0
    for shape in SPEC_MESHES:
        jmesh = jplans.MeshSpec.of(shape, AXES)
        tmesh = tplans.MeshSpec.of(shape, AXES)
        for kv in ("fp32", "int8"):
            for slots in (False, True):
                for batch in (4, 1, 2):
                    for max_len, window in ((16, 0), (15, 0), (32, 8)):
                        kw = dict(window=window, kv_dtype=kv)
                        jinit = jm.init_slot_cache if slots \
                            else jm.init_cache
                        tinit = tm.init_slot_cache if slots \
                            else tm.init_cache
                        jc = jax.eval_shape(lambda: jinit(batch, max_len,
                                                          **kw))
                        tc = tinit(batch, max_len, device="meta", **kw)
                        assert tc._fields == jc._fields
                        for f in tc._fields:
                            assert tuple(getattr(tc, f).shape) == \
                                tuple(getattr(jc, f).shape)
                        want = jplans.PLANS[plan].cache_spec(jc, jcfg, jmesh,
                                                             batch)
                        got = tplans.PLANS[plan].cache_spec(tc, tcfg, tmesh,
                                                            batch)
                        assert type(got) is type(tc)
                        for f in tc._fields:
                            assert getattr(got, f) == \
                                tuple(getattr(want, f)), \
                                (plan, shape, kv, slots, batch, max_len, f)
                        n += 1
    assert n == len(SPEC_MESHES) * 2 * 2 * 3 * 3


# ------------------------------------------------------------------ #
# the log-sum-exp merge of the ring's blocks

def _decode_case(seed, kind, S=12, B=3, H=4, KV=2, D=16):
    """q and a cache of S slots with a mask whose row 0 lives in the
    first block only and row 1 in the last only, row 2 random."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=g)
    k = torch.randn((B, S, KV, D), generator=g)
    v = torch.randn((B, S, KV, D), generator=g)
    valid = torch.rand((B, S), generator=g) < 0.6
    valid[0] = False
    valid[0, :2] = True
    valid[1] = False
    valid[1, -1] = True
    if kind == "fp32":
        return q, (k, v), valid
    kq, ks = tq.quantize(k, block=D)
    vq, vs = tq.quantize(v, block=D)
    return q, (kq, ks[..., 0], vq, vs[..., 0]), valid


def _partial(kind, q, cache, valid):
    if kind == "fp32":
        return tattn.decode_attention(q, *cache, valid, with_lse=True)
    return tq.int8kv_attention_plain(q, *cache, valid, with_lse=True)


@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_merge_of_blocks_equals_whole_attention(kind, n):
    """Attention over n blocks of the ring (rows 0 and 1 have no live key
    in every block but one), merged by log-sum-exp, equals attention over
    the whole cache; the whole cache's lse is the blocks' combined."""
    q, cache, valid = _decode_case(n, kind)
    whole, whole_lse = _partial(kind, q, cache, valid)
    c = valid.shape[1] // n
    parts = [_partial(kind, q, tuple(t[:, r * c:(r + 1) * c]
                                     for t in cache),
                      valid[:, r * c:(r + 1) * c]) for r in range(n)]
    lses = torch.stack([lse for _, lse in parts])
    if n > 1:
        assert torch.isinf(lses[:, 0]).any() and torch.isinf(lses[:, 1]).any()
    got = tattn.merge_partials(torch.stack([o[:, 0] for o, _ in parts]),
                               lses)
    torch.testing.assert_close(got, whole[:, 0], rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.logsumexp(lses, 0), whole_lse,
                               rtol=0, atol=1e-5)
    # the plain versions' lse: torch.logsumexp of the live scores
    s = torch.einsum("bkgd,bskd->bkgs",
                     q.reshape(3, 2, 2, 16) / 4.0,
                     cache[0] if kind == "fp32"
                     else cache[0].float() * cache[1][..., None])
    s = s.masked_fill(~valid[:, None, None], float("-inf")).reshape(3, 4, -1)
    torch.testing.assert_close(whole_lse, torch.logsumexp(s, -1),
                               rtol=0, atol=1e-5)


def test_merge_of_one_block_is_exact_and_a_dead_row_has_no_weight():
    q, cache, valid = _decode_case(7, "int8")
    o, lse = _partial("int8", q, cache, valid)
    got = tattn.merge_partials(o[None, :, 0], lse[None])
    assert torch.equal(got, o[:, 0])
    dead = valid.clone()
    dead[2] = False
    _, lse = _partial("int8", q, cache, dead)
    assert torch.isinf(lse[2]).all() and (lse[2] < 0).all()
    assert torch.isfinite(lse[:2]).all()


# ------------------------------------------------------------------ #
# a world of one in this process: the reference's Engine, the refusals

@pytest.fixture(scope="module")
def one_rank():
    """A gloo world of one rank in this process and its mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield make_host_mesh((1, 1, 1), AXES)
    if started:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_setup():
    from repro.launch.mesh import make_host_mesh
    from repro.models import Model as JModel
    jcfg, tcfg = _configs()
    jm = JModel(jcfg)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        jp = jm.init(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(4, 400, (4, 7)).astype(np.int32)}
    return jm, jp, mesh, tcfg, tp, batch


@pytest.mark.parametrize("plan,kv", [(p, "fp32") for p in worker.PLANS]
                         + [("shard", "int8")])
def test_engine_at_a_world_of_one_equals_reference_engine(
        one_rank, reference_setup, plan, kv):
    from repro.serve import Engine as JEngine
    from repro_torch.serve import Engine
    jm, jp, mesh, tcfg, tp, batch = reference_setup
    want = JEngine(jm, jplans.get_plan(plan), mesh, batch_size=4,
                   max_len=16, kv_dtype=kv).generate(jp, batch, 5)["tokens"]
    eng = Engine(TModel(tcfg, device="cpu"), batch_size=4, max_len=16,
                 kv_dtype=kv, device="cpu", plan=plan, mesh=one_rank)
    got = eng.generate(eng.shard_params(tp), batch, 5)["tokens"]
    np.testing.assert_array_equal(got, want)


def test_a_plan_without_a_mesh_is_refused():
    """The engines serve under a plan on a mesh, or on one device: a plan
    without its mesh (or a mesh without a plan) raises.  Every family
    serves under every plan (``tests/test_torch_serve_families.py``)."""
    from repro_torch.serve import ContinuousEngine, Engine
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="plan= and mesh="):
        Engine(TModel(tcfg, device="cpu"), batch_size=4, max_len=16,
               device="cpu", plan="shard")
    with pytest.raises(ValueError, match="plan= and mesh="):
        ContinuousEngine(TModel(tcfg, device="cpu"), slots=4, max_len=16,
                         device="cpu", mesh=object())


def test_a_batch_as_deep_as_the_stack_raises(worlds, one_rank):
    """``cache_spec`` finds the batch dim by size: at a batch equal to
    the stack's depth (2 layers) it takes the layer dim, while the
    runtime lays out its own cache, a rank's rows of every layer.  Under
    shard on (1, 1, 2) and data on (1, 2, 1) the Engine (fp32 KV) and the
    ContinuousEngine (int8 KV, 2 slots) give one device's tokens, the
    Engine's logits within ``FP32_LOGIT_ATOL``.  (Named for the refusal
    it held until the runtime laid out its own cache there.)"""
    from repro_torch.serve.steps import ServePlan
    _, tcfg = _configs()
    sp = ServePlan(TModel(tcfg, device="cpu"), "shard", one_rank, max_len=16)
    shapes = sp.init_cache(tcfg.n_layers).k.shape
    spec = sp.plan.cache_spec(TModel(tcfg, device="cpu").init_cache(
        tcfg.n_layers, 16, device="meta"), tcfg, one_rank, tcfg.n_layers)
    assert spec.k[0] is not None             # the layer dim, taken by size
    assert (shapes[0], shapes[1]) == (tcfg.n_layers, tcfg.n_layers)
    assert sp.init_cache(tcfg.n_layers, kv_dtype="int8", slots=True) \
        .index.shape == (tcfg.n_layers, tcfg.n_layers)
    want = worlds[1]["deep"][None]
    got = worlds[2]["deep"]
    assert sorted(got) == [("data", (1, 2, 1)), ("shard", (1, 1, 2))]
    for key, run in got.items():
        eng = run["engine"]
        np.testing.assert_array_equal(eng["tokens"], want["engine"]["tokens"],
                                      err_msg=str(key))
        assert eng["tokens"].shape == (worker.DEEP, worker.GEN)
        for a, b in zip(eng["logits"], want["engine"]["logits"]):
            assert np.abs(a - b).max() <= FP32_LOGIT_ATOL, key
        rows = worker.DEEP // key[1][1]
        assert eng["shapes"]["k"][:2] == (worker.DEEP, rows), key
        assert run["cont"].keys() == want["cont"].keys()
        for uid, w in want["cont"].items():
            np.testing.assert_array_equal(run["cont"][uid], w,
                                          err_msg=f"{key} request {uid}")


# ------------------------------------------------------------------ #
# serve.placement, a copy of the reference's

def test_partitions_bell_numbers_equal_reference():
    from repro.serve.placement import partitions as jparts
    from repro_torch.serve.placement import partitions
    for n, bell in ((0, 1), (1, 1), (2, 2), (3, 5), (4, 15)):
        parts = list(partitions(range(n)))
        assert len(parts) == bell
        assert parts == list(jparts(range(n)))
        for p in parts:
            assert sorted(x for g in p for x in g) == list(range(n))


def _pinned_search(search_mod, topo_mod, placement_mod, configs_mod):
    """The reference benchmark's ``lan2+far`` scenario over one
    package's modules (``benchmarks/serving_bench.py``)."""
    from benchmarks.serving_bench import SLOTS
    topo = topo_mod.line("lan2+far",
                         [topo_mod.Site(("A30",) * 4, name=f"S{i}")
                          for i in range(3)],
                         [topo_mod.Link(0.2e-3, 10.0),
                          topo_mod.Link(80e-3, 1.0)])
    wl = placement_mod.decode_workload(configs_mod.get_config("llama3.2-3b"),
                                       slots=SLOTS)
    return search_mod.PlanSearch(wl, topo)


def test_placement_winner_map_gate_equals_reference():
    """The pinned scenario of the reference's gate: at 50% single-site
    load the far site keeps its own replica while the LAN pair shares
    one; at 90% every replica stays under the utilization ceiling; every
    price equals the reference's."""
    from benchmarks.serving_bench import PROMPT_LEN, SLOTS
    from repro.core import search as jsearch
    from repro.core import topology as jtopo
    from repro.serve import placement as jplace
    from repro_torch.core import search as tsearch
    from repro_torch.core import topology as ttopo
    from repro_torch.serve import placement as tplace
    out = []
    for search_mod, topo_mod, place, cfgs in (
            (jsearch, jtopo, jplace, jconfigs),
            (tsearch, ttopo, tplace, tconfigs)):
        search = _pinned_search(search_mod, topo_mod, place, cfgs)
        single, _ = place._price_group(search, search.topology, [0],
                                       [0.0, 0.0, 0.0], slots=SLOTS,
                                       prompt_len=PROMPT_LEN, gen_len=64)
        cap = SLOTS / (single.prefill_s + 64 * single.decode_step_s)
        runs = [place.place_replicas(search, [share * cap] * 3, slots=SLOTS,
                                     prompt_len=PROMPT_LEN, gen_len=64)
                for share in (0.5, 0.9)]
        out.append((single, runs))
    (jsingle, jruns), (single, runs) = out
    assert dataclasses.astuple(single) == dataclasses.astuple(jsingle)
    half, hot = runs
    assert (2,) in half.groups, half.groups
    assert any(0 in g and 1 in g for g in half.groups), half.groups
    assert hot is not None and all(r.rho < 0.95 for r in hot.replicas)
    for got, want in zip(runs, jruns):
        assert got.groups == want.groups
        assert got.mean_latency_s == want.mean_latency_s
        assert [dataclasses.astuple(r) for r in got.replicas] == \
            [dataclasses.astuple(r) for r in want.replicas]


# ------------------------------------------------------------------ #
# numerics against the one-device port

@pytest.mark.parametrize("plan", worker.PLANS)
@pytest.mark.parametrize("world", WORLDS)
def test_engine_tokens_and_logits_equal_one_device(worlds, world, plan):
    one = worlds[1]["one_device"]
    n = 0
    for shape, key, got in _runs(worlds, world, "engine"):
        if key[-1] != plan:
            continue
        name, _, kv, layout, _ = key
        want = one[key[:-1]]
        what = f"world {world} mesh {shape} {key}"
        np.testing.assert_array_equal(got["tokens"], want["tokens"],
                                      err_msg=what)
        assert len(got["logits"]) == len(want["logits"]) == worker.GEN
        top = max(np.abs(w).max() for w in want["logits"])
        tol = FP32_LOGIT_ATOL if kv == "fp32" else INT8_LOGIT_RTOL * top
        for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            assert a.shape == b.shape == (worker.BATCH,
                                          worker.case_config(name)
                                          .vocab_size)
            err = np.abs(a - b).max()
            assert err <= tol, f"{what} step {step}: {err} > {tol}"
        n += 1
    per_mesh = len(worker.LAYOUTS) if world == 1 else 1
    assert n == len(worker.CASES) * per_mesh * 2


@pytest.mark.parametrize("plan", worker.PLANS)
@pytest.mark.parametrize("world", WORLDS)
def test_continuous_tokens_equal_one_device(worlds, world, plan):
    one = worlds[1]["one_device"]
    n = 0
    for shape, key, got in _runs(worlds, world, "cont"):
        if key[-1] != plan:
            continue
        want = one[key[:-1]]
        assert got.keys() == want.keys() == set(
            range(len(worker.REQUEST_LENS)))
        for uid, w in want.items():
            assert w.shape == (worker.GEN,)
            np.testing.assert_array_equal(
                got[uid], w, err_msg=f"world {world} mesh {shape} {key} "
                f"request {uid}")
        n += 1
    assert n == len(worker.CASES) * 2


@pytest.mark.parametrize("world", (2, 4))
def test_every_plan_case_and_layout_meets_the_world(worlds, world):
    """On worlds 2 and 4 every plan runs every case and every cache
    layout, on each mesh; each (plan, case) runs the Engine with both KV
    dtypes and two layouts, the ContinuousEngine with both capacities
    and KV dtypes."""
    keys = {key for _, key, _ in _runs(worlds, world)}
    engine = [k for k in keys if k[1] == "engine"]
    for plan in worker.PLANS:
        for m in worlds[world]["meshes"]:
            mine = [k for k in m["runs"] if k[1] == "engine"
                    and k[4] == plan]
            assert {k[0] for k in mine} == set(worker.CASES)
            assert {k[3] for k in mine} == set(worker.LAYOUTS)
        for name in worker.CASES:
            runs = [k for k in engine if k[0] == name and k[4] == plan]
            assert {k[2] for k in runs} == {"fp32", "int8"}
            assert len({k[3] for k in runs}) == 2
            conts = {(k[2], k[3]) for k in keys if k[0] == name
                     and k[1] == "cont" and k[4] == plan}
            assert {kv for kv, _ in conts} == {"fp32", "int8"}
            assert {lay for _, lay in conts} == set(worker.CONT_LAYOUTS)
    for name in worker.CASES:
        assert {k[3] for k in engine if k[0] == name} == \
            set(worker.LAYOUTS)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_cache_holds_a_block_of_every_kv_head(worlds, world):
    """Under shard a rank holds its rows and ``capacity / model`` ring
    slots of every KV head where ``model`` divides the capacity, the
    whole ring where it does not."""
    for shape, key, got in _runs(worlds, world, "engine"):
        name, _, kv, layout, plan = key
        if plan != "shard":
            continue
        cfg = worker.case_config(name)
        max_len, window, _ = worker.LAYOUTS[layout]
        cap = min(max_len, window) if window else max_len
        model = shape[2]
        per = cap // model if cap % model == 0 else cap
        rows = worker.BATCH // shape[1]       # the data axis cuts the rows
        leaf = "k" if kv == "fp32" else "k_q"
        assert got["shapes"][leaf] == (cfg.n_layers, rows, per,
                                       cfg.n_kv_heads, cfg.head_dim), key
        if kv == "int8":
            assert got["shapes"]["k_scale"] == (cfg.n_layers, rows, per,
                                                cfg.n_kv_heads)
        assert got["shapes"]["index"] == (cfg.n_layers,)
        if layout == "divides" and model > 1:
            assert per < cap


@pytest.mark.parametrize("world", WORLDS)
def test_shard_decode_step_collectives_a_layer(worlds, world):
    """A decode step under shard: per layer one all-gather of q, k and v
    over the heads, one of the blocks' partials and two all-reduces
    (attention's and the MLP's output); besides the layers, the
    vocab-cut logits' all-gather and the embedding and position
    lookups' all-reduces.  No rows are gathered on these meshes' shard
    batch axes but the data axis."""
    for m in worlds[world]["meshes"]:
        counts = m["counts"]
        (l0, c0), (l1, c1) = sorted(counts.items())
        for kind in ("all_gather", "all_reduce"):
            per = (c1[kind]["calls"] - c0[kind]["calls"]) / (l1 - l0)
            assert per == 2, (m["shape"], kind, counts)
        rows = 1 if m["shape"][1] > 1 else 0
        assert c0["all_gather"]["calls"] == 2 * l0 + 1 + rows
        assert c0["all_reduce"]["calls"] == 2 * l0 + 2
        for kind in ("reduce_scatter", "send", "recv"):
            assert c0[kind]["calls"] == 0


def test_launcher_serves_under_torchrun_on_gloo(_started):
    proc = _started["torchrun"][1]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 3, out             # rank 0 prints, once
    assert "plan=shard" in lines[0] and "'model': 2" in lines[0], out
    assert "(gloo, 2 ranks)" in lines[0]
    assert lines[1].startswith("prefill ") and "tok/s" in lines[1]
    words = lines[2].split()
    err = float(words[words.index("|diff|") + 1])
    scale = float(words[words.index("|logit|") + 1])
    assert lines[2].startswith("against one device on each rank")
    assert 0 <= err <= BF16_LOGIT_RTOL * scale, lines[2]


def test_launcher_check_exits_non_zero_beyond_its_limit(_started):
    """``--check RTOL`` fails the run where a teacher-forced logit
    differs from one device's by more than RTOL of the largest."""
    proc = _started["limit"][1]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode != 0, out
    assert "against one device on each rank" in out, out
    assert "teacher-forced logits differ from one device by" in err, \
        err[-3000:]
