"""The port's execution plans against the reference's specs and against
the one-device port.

* Specs: for every plan of ``PLANS``, the reduced configs of six
  ported families and full gpt2L (the port's shapes on the meta device,
  the reference's from ``jax.eval_shape``), on three meshes, the port's
  ``param_specs``, ``opt_specs`` and ``batch_spec`` equal the
  reference's ``PartitionSpec``s (computed from ``MeshSpec`` alone).
* Numerics: gloo worlds of 1, 2 and 4 ranks (meshes (1,1,1), (1,1,2),
  (1,2,2)), one spawn each (``tests/torch_plan_worker.py``), run data,
  zero2, shard and shard_zero in fp32 on reduced gpt2m, GQA llama3.2 and
  a llama3.2 of one kv head and a 509-token vocab (falcon-mamba under
  data and zero2), held to the one-device
  port, which the other port tests hold to the JAX reference: losses over
  3 steps within 1e-5 relative; step-1 gradients, gathered, leaf by leaf
  within 1e-5 of the leaf's largest value (floored at ``LEAF_FLOOR`` of
  the largest gradient, as in ``test_torch_train.py``); the param norm
  within 1e-6 relative; every plan bit-equal at world 1.  The key
  bias's gradient is 0 in exact arithmetic (it shifts a row's scores
  alike), so both sides hold rounding noise of ~1e-7 of the largest
  gradient there, which the floor does not cover at 1e-5: that leaf is
  held to ``ZERO_LEAF`` (1e-6) of the largest gradient on both sides.
* ZeRO memory, the collectives a layer under shard, a shard checkpoint
  restored on one device, the launcher under ``torch.distributed.run``
  and ``launch.plan_check``, the refusals, and an encoder-decoder
  batch's frames cut with its tokens on every rank of a mesh.
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

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.core.sharding import _path_str  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.convert import flatten  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core.steps import build_train_step  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_plan_worker as worker  # noqa: E402

LOSS_RTOL, GRAD_RTOL, NORM_RTOL = 1e-5, 1e-5, 1e-6
LEAF_FLOOR = 1e-3
ZERO_LEAF, ZERO_LEAVES = 1e-6, ("layers/attn/bk",)
WORLDS = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 2, 2)}
SPEC_MESHES = ((1, 2, 2), (2, 2, 2), (1, 1, 16))
# two entry points, run beside the worlds: the launcher under
# torch.distributed.run on gloo, and plan_check
LAUNCHER = ["torch.distributed.run", "--nproc_per_node", "2",
            "--standalone", "-m", "repro_torch.launch.train", "--arch",
            "gpt2m", "--reduced", "--device", "cpu", "--plan", "shard_zero",
            "--mesh", "1,1,2", "--steps", "2", "--seq", "32", "--batch", "4",
            "--docs", "60"]
PLAN_CHECK = ["repro_torch.launch.plan_check", "--device", "cpu", "--world",
              "1", "--steps", "2"]
SPEC_ARCHS = ("gpt2m", "llama3.2-3b", "phi3.5-moe-42b-a6.6b",
              "falcon-mamba-7b", "zamba2-2.7b", "whisper-small", "gpt2L")


# ------------------------------------------------------------------ #
# the three worlds, started at once in the background; the spec tests
# run meanwhile

@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("plans")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for world, shape in WORLDS.items():
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d / "out.pt", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_plan_worker.py"),
             str(d / "out.pt"), str(world), ",".join(map(str, shape))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for name, argv in (("torchrun", LAUNCHER), ("plan_check", PLAN_CHECK)):
        procs[name] = (None, subprocess.Popen(
            [sys.executable, "-m"] + argv, env=env, cwd=root,
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
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log[-4000:]
        out[world] = torch.load(path, weights_only=False)
    return out


def _finished(started, name):
    proc = started[name][1]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


# ------------------------------------------------------------------ #
# specs

def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(path): tuple(spec) for path, spec in leaves}


def _configs(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if arch != "gpt2L":
        j, t = j.reduced(), t.reduced()
    return j, t


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_plan_specs_equal_reference(arch):
    jcfg, tcfg = _configs(arch)
    jshapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0)))
    tshapes = TModel(tcfg, device="cpu").init(torch.Generator(),
                                              device="meta")
    assert {k: tuple(v.shape) for k, v in flatten(tshapes).items()} == \
        {_path_str(p): tuple(v.shape)
         for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    batches = [{"tokens": np.zeros((b, 16), np.int32),
                "labels": np.zeros((b, 16), np.int32)} for b in (1, 6, 8)]
    assert sorted(tplans.PLANS) == sorted(jplans.PLANS)
    for name in tplans.PLANS:
        jp, tp = jplans.PLANS[name], tplans.PLANS[name]
        for shape in SPEC_MESHES:
            mesh = ("pod", "data", "model")
            jm, tm = jplans.MeshSpec.of(shape, mesh), \
                tplans.MeshSpec.of(shape, mesh)
            where = f"{arch} {name} {shape}"
            assert flatten(tp.param_specs(tshapes, tcfg, tm)) == \
                _ref_specs(jp.param_specs(jshapes, jcfg, jm)), where
            assert flatten(tp.opt_specs(tshapes, tcfg, tm)) == \
                _ref_specs(jp.opt_specs(jshapes, jcfg, jm)), where
            for batch in batches:
                assert tp.batch_spec(batch, tm) == \
                    _ref_specs(jp.batch_spec(batch, jm)), where
                assert tp.batch_axes(tm, batch["tokens"].shape[0]) == \
                    jp.batch_axes(jm, batch["tokens"].shape[0])


def test_gpt2L_vocab_stays_whole_on_a_model_axis_of_two():
    """50257 divides no model axis above 1: the table (and with it the
    logits) stays whole under shard; the heads and the MLP are cut."""
    cfg = tconfigs.get_config("gpt2L")
    shapes = TModel(cfg, device="cpu").init(torch.Generator(),
                                            device="meta")
    specs = flatten(tplans.PLANS["shard"].param_specs(
        shapes, cfg, tplans.MeshSpec.of((1, 1, 2), ("pod", "data",
                                                    "model"))))
    assert specs["embed/table"] == ()
    assert specs["layers/attn/wq"] == (None, None, "model")
    assert specs["layers/mlp/w_up"] == (None, None, "model")
    assert specs["pos_embed/table"] == ("model",)


def test_topology_mesh_spec_equals_reference():
    """The mesh of every paper topology's site selections, as the
    reference shapes it; a pipeline placement's staged grid, as the
    reference reshapes its devices."""
    from repro.core.costmodel import PAPER_TOPOLOGIES as JTOPOS
    from repro.launch.mesh import topology_mesh_spec as jspec
    from repro_torch.core.costmodel import PAPER_TOPOLOGIES as TTOPOS
    from repro_torch.launch.mesh import topology_mesh_spec
    assert sorted(JTOPOS) == sorted(TTOPOS)
    for name, jt in JTOPOS.items():
        for sites in (None, (0,), (1,)):
            n = len(jt.sites[(sites or (0,))[0]].gpus)
            for model in sorted({1, 2, n}):
                want = jspec(jt, sites, model=model) \
                    if n % model == 0 else None
                if want is None:
                    with pytest.raises(ValueError):
                        topology_mesh_spec(TTOPOS[name], sites, model=model)
                    continue
                assert topology_mesh_spec(TTOPOS[name], sites,
                                          model=model) == want, name
    from jax.sharding import Mesh as JMesh
    from repro.core.pipeline import pipeline_mesh as jpipeline_mesh
    from repro_torch.core.pipeline import pipeline_mesh
    for order in ((0, 1), (1, 0)):
        placement = tplans.Placement((0, 1), order)
        shape, axes = topology_mesh_spec(TTOPOS[name], placement.sites)
        grid = np.arange(int(np.prod(shape))).reshape(shape)
        want = jpipeline_mesh(JMesh(grid, axes), placement.n_stages,
                              stage_order=placement.pod_permutation())
        assert np.array_equal(pipeline_mesh(
            grid, axes, placement.n_stages,
            stage_order=placement.pod_permutation()),
            np.asarray(want.devices)), (name, order)


# ------------------------------------------------------------------ #
# numerics against the one-device port

def _assert_leaves(got, want, what):
    top = max(np.abs(w).max() for w in want.values())
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key in ZERO_LEAVES:
            assert max(np.abs(w).max(), np.abs(got[key]).max()) <= \
                ZERO_LEAF * top, f"{what} {key}"
            continue
        scale = max(np.abs(w).max(), LEAF_FLOOR * top)
        err = np.abs(got[key] - w).max()
        assert err <= GRAD_RTOL * scale, f"{what} {key}: {err} > " \
            f"{GRAD_RTOL} x {scale}"


@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("world", list(WORLDS))
def test_plans_match_one_device(worlds, world, case):
    rec = worlds[world]["cases"][case]
    ref = rec["one_device"]
    for plan in worker.plans_of(case):
        got, what = rec[plan], f"world {world} {case} {plan}"
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=what)
        _assert_leaves(got["grads"], ref["grads"], what)
        assert got["param_norm"] == pytest.approx(ref["param_norm"],
                                                  rel=NORM_RTOL), what


@pytest.mark.parametrize("plan", worker.PLAN_NAMES)
def test_world_of_one_is_bit_equal_to_one_device(worlds, plan):
    """At a world of one every collective is a copy, and shard's
    vocab-parallel logsumexp runs ``torch.logsumexp``'s operations and
    backward formula, so every plan repeats the one-device bits."""
    for case, rec in worlds[1]["cases"].items():
        if plan not in rec:
            continue
        ref, got = rec["one_device"], rec[plan]
        assert got["losses"] == ref["losses"], case
        for key, w in ref["params"].items():
            assert np.array_equal(got["params"][key], w), (case, key)


def test_model_axis_cuts_follow_the_specs(worlds):
    cases = worlds[4]["cases"]
    for plan in ("data", "zero2"):
        assert cases["gpt2m"][plan]["model_axis"] is None
    gpt2 = cases["gpt2m"]["shard"]["model_axis"]
    assert gpt2 == {"size": 2, "rank": gpt2["rank"], "vocab": True,
                    "positions": True, "heads": True, "kv_heads": True,
                    "mlp": True}
    kv1 = cases["vocab509"]["shard"]["model_axis"]
    assert kv1["heads"] and not kv1["kv_heads"] and not kv1["vocab"]


@pytest.mark.parametrize("world", [2, 4])
def test_zero2_moments_hold_one_block_of_each_cut_leaf(worlds, world):
    """Local m and v hold 1/N of every leaf ``zero_specs`` cuts, N the
    data axes' size (the model axis of (1,1,2) is folded into the batch,
    not into the optimizer's blocks)."""
    n = np.prod(WORLDS[world][:2])
    moments = worlds[world]["cases"]["gpt2m"]["zero2"]["moments"]
    cut = 0
    for key, (full, m, v, parts) in moments.items():
        assert m == v, key
        assert parts in (1, n), key
        assert np.prod(m) * parts == np.prod(full), key
        cut += parts > 1
    assert cut == (len(moments) if n > 1 else 0)


def test_shard_collectives_a_layer_with_remat(worlds):
    """gpt2m under shard at (1,2,2), remat on, one step: one layer more
    adds 5 all-reduces of a [B_local, S, d] activation (the forward's g
    after attention and after the MLP; the recompute's g after attention,
    while the recompute of the MLP stops at the down projection, the
    last tensor its backward saves; the backward's f before attention
    and before the MLP) and the layer's share of the gradient
    all-reduces over the data axes, which go one a stacked leaf."""
    lc = worlds[4]["layer_counts"]
    lo, hi = (lc[L] for L in worker.COUNT_LAYERS)
    assert lo["batch_axes"] == ("pod", "data")
    cfg = worker.case_config("gpt2m")
    b_local = worker.BATCH // 2
    act = b_local * worker.SEQ * cfg.d_model * 4
    grad = (hi["layer_numel"] - lo["layer_numel"]) * 4
    calls = {k: hi["counts"][k]["calls"] - lo["counts"][k]["calls"]
             for k in hi["counts"]}
    nbytes = {k: hi["counts"][k]["bytes"] - lo["counts"][k]["bytes"]
              for k in hi["counts"]}
    assert calls == {"all_reduce": 5, "reduce_scatter": 0, "all_gather": 0,
                     "broadcast": 0, "send": 0, "recv": 0}
    assert nbytes == {"all_reduce": 5 * act + grad, "reduce_scatter": 0,
                      "all_gather": 0, "broadcast": 0, "send": 0, "recv": 0}


def test_shard_checkpoint_restores_on_one_device(worlds):
    """The world of 4 trained gpt2m 2 steps under shard and rank 0 wrote
    the gathered checkpoint; one device restores it, and its step 2
    matches a one-device run of 3 steps."""
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import restore_checkpoint, train
    cfg = worker.case_config("gpt2m")
    tcfg = worker.train_config()
    model = TModel(cfg, device="cpu")
    like = tree_map(torch.empty_like, worker.init_params(model))
    path = os.path.join(worlds[4]["ckpt"], f"step_{worker.CKPT_STEPS:08d}")
    params, opt, step = restore_checkpoint(path, like, init_adamw(like))
    assert step == worker.CKPT_STEPS == int(opt.step)
    loader = worker.make_loader(cfg.vocab_size)
    whole = train(model, tcfg, loader, steps=3, log_every=0)
    again = train(model, tcfg, loader, steps=3, params=params,
                  opt_state=opt, start_step=worker.CKPT_STEPS, log_every=0)
    assert again.losses[0] == pytest.approx(whole.losses[2], rel=LOSS_RTOL)
    assert worker.param_norm(again.params) == pytest.approx(
        worker.param_norm(whole.params), rel=NORM_RTOL)


# ------------------------------------------------------------------ #
# entry points

def test_launcher_trains_under_torchrun_on_gloo(_started):
    out = _finished(_started, "torchrun")
    assert out.count("done: loss") == 1, out


def test_plan_check_prints_every_plan_beside_one_device(_started):
    res = json.loads(_finished(_started, "plan_check").strip()
                     .splitlines()[-1])
    assert sorted(res) == sorted(("one_device",) + tuple(tplans.PLANS))
    for name, r in res.items():
        np.testing.assert_allclose(r["losses"], res["one_device"]["losses"],
                                   rtol=LOSS_RTOL, err_msg=name)
        assert r["param_norm"] == pytest.approx(
            res["one_device"]["param_norm"], rel=NORM_RTOL)


# ------------------------------------------------------------------ #
# what the plans refused until MLA ran under them

@pytest.mark.parametrize("arch,plan,item", [
    ("deepseek-v2-236b", "pipeshard", "item 13"),
    ("minicpm3-4b", "fsdp", "item 13"),
    ("minicpm3-4b", "shard_zero", "item 13"),
])
def test_plans_not_ported_raise_with_their_roadmap_item(arch, plan, item):
    """Every plan runs every family (the vision-language and the
    encoder-decoder ones: ``test_torch_plan_families.py``), and since
    ROADMAP queue 1, ``item``, Multi-head Latent Attention too: two steps
    at a gloo world of one give one device's losses, bit for bit under a
    flat plan.  (Named for the refusal it held until then.)"""
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                              dtype="float32")
    got, want, same = worker.steps_at_world_of_one(cfg, plan)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=item)
    if plan != "pipeshard":
        assert got == want and same, item


class _RankView:
    """A mesh of ``shape`` over ``axes`` seen from the rank at ``coord``:
    what ``Plan.batch_spec`` and ``core.steps._local_rows`` read of a
    ``core.sharding.Mesh``, without a process group."""

    def __init__(self, shape, axes, coord):
        self.axis_names, self.shape = axes, dict(zip(axes, shape))
        self.coord = dict(zip(axes, coord))

    def count(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i


@pytest.mark.parametrize("plan", sorted(tplans.PLANS))
def test_frames_are_the_rows_of_their_tokens(plan):
    """An encoder-decoder batch's ``frames`` [B, F, d] are cut with its
    tokens over the plan's batch axes, in each of the step's microbatches
    (``grad_accum``'s, or a pipeline's): on every rank of a mesh with a
    data axis, the frames it holds are those of the rows of the tokens
    it holds, and over the batch ranks each row is held once a
    microbatch."""
    from repro_torch.core.steps import _local_rows
    B, F, d, groups = 8, 3, 2, 2
    rows = np.arange(B)
    batch = {"tokens": np.repeat(rows[:, None], 5, 1),
             "labels": np.repeat(rows[:, None], 5, 1),
             "frames": np.broadcast_to(rows[:, None, None].astype(np.float32),
                                       (B, F, d)).copy()}
    p = tplans.PLANS[plan]
    axes = ("stage", "data", "model") if p.pipeline \
        else ("pod", "data", "model")
    for shape in ((2, 2, 1), (1, 2, 2)):
        held = []
        for coord in np.ndindex(*shape):
            view = _RankView(shape, axes, coord)
            spec = p.batch_spec(batch, view)
            assert spec["frames"] == spec["tokens"], (plan, shape)
            local = _local_rows(batch, spec, view, groups, "cpu")
            got = local["frames"][:, 0, 0].long()
            assert torch.equal(got, local["tokens"][:, 0]), (plan, coord)
            assert torch.equal(local["frames"],
                               got[:, None, None].float().expand(-1, F, d))
            held.append(got.view(groups, -1))
        # each microbatch's rows, [i B/m, (i+1) B/m), over the batch ranks
        n = view.count(p.batch_axes(view, B)) if p.batch_axes(view, B) \
            else 1
        assert n > 1 or not p.batch_axes(view, B)
        for i in range(groups):
            mine = torch.cat([h[i] for h in held]).tolist()
            want = list(range(i * B // groups, (i + 1) * B // groups))
            assert sorted(set(mine)) == want, (plan, shape, i)
            assert len(mine) == len(want) * len(held) // n, (plan, shape)


def test_one_device_step_clears_the_model_axis():
    model = TModel(dataclasses.replace(
        tconfigs.get_config("gpt2m").reduced(), dtype="float32"),
        device="cpu")
    model.model_axis = object()
    build_train_step(model, TrainConfig())
    assert model.model_axis is None
