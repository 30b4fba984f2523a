"""Every plan of ``PLANS`` for every family the port has: fsdp, and the
MoE, SSM, hybrid and vision-language families under the flat plans and
pipeshard.

* Numerics: gloo worlds of 1, 2 and 4 ranks, one spawn each
  (``tests/torch_plan_family_worker.py``; flat meshes (1,1,1), (1,1,2),
  (1,2,2), and on worlds 2 and 4 a pipeline of two stages, the second
  over a data axis of two), in fp32 on reduced configs: gpt2m under
  fsdp; phi3.5-MoE under data, zero2, shard, shard_zero and fsdp (and,
  under shard, three experts, which a model axis of two leaves whole,
  and a shared expert, which takes the dense MLP's cut); falcon-mamba
  and zamba2 under shard, shard_zero and fsdp (and zamba2 with three
  Mamba2 heads, which a model axis of two cannot cut, under shard);
  phi-3-vision, its batch carrying patch embeddings, under data, zero2,
  shard, shard_zero and fsdp (the projector whole on every model rank,
  gathered at its use under fsdp); falcon-mamba, zamba2, phi3.5-MoE and
  phi-3-vision under pipeshard with GPipe and 1F1B. Each is held to the
  one-device port, which the other port tests hold to the JAX reference,
  as ``test_torch_plans.py`` holds the dense family: losses over 3 steps
  within 1e-5 relative, step-1 gradients leaf by leaf within 1e-5 of the
  leaf's largest value (floored at ``LEAF_FLOOR`` of the largest
  gradient; the key bias's gradient, 0 in exact arithmetic, within
  ``ZERO_LEAF``), the param norm within 1e-6 relative, and bit-equality
  at world 1.  The MoE
  family routes each batch rank's tokens on their own under the flat
  plans and each microbatch as one under pipeshard, so its yardstick is
  the one-device port with ``grad_accum`` equal to the routed groups,
  on a batch whose groups hold equal token counts.
* MoE semantics with dropping experts (capacity factor 0.5), against
  the reference's ``_moe_forward_impl`` through its ``Model.loss`` on
  each routed group's rows: per shard under the flat plans, per global
  microbatch ``[i B/m, (i+1) B/m)`` under pipeshard over a data axis of
  two.
* fsdp: a rank's persistent params and moments are its blocks, and one
  step gathers each layer's leaves twice (forward, remat's recompute)
  and reduce-scatters them once, a layer at a time; a checkpoint
  written from fsdp blocks restores onto shard.
* The SSM leaves whose cut does not follow the channels: their gradient
  blocks equal the one-device gradients' blocks.
* Every plan builds for every family; the families the port does not
  have raise with their ROADMAP item; the staged specs of the families
  equal the reference's.
* The dry run (``launch/dryrun.py``, meta tensors over a fake world of 4)
  counts each rank's collectives of one step of reduced gpt2m in bf16
  under data, zero2, shard (mesh (1, 2, 2)) and pipeshard (two stages of
  a data axis of two), call for call and byte for byte as the world of
  4 counts them (``sharding.collective_counts``).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.core.sharding import _path_str  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core.sharding import spec_axes  # noqa: E402
from repro_torch.core.steps import build_train_step  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_plan_family_worker as worker  # noqa: E402
import torch_plan_worker as plan_worker  # noqa: E402

LOSS_RTOL, GRAD_RTOL, NORM_RTOL = 1e-5, 1e-5, 1e-6
LEAF_FLOOR = 1e-3
ZERO_LEAF, ZERO_LEAVES = 1e-6, ("layers/attn/bk",)
WORLDS = (1, 2, 4)
MOE = "phi3.5-moe-42b-a6.6b"
FAMILY_ARCHS = (MOE, "falcon-mamba-7b", "zamba2-2.7b", "phi-3-vision-4.2b")


# ------------------------------------------------------------------ #
# the three worlds, started at once in the background

@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("families")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d / "out.pt", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_plan_family_worker.py"),
             str(d / "out.pt"), str(world)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
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


def _ref(worlds, name, got):
    """The one-device yardstick of a flat run (world 1's): the MoE
    cases' with ``grad_accum`` = the batch ranks that route apart."""
    refs = worlds[1]["one_device"]["flat"][name]
    return refs[got["batch_parts"] if name in worker.MOE_ACCUM else 1]


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


def _assert_matches(got, ref, what):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL,
                               err_msg=what)
    _assert_leaves(got["grads"], ref["grads"], what)
    assert got["param_norm"] == pytest.approx(ref["param_norm"],
                                              rel=NORM_RTOL), what


# ------------------------------------------------------------------ #
# specs of the staged families (no worker needed)

def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_staged_specs_equal_reference(arch):
    """pipeshard's specs of the MoE, SSM, hybrid and vision-language
    families (the hybrid's two stacked dims and its ``gates``, the VLM's
    projector) equal the reference's,
    on staged meshes whose stage axis divides the stack and does not."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    if arch.startswith("zamba2"):
        jcfg = dataclasses.replace(jcfg, n_layers=6)
        tcfg = dataclasses.replace(tcfg, n_layers=6)
    jshapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0)))
    tshapes = TModel(tcfg, device="cpu").init(torch.Generator(),
                                              device="meta")
    jp, tp = jplans.PLANS["pipeshard"], tplans.PLANS["pipeshard"]
    for shape in ((2, 1, 2), (3, 1, 1), (2, 2, 2)):
        axes = tpipe.STAGED_AXES
        jm, tm = jplans.MeshSpec.of(shape, axes), \
            tplans.MeshSpec.of(shape, axes)
        assert convert.flatten(tp.param_specs(tshapes, tcfg, tm)) == \
            _ref_specs(jp.param_specs(jshapes, jcfg, jm)), shape


# ------------------------------------------------------------------ #
# MoE semantics with dropping experts: the reference's numbers (computed
# while the worlds run), then the worlds' against them

def _rows(n_groups):
    B = plan_worker.BATCH
    return [np.arange(i * B // n_groups, (i + 1) * B // n_groups)
            for i in range(n_groups)]


def _own_rows(m):
    """pipeshard's microbatches cut from each data rank's own rows (of
    two data ranks), the grouping the reference does not take."""
    B = plan_worker.BATCH
    return [np.array([i * B // (2 * m) + r * B // 2 + j
                      for r in range(2) for j in range(B // (2 * m))])
            for i in range(m)]


@pytest.fixture(scope="module")
def drop_reference():
    """The reference's ``Model.loss`` on the drop config (capacity
    factor 0.5) from the port's initial params, on the drop batch routed
    group by group: loss, ce and aux of each grouping (the token sums
    over the whole batch, the mean of the groups' auxes), and the
    batch's tokens."""
    tcfg = worker.config(MOE, capacity_factor=worker.DROP_FACTOR)
    jred = jconfigs.get_config(MOE).reduced()
    jcfg = dataclasses.replace(jred, dtype="float32", moe=dataclasses.replace(
        jred.moe, capacity_factor=worker.DROP_FACTOR))
    params = plan_worker.init_params(TModel(tcfg, device="cpu"))
    jp = jax.tree.map(jnp.asarray, convert.unflatten(
        plan_worker.numpy_tree(params)))
    jm = JModel(jcfg)
    loss = jax.jit(lambda p, b: jm.loss(p, b, remat=False))
    batch = worker.drop_batch(tcfg.vocab_size)

    def grouped(groups):
        parts = []
        for rows in groups:
            _, met = loss(jp, {k: jnp.asarray(v[rows])
                               for k, v in batch.items()})
            n = float((batch["labels"][rows, 1:] >= 0).sum())
            parts.append((float(met["ce"]) * n, float(met["zloss"]) * n,
                          float(met["aux"]), n))
        n = sum(p[3] for p in parts)
        ce, zl = sum(p[0] for p in parts) / n, sum(p[1] for p in parts) / n
        aux = sum(p[2] for p in parts) / len(parts)
        return {"loss": ce + 1e-4 * zl + aux, "ce": ce, "aux": aux,
                "tokens": n}

    m = worker.DROP_MICRO
    return {"whole": grouped(_rows(1)), "data": grouped(_rows(4)),
            "shard": grouped(_rows(2)), "pipeshard": grouped(_rows(m)),
            "own_rows": grouped(_own_rows(m))}


def test_the_groupings_drop_other_tokens(drop_reference):
    """In the reference, routing the drop batch whole or by shards of
    the flat plans (four of 2 rows, two of 4), and by pipeline
    microbatches of global rows or of each data rank's own rows, drops
    other tokens: each pair's ce differs by far more than the tolerance
    the worlds are held to."""
    r = drop_reference
    for a, b in (("whole", "data"), ("whole", "shard"), ("data", "shard"),
                 ("pipeshard", "own_rows")):
        assert abs(r[a]["ce"] - r[b]["ce"]) > \
            10 * LOSS_RTOL * abs(r[a]["ce"]), (a, b)


# ------------------------------------------------------------------ #
# refusals: the families the port does not have, and MLA under a plan

@pytest.mark.parametrize("arch,plan,item", [
    ("deepseek-v2-236b", "fsdp", "item 13"),
    ("whisper-small", "shard", "item 14"),
    ("whisper-small", "pipeshard", "item 14"),
    ("minicpm3-4b", "data", "item 13")])
def test_families_not_ported_raise_with_their_roadmap_item(arch, plan, item):
    """The encoder-decoder under any plan (item 14: it runs on one device
    only), and the MLA models under any plan (item 13: they run on one
    device only); the vision-language family runs under every plan (the
    worlds' "vlm" cases)."""
    with pytest.raises(NotImplementedError, match=item):
        build_train_step(TModel(tconfigs.get_config(arch).reduced(),
                                device="cpu"), TrainConfig(), plan=plan)


@pytest.mark.parametrize("family", ["mla", "encdec", "vlm"])
def test_model_of_another_family_raises_with_its_roadmap_item(family):
    """A family that is not one of the reference's raises ("mla" is an
    attention, not a family); the encoder-decoder and the
    vision-language family are ported: each builds on the CPU and runs a
    forward pass (their parity with the reference:
    ``test_torch_encdec.py``, ``test_torch_vlm.py``), the VLM's logits
    over its patches and the text."""
    rng = np.random.default_rng(0)
    if family in ("encdec", "vlm"):
        arch = "whisper-small" if family == "encdec" else "phi-3-vision-4.2b"
        cfg = tconfigs.get_config(arch).reduced()
        model = TModel(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        batch = {"tokens": rng.integers(4, cfg.vocab_size, (2, 8))}
        if family == "encdec":
            batch["frames"] = rng.standard_normal(
                (2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
        else:
            batch["patch_embeds"] = rng.standard_normal(
                (2, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
        logits = model.forward(params, batch)
        assert tuple(logits.shape) == (2, 8 + cfg.n_patches,
                                       cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        return
    cfg = dataclasses.replace(tconfigs.get_config("gpt2m").reduced(),
                              family=family)
    with pytest.raises(NotImplementedError,
                       match="not one of the reference's families"):
        TModel(cfg, device="cpu")


def test_donated_steps_repeat_the_bits(worlds):
    """``donate`` writes the same AdamW update into the params and the
    moments in place: two one-device steps of reduced gpt2m give the
    bits of the functional step, and return the given tensors."""
    rec = worlds[1]["donated"]
    assert rec["same_bits"] and rec["in_place"] == [False, True]


def test_every_plan_builds_for_every_family(worlds):
    built = worlds[1]["builds"]
    assert len(built) == 5 * len(tplans.PLANS)
    assert all(v is True for v in built.values()), \
        {k: v for k, v in built.items() if v is not True}


# ------------------------------------------------------------------ #
# numerics against the one-device port

FLAT_RUNS = [(w, name) for w in WORLDS for name in worker.CASES
             if worker.ONLY_ON.get(name, w) == w]


@pytest.mark.parametrize("world,name", FLAT_RUNS)
def test_plans_match_one_device(worlds, world, name):
    for plan, got in worlds[world]["flat"][name].items():
        _assert_matches(got, _ref(worlds, name, got),
                        f"world {world} {name} {plan}")


@pytest.mark.parametrize("name", [n for n in worker.CASES
                                  if n not in worker.ONLY_ON])
def test_world_of_one_is_bit_equal_to_one_device(worlds, name):
    """At a world of one every collective is a copy, and each cut
    computes the one-device operations on whole leaves (the Mamba2
    norm's mean square divided by one rank; every expert a rank's own),
    so every plan repeats the one-device bits."""
    for plan, got in worlds[1]["flat"][name].items():
        ref = _ref(worlds, name, got)
        assert got["losses"] == ref["losses"], plan
        for key, w in ref["params"].items():
            assert np.array_equal(got["params"][key], w), (plan, key)


@pytest.mark.parametrize("world", [2, 4])
def test_model_axis_describes_each_family(worlds, world):
    flat = worlds[world]["flat"]
    moe = flat["moe"]["shard"]["model_axis"]
    assert moe["experts"] and moe["heads"] and not moe["mlp"]
    falcon = flat["falcon"]["shard"]["model_axis"]
    assert falcon["d_inner"] and not falcon["heads"]
    assert dict(falcon["ssm_cut"])["in_proj"] == 1
    zamba = flat["zamba2"]["fsdp"]["model_axis"]
    assert zamba["d_inner"] and zamba["heads"] and zamba["mlp"]
    assert {"in_proj", "conv_w", "conv_b", "norm_scale",
            "out_proj"} == set(dict(zamba["ssm_cut"]))
    for plan in ("data", "zero2"):
        assert flat["moe"][plan]["model_axis"] is None
    vlm = flat["vlm"]["shard"]["model_axis"]
    assert vlm["heads"] and vlm["kv_heads"] and vlm["mlp"] and vlm["vocab"]
    assert not vlm["positions"] and not vlm["experts"]
    if world == 2:
        assert not flat["moe_e3"]["shard"]["model_axis"]["experts"]
        shared = flat["moe_shared"]["shard"]["model_axis"]
        assert shared["experts"] and shared["shared_experts"]
        nh3 = flat["zamba2_nh3"]["shard"]["model_axis"]
        assert not nh3["d_inner"] and dict(nh3["ssm_cut"])


@pytest.mark.parametrize("world", [2, 4])
def test_ssm_misaligned_leaves_give_the_sliced_gradients(worlds, world):
    """Under shard, rank 0's step-1 gradient block of each SSM leaf cut
    over the model axis (``in_proj`` [x | z] and [z | x | B | C | dt],
    the Mamba2 conv over [x | B | C], and the aligned ones) equals the
    first block of the one-device gradient."""
    seen = set()
    for name in ("falcon", "zamba2"):
        got = worlds[world]["flat"][name]["shard"]
        assert got["rank"] == 0
        ref = _ref(worlds, name, got)["grads"]
        top = max(np.abs(w).max() for w in ref.values())
        for key, (block, spec) in got["blocks"].items():
            dim = spec.index("model")
            want = ref[key]
            want = np.take(want, np.arange(want.shape[dim] // 2), axis=dim)
            scale = max(np.abs(want).max(), LEAF_FLOOR * top)
            assert np.abs(block - want).max() <= GRAD_RTOL * scale, key
            seen.add(key.rsplit("/", 1)[1])
    assert {"in_proj", "conv_w", "conv_b", "out_proj"} <= seen


PIPE_RUNS = [(w, name) for w in (2, 4) for name in worker.PIPE_CASES]


@pytest.mark.parametrize("world,name", PIPE_RUNS)
def test_pipeline_matches_one_device(worlds, world, name):
    """Both schedules against the one-device port (phi3.5-MoE's with
    ``grad_accum`` = m), and 1F1B bit-equal to GPipe."""
    runs = worlds[world]["pipe"][name]
    ref = worlds[1]["one_device"]["pipe"][name]
    for sched, got in runs.items():
        _assert_matches(got, ref, f"world {world} {name} {sched}")
        assert got["loss1"] == got["losses"][0]
    a, b = runs["gpipe"], runs["1f1b"]
    assert a["losses"] == b["losses"]
    for key, w in a["params"].items():
        assert np.array_equal(b["params"][key], w), key


# ------------------------------------------------------------------ #
# fsdp: blocks at rest, one layer gathered at a time

def test_fsdp_params_and_moments_are_the_blocks(worlds):
    """World 4 (data 2, model 2): every gpt2m leaf is cut over the data
    axes, so a rank holds 1/2 of a leaf shard leaves whole and 1/4 of one
    shard cuts on the model axis; its moments are the same blocks."""
    leaves = worlds[4]["fsdp"]["leaves"]
    held = whole = 0
    for key, (full, local, m, spec) in leaves.items():
        axes = spec_axes(spec)
        parts = 2 * (2 if "model" in axes else 1)
        assert "data" in axes, key
        assert np.prod(local) * parts == np.prod(full), key
        assert m == local, key
        held, whole = held + np.prod(local), whole + np.prod(full)
    assert held < whole / 2


def test_fsdp_gathers_one_layer_at_a_time(worlds):
    """One step of gpt2m under fsdp (remat), at two depths: each layer
    more adds two all-gathers (the forward, then remat's recompute) of
    that layer's leaves, whole over the data axes, and one reduce-scatter
    of their gradients; no gather spans the stack but that of a leaf the
    specs cut on its stack dim (``b_up``, whose other dim the model axis
    cuts), gathered whole once before the loop at any depth."""
    rec = worlds[4]["fsdp"]
    lo, hi = (rec["counts"][L] for L in worker.COUNT_LAYERS)
    dL = worker.COUNT_LAYERS[1] - worker.COUNT_LAYERS[0]
    # bytes of one layer's leaves, whole over the data axes (cut over
    # model as their specs say): gathered in the loop, or (the leaf cut on
    # its stack dim) with the whole stack, once
    per_layer = stacked = 0
    for key, (full, _, _, spec) in rec["leaves"].items():
        if not key.startswith("layers/"):
            continue
        model = 2 if "model" in spec_axes(spec) else 1
        layer = 4 * int(np.prod(full[1:])) // model
        if spec[0] is not None:
            stacked += layer
        else:
            per_layer += layer
    assert stacked and per_layer
    calls = {k: hi[k]["calls"] - lo[k]["calls"] for k in hi}
    nbytes = {k: hi[k]["bytes"] - lo[k]["bytes"] for k in hi}
    assert calls["all_gather"] == 2 * dL
    assert calls["reduce_scatter"] == dL
    assert nbytes["all_gather"] == (2 * per_layer + stacked) * dL
    assert nbytes["reduce_scatter"] == (per_layer + stacked) * dL


def test_fsdp_checkpoint_restores_onto_shard(worlds):
    """World 4 trained gpt2m two steps under fsdp and rank 0 wrote the
    gathered checkpoint; shard restored it and ran step 2.  The losses
    match a one-device ``train`` of three steps, and the checkpoint
    restores on one device."""
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import restore_checkpoint
    rec = worlds[4]["fsdp_ckpt"]
    np.testing.assert_allclose(rec["fsdp_losses"] + rec["shard_losses"],
                               worlds[1]["one_device"]["train"],
                               rtol=LOSS_RTOL)
    model = TModel(worker.case_config("gpt2m"), device="cpu")
    like = tree_map(torch.empty_like, plan_worker.init_params(model))
    path = os.path.join(rec["ckpt"], f"step_{worker.CKPT_STEPS:08d}")
    _, opt, step = restore_checkpoint(path, like, init_adamw(like))
    assert step == worker.CKPT_STEPS == int(opt.step)


# ------------------------------------------------------------------ #
# the worlds' MoE routing against the reference's

@pytest.mark.parametrize("plan", worker.DROP_PLANS)
def test_moe_flat_plans_route_each_shard_on_its_own(worlds, drop_reference,
                                                    plan):
    """World 4: data splits the batch over all four ranks, shard over
    the two data ranks; each rank routes its rows with its own capacity
    and the aux is the mean of the shards'."""
    got = worlds[4]["drops"][plan]
    assert len(got["batch_axes"]) == {"data": 3, "shard": 2}[plan]
    want = drop_reference[plan]
    for k in ("loss", "ce", "aux"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k


def test_moe_pipeshard_routes_each_global_microbatch(worlds,
                                                     drop_reference):
    """World 4, two stages over a data axis of two, m = 4: microbatch i
    is the global rows [i B/m, (i+1) B/m), routed as one across the
    data ranks (each holds one of its rows), and the aux is the sum
    over the stages and microbatches over m; the metrics count the
    batch's tokens once."""
    got = worlds[4]["drops"]["pipeshard"]
    want = drop_reference["pipeshard"]
    for k in ("loss", "ce", "aux"):
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    assert got["tokens"] == want["tokens"]


@pytest.mark.parametrize("plan", worker.DRY_PLANS)
def test_dry_run_counts_the_collectives_of_a_gloo_world(request, plan):
    """The dry run's collectives of every rank, traced on meta tensors
    while the worlds run, against the world of 4's counts of one
    step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = worker.dry_config()
    shape = ShapeConfig("gloo", plan_worker.SEQ, plan_worker.BATCH, "train")
    mesh = worker.PIPE[4] if plan == "pipeshard" else worker.FLAT[4]
    rec = dryrun.run_one(cfg, shape, plan, mesh_shape=mesh,
                         ranks=range(4), verbose=False,
                         tcfg=worker.train_config(microbatches=worker.MICRO))
    assert rec["status"] == "ok" and rec["use_kernels"]
    real = request.getfixturevalue("worlds")[4]["dry_counts"][plan]
    for rank in range(4):
        assert rec["ranks"][str(rank)]["collectives"] == real[rank], rank
    assert any(v["calls"] for v in real[0].values())
