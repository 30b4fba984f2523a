"""The port's pipeline plan (``core/pipeline.py``, ``core/steps.py
:PipelineStep``) against the reference's tables and searched splits, the
one-device port and the JAX reference's unsharded loss.

* Tables: the copied ``schedule_tables``, ``stage_gather_index``,
  ``validate_stages`` and ``pipeline_mesh`` give the reference's outputs
  bit for bit, errors included; the port's timeline runs the tables'
  forwards and one backward of every (chunk, microbatch), after its own
  forward and its successor's backward, and under 1F1B never holds more
  than ``S - s`` microbatches on stage s.
* Searched splits: the port's ``PlanSearch`` gives the reference's
  (the asserts of ``test_pipeline_uneven.py`` and
  ``test_pipeline_schedules.py``).
* Numerics: gloo worlds of 2, 3 and 4 ranks, one spawn each
  (``tests/torch_pipeline_worker.py``), run reduced gpt2m in fp32 at
  seq 16 with ragged positions under GPipe, 1F1B and interleaved:
  losses over 3 steps within 1e-5 relative of the one-device port; the
  step-1 loss within 1e-5 relative of the JAX reference's unsharded
  ``Model.loss``; step-1 gradients leaf by leaf within 1e-5 of the
  leaf's largest value (``LEAF_FLOOR`` and the key-bias rule of
  ``test_torch_plans.py``); 1F1B bit-equal to GPipe at the same split,
  interleaved in its step-1 loss and gradients (its chunks put other
  layers on a stage, so AdamW's norm adds the stages' squares in
  another grouping); explicit even splits bit-equal to the default;
  sends a step ``2 m (S v - 1)``; a pipeshard checkpoint restored on one
  device; the launcher under ``torch.distributed.run`` and
  ``launch.pipeline_check`` on two ranks.
"""
from __future__ import annotations

import json
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
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.core.sharding import _path_str  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.convert import flatten  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core.steps import build_train_step  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_pipeline_worker as worker  # noqa: E402
import torch_plan_worker as plan_worker  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
LEAF_FLOOR = 1e-3
ZERO_LEAF, ZERO_LEAVES = 1e-6, ("layers/attn/bk",)
SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2),
             ("interleaved3", 3))
LAUNCHER = ["torch.distributed.run", "--nproc_per_node", "2",
            "--standalone", "-m", "repro_torch.launch.train", "--arch",
            "gpt2m", "--reduced", "--device", "cpu", "--plan", "pipeshard",
            "--mesh", "2,1,1", "--schedule", "1f1b", "--microbatches", "2",
            "--steps", "2", "--seq", "32", "--batch", "4", "--docs", "60"]
PIPELINE_CHECK = ["repro_torch.launch.pipeline_check", "--device", "cpu",
                  "--gpus", "A30,T4", "--layers", "6",
                  "--schedules", "gpipe,1f1b"]
REF_KEYS = ("stage_layers", "splits", "ref_loss", "losses", "ref_gnorm",
            "gnorms", "ref_aux", "auxes")


# ------------------------------------------------------------------ #
# the worlds and the two entry points, started at once in the
# background; the table tests run meanwhile

@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("pipeline")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for world in worker.SCENARIOS:
        d = root / f"world{world}"
        d.mkdir()
        procs[world] = (d / "out.pt", subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_pipeline_worker.py"),
             str(d / "out.pt"), str(world)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, argv in (("torchrun", LAUNCHER),
                       ("pipeline_check", PIPELINE_CHECK)):
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
def jax_losses():
    """Each scenario's batch and weights (the port's init, converted)
    through the JAX reference's unsharded ``Model.loss``, computed while
    the worlds run."""
    import dataclasses
    out = {}
    for scs in worker.SCENARIOS.values():
        for name, sc in scs.items():
            layers = sc["layers"]
            cfg = worker.config(layers)
            jcfg = dataclasses.replace(jconfigs.get_config("gpt2m").reduced(),
                                       dtype="float32", n_layers=layers)
            params = plan_worker.init_params(TModel(cfg, device="cpu"))
            jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
            batch = worker.make_batch(cfg.vocab_size, sc["batch"])
            loss, _ = jax.jit(JModel(jcfg).loss)(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            out[name] = float(loss)
    return out


@pytest.fixture(scope="module")
def worlds(_started, jax_losses):
    out = {}
    for world in worker.SCENARIOS:
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


RUNS = [(world, sc, run) for world, scs in worker.SCENARIOS.items()
        for sc, spec in scs.items()
        for run in (f"{split}@{sched}" for sched, split in spec["runs"])]


# ------------------------------------------------------------------ #
# the copied tables, bit for bit

def _same_tables(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("sched,v", SCHEDULES)
def test_schedule_tables_equal_reference(sched, v, S):
    for m in range(1, 9):
        _same_tables(tpipe.schedule_tables(sched, S, m),
                     jpipe.schedule_tables(sched, S, m))
        for s in range(S):
            for k in range(v):
                assert tpipe.banked_slot(s, k, S, v) == \
                    jpipe.banked_slot(s, k, S, v)


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(*args, **kw), None
    except (ValueError, KeyError) as e:
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("S,v", [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2),
                                 (2, 3), (4, 2)])
def test_stage_gather_index_equals_reference(S, v):
    rng = np.random.default_rng(S * 10 + v)
    splits = [tuple(rng.integers(1, 5, S * v)) for _ in range(6)]
    splits += [(1,) * (S * v + 1), (2,) * max(S * v - 1, 1)]
    for split in splits:
        got, gerr = _outcome(tpipe.stage_gather_index, split, S, v)
        want, werr = _outcome(jpipe.stage_gather_index, split, S, v)
        assert gerr == werr, split
        if want is None:
            continue
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), split
        # the port's stage rows: the gather index, padded slots dropped
        rows = np.concatenate([tpipe.stage_rows(split, S, v, s)
                               for s in range(S)])
        assert np.array_equal(rows, want[0][want[1]])
        assert sorted(rows.tolist()) == list(range(sum(split)))


def test_validate_stages_equals_reference():
    cfg = tconfigs.get_config("gpt2m").reduced()
    cases = [(6, 2, None, "gpipe"), (7, 2, None, "1f1b"),
             (6, 2, (4, 2), "1f1b"), (6, 2, (4, 1), "gpipe"),
             (6, 2, (4, 2, 0), "gpipe"), (6, 2, (6, 0), "gpipe"),
             (8, 2, None, "interleaved"), (6, 2, None, "interleaved"),
             (6, 2, (2, 1, 2, 1), "interleaved"), (9, 3, (5, 2, 2), "1f1b"),
             (9, 1, None, "interleaved3"), (7, 3, (3, 3, 1), "gpipe")]
    for L, S, split, sched in cases:
        stack = {"w": np.zeros((L, 2))}
        got = _outcome(tpipe.validate_stages, cfg, stack, S, split,
                       schedule=sched)
        want = _outcome(jpipe.validate_stages, cfg, stack, S, split,
                        schedule=sched)
        assert got == want, (L, S, split, sched)


@pytest.mark.parametrize("shape,n_stages,order", [
    ((2, 2, 2), 2, (1, 0)), ((2, 2, 2), 4, None), ((4, 1, 1), 4,
                                                   (2, 0, 3, 1)),
    ((1, 4, 2), 2, None), ((3, 2, 1), 3, (2, 1, 0)), ((2, 2, 1), 3, None),
    ((2, 1, 2), 2, (0, 0))])
def test_pipeline_mesh_equals_reference(shape, n_stages, order):
    """The port reshapes a grid of ranks as the reference reshapes its
    devices (here a mesh of integers)."""
    from jax.sharding import Mesh
    axes = ("pod", "data", "model")
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    got = _outcome(tpipe.pipeline_mesh, grid, axes, n_stages,
                   stage_order=order)
    want = _outcome(lambda: np.asarray(jpipe.pipeline_mesh(
        Mesh(grid, axes), n_stages, stage_order=order).devices))
    assert got[1] == want[1]
    if want[0] is not None:
        assert np.array_equal(got[0], want[0])


# ------------------------------------------------------------------ #
# the port's timeline: backward slots

def _slots(timeline, s):
    return [(t, a) for t, row in enumerate(timeline) for a in [row[s]] if a]


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("sched,v", SCHEDULES)
def test_timeline_runs_the_tables_and_one_backward_each(sched, v, S):
    for m in range(1, 9):
        tl = tpipe.pipeline_timeline(sched, S, m)
        tables = jpipe.schedule_tables(sched, S, m)
        act, chunk, mb = tables["active"], tables["chunk"], tables["mb"]
        done = {}
        for s in range(S):
            slots = _slots(tl, s)
            assert [(k, i) for _, (a, k, i) in slots if a == "F"] == [
                (int(chunk[s, t]), int(mb[s, t]))
                for t in range(act.shape[1]) if act[s, t]], (m, s)
            for t, (a, k, i) in slots:
                assert (a, k * S + s, i) not in done, (m, s, a, k, i)
                done[(a, k * S + s, i)] = t
            in_flight = held = 0
            for _, (a, _, _) in slots:
                held += 1 if a == "F" else -1
                in_flight = max(in_flight, held)
            if sched == "1f1b":
                assert in_flight <= S - s, (m, s, in_flight)
            if sched == "gpipe":
                kinds = "".join(a for _, (a, _, _) in slots)
                assert kinds == "F" * m + "B" * m
        last = S * v - 1
        assert len(done) == 2 * S * v * m
        for (a, c, i), t in done.items():
            if a == "F" and c > 0:
                assert done[("F", c - 1, i)] < t
            if a == "B":
                assert done[("F", c, i)] < t
                if c < last:
                    assert done[("B", c + 1, i)] < t


def test_1f1b_alternates_after_its_warm_up():
    S, m = 4, 8
    tl = tpipe.pipeline_timeline("1f1b", S, m)
    for s in range(S):
        kinds = "".join(a for _, (a, _, _) in _slots(tl, s))
        w = S - s
        assert kinds == "F" * w + "BF" * (m - w) + "B" * w, (s, kinds)


# ------------------------------------------------------------------ #
# searched splits, the reference's asserts

@pytest.mark.parametrize("gpus,layers,micro,batch,sched,want", [
    ("A30,T4", 6, 4, 8, "gpipe", [4, 2]),
    ("A30,A30,T4", 7, 4, 8, "gpipe", [3, 3, 1]),
    ("A30,T4,T4", 9, 3, 6, "gpipe", [5, 2, 2]),
    ("A30,T4,T4", 6, 3, 6, "1f1b", [3, 2, 1]),
])
def test_searched_splits_equal_reference(gpus, layers, micro, batch, sched,
                                         want):
    from repro.core.costmodel import Workload as JWorkload
    from repro.core.search import PlanSearch as JSearch
    from repro.core.topology import Link as JLink, Site as JSite, line
    got = worker.searched_placement(gpus, layers, micro, batch, sched)
    assert list(got.stage_layers) == want
    names = gpus.split(",")
    topo = line("hetline", [JSite((g,), name=f"S{i}")
                            for i, g in enumerate(names)],
                [JLink(20e-3, 3.0)] * (len(names) - 1))
    jcfg = jconfigs.get_config("gpt2m").reduced()
    import dataclasses
    search = JSearch(JWorkload(dataclasses.replace(jcfg, n_layers=layers),
                               worker.SEQ, batch, steps_per_epoch=1,
                               microbatches=micro), topo,
                     stage_balance="tflops", schedules=(sched,))
    cand = next(c for c in search.candidates()
                if c.technique == "pipeshard"
                and c.sites == tuple(range(len(names)))
                and c.stage_order == tuple(range(len(names)))
                and c.schedule == sched)
    want_p = search.placement(cand)
    assert (want_p.sites, want_p.stage_order, want_p.stage_layers,
            want_p.schedule) == (got.sites, got.stage_order,
                                 got.stage_layers, got.schedule)


# ------------------------------------------------------------------ #
# specs on staged meshes, refusals

def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {_path_str(path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("arch", ["gpt2m", "llama3.2-3b", "gpt2L"])
def test_staged_specs_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if arch != "gpt2L":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jshapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0)))
    tshapes = TModel(tcfg, device="cpu").init(torch.Generator(),
                                              device="meta")
    jp, tp = jplans.PLANS["pipeshard"], tplans.PLANS["pipeshard"]
    for shape in ((2, 1, 2), (4, 1, 1), (3, 2, 1), (2, 2, 2)):
        axes = tpipe.STAGED_AXES
        jm, tm = jplans.MeshSpec.of(shape, axes), \
            tplans.MeshSpec.of(shape, axes)
        assert flatten(tp.param_specs(tshapes, tcfg, tm)) == \
            _ref_specs(jp.param_specs(jshapes, jcfg, jm)), shape
        assert flatten(tp.opt_specs(tshapes, tcfg, tm)) == \
            _ref_specs(jp.opt_specs(jshapes, jcfg, jm)), shape


@pytest.mark.parametrize("arch,item", [
    ("deepseek-v2-236b", "item 10"), ("whisper-small", "item 10")])
def test_pipeshard_refuses_with_its_roadmap_item(arch, item):
    """pipeshard runs every family the port has (the MoE, SSM and hybrid
    ones in ``test_torch_plan_families.py``); the families it does not
    have raise."""
    with pytest.raises(NotImplementedError, match=item):
        build_train_step(TModel(tconfigs.get_config(arch).reduced(),
                                device="cpu"), TrainConfig(),
                         plan="pipeshard")


# ------------------------------------------------------------------ #
# numerics

def _assert_leaf_stats(stats, what):
    top = max(w for _, w, _ in stats.values())
    for key, (err, w, g) in stats.items():
        if key in ZERO_LEAVES:
            assert max(w, g) <= ZERO_LEAF * top, f"{what} {key}"
            continue
        scale = max(w, LEAF_FLOOR * top)
        assert err <= GRAD_RTOL * scale, f"{what} {key}: {err} > " \
            f"{GRAD_RTOL} x {scale}"


@pytest.mark.parametrize("world,sc,run", RUNS)
def test_pipeline_matches_one_device(worlds, world, sc, run):
    rec = worlds[world]["scenarios"][sc]
    got, ref = rec["runs"][run], rec["one_device"]
    what = f"world {world} {sc} {run}"
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=LOSS_RTOL, err_msg=what)
    _assert_leaf_stats(got["grad_stats"], what)
    assert got["loss1"] == got["losses"][0], what


@pytest.mark.parametrize("world,sc", [(w, sc) for w, scs in
                                      worker.SCENARIOS.items()
                                      for sc in scs])
def test_step1_loss_matches_jax_reference(jax_losses, worlds, world, sc):
    rec = worlds[world]["scenarios"][sc]
    for k, v in worker.make_batch(worker.config(rec["layers"]).vocab_size,
                                  len(rec["batch"]["tokens"])).items():
        assert np.array_equal(rec["batch"][k], v), k
    for run, got in rec["runs"].items():
        assert got["loss1"] == pytest.approx(jax_losses[sc],
                                             rel=LOSS_RTOL), (sc, run)


@pytest.mark.parametrize("world,sc,run", [r for r in RUNS
                                          if not r[2].endswith("@gpipe")])
def test_schedules_are_bit_equal_to_gpipe(worlds, world, sc, run):
    runs = worlds[world]["scenarios"][sc]["runs"]
    got = runs[run]
    split = run.split("@")[0]
    if got["virt"] == 1:
        want = runs[f"{split}@gpipe"]
        assert got["split"] == want["split"]
        assert got["losses"] == want["losses"]
        assert got["param_digests"] == want["param_digests"]
    else:
        want = runs[next(r for r in runs if r.endswith("@gpipe"))]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    assert got["loss1"] == want["loss1"]
    assert got["grad_digests"] == want["grad_digests"]


@pytest.mark.parametrize("world,sc", [(2, "A30,T4")])
def test_even_split_is_bit_equal_to_the_default(worlds, world, sc):
    runs = worlds[world]["scenarios"][sc]["runs"]
    even, legacy = runs["even@gpipe"], runs["legacy@gpipe"]
    assert legacy["split"] is None and len(set(even["split"])) == 1
    for key in ("losses", "grad_digests", "param_digests"):
        assert even[key] == legacy[key], key


@pytest.mark.parametrize("world,sc,run", RUNS)
def test_sends_a_step(worlds, world, sc, run):
    """Each chunk boundary hands m activations forward and m gradients
    back, over the stage ranks of one (data, model) place."""
    got = worlds[world]["scenarios"][sc]["runs"][run]
    m = worker.SCENARIOS[world][sc]["micro"]
    S, v = got["n_stages"], got["virt"]
    assert got["sends_a_step"] == 2 * m * (S * v - 1)


@pytest.mark.parametrize("world,sc,run", [r for r in RUNS
                                          if r[2].endswith("@1f1b")])
def test_1f1b_holds_at_most_S_minus_s_microbatches(worlds, world, sc, run):
    got = worlds[world]["scenarios"][sc]["runs"][run]
    m = worker.SCENARIOS[world][sc]["micro"]
    S = got["n_stages"]
    assert got["peak_in_flight"] == [min(S - s, m) for s in range(S)]
    gpipe = worlds[world]["scenarios"][sc]["runs"][
        run.replace("@1f1b", "@gpipe")]
    assert gpipe["peak_in_flight"] == [m] * S


def test_pipeshard_checkpoint_restores_on_one_device(worlds):
    """The world of 2 trained 2 steps under pipeshard (1F1B, the searched
    split) and rank 0 wrote the gathered checkpoint; one device restores
    it, and its step 2 matches a one-device run of 3 steps."""
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import restore_checkpoint, train
    cfg = worker.config(worker.SCENARIOS[2]["A30,T4"]["layers"])
    tcfg = plan_worker.train_config()
    model = TModel(cfg, device="cpu")
    like = tree_map(torch.empty_like, plan_worker.init_params(model))
    path = os.path.join(worlds[2]["ckpt"], f"step_{worker.CKPT_STEPS:08d}")
    params, opt, step = restore_checkpoint(path, like, init_adamw(like))
    assert step == worker.CKPT_STEPS == int(opt.step)
    loader = plan_worker.make_loader(cfg.vocab_size)
    whole = train(model, tcfg, loader, steps=3, log_every=0)
    again = train(model, tcfg, loader, steps=3, params=params,
                  opt_state=opt, start_step=worker.CKPT_STEPS, log_every=0)
    assert again.losses[0] == pytest.approx(whole.losses[2], rel=LOSS_RTOL)
    assert plan_worker.param_norm(again.params) == pytest.approx(
        plan_worker.param_norm(whole.params), rel=1e-6)


# ------------------------------------------------------------------ #
# entry points

def test_launcher_trains_pipeshard_under_torchrun_on_gloo(_started):
    out = _finished(_started, "torchrun")
    assert out.count("done: loss") == 1, out
    assert "'stage': 2" in out, out


def test_pipeline_check_prints_the_reference_keys(_started):
    res = json.loads(_finished(_started, "pipeline_check").strip()
                     .splitlines()[-1])
    assert tuple(res) == REF_KEYS
    assert res["stage_layers"] == [4, 2]
    assert res["splits"]["searched@1f1b"] == [4, 2]
    for key, loss in res["losses"].items():
        assert loss == pytest.approx(res["ref_loss"], rel=LOSS_RTOL), key
        assert loss == res["losses"]["searched"], key
        assert res["gnorms"][key] == pytest.approx(res["ref_gnorm"],
                                                   rel=1e-4), key
