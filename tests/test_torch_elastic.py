"""The port's elasticity (``train/reshard.py``, ``train/replan.py``,
``launch/replan.py``, ``launch/reshard_check.py``) against the JAX
reference.

* Host functions: ``stage_view``, ``unstage_view``, ``restage`` and
  ``normalized_stage_layers`` give the reference's arrays bit for bit
  on the same numpy stacks (the five splits of ``test_reshard.py``,
  interleaved included; the 7-layer restage and its round trip; a
  hypothesis round trip), and its error messages; the pipeline's local
  rows (``core.pipeline.stage_rows``) are ``stage_view``'s valid rows.
* Replan: on the topologies of ``test_replan.py``, and on the chip's
  two-site topologies at gpt2m's and gpt2L's full size, the port's
  ``ReplanResult`` is the reference's (technique, placement, sites,
  topology, TFLOP/s exactly); its refusals too.
* Worlds of 2 and 3 gloo ranks (``tests/torch_elastic_worker.py``,
  reduced gpt2m in fp32): the four place scenarios of
  ``test_reshard.py`` bit-exact against ``reshard_state`` and the
  destination step's own cut, gathered back to the checkpoint, and one
  further step equal to the control; a reduced whisper-small state and
  a reduced deepseek-v2 state
  resharded from shard to pipeshard and back, bit-exact, the encoder's
  stack on the first stage only; the chaos drill (site V2 killed at
  step 3) with the reference's technique, the state bit-exact, the
  resumed losses equal to the control, and the dead rank out at exit 0
  having written nothing.
* Launchers: the chaos demo under ``torch.distributed.run`` on two gloo
  ranks, then the recovery mode at a world of one
  (``test_replan.py``'s asserts); the port's recovery mode against the
  reference's, each on a copy of a checkpoint directory the reference's
  launcher wrote: technique, sites and step equal, the final loss
  within ``TRAIN_RTOL`` (bf16 on both).
"""
from __future__ import annotations

import ast
import importlib
import json
import os
import shlex
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from prophelpers import given, settings, st  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.launch import replan as jlaunch  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.launch import replan as tlaunch  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402

jreshard = importlib.import_module("repro.train.reshard")
jreplan = importlib.import_module("repro.train.replan")
treshard = importlib.import_module("repro_torch.train.reshard")
treplan = importlib.import_module("repro_torch.train.replan")

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = Path(HERE).parent
sys.path.insert(0, HERE)
import torch_elastic_worker as worker  # noqa: E402

TRAIN_RTOL = 1e-4          # tests/test_torch_train_io.py's
SPLITS = [((2, 2), 2, "gpipe"), ((3, 1), 2, "gpipe"),
          ((3, 3, 1), 3, "gpipe"), ((5, 2, 2), 3, "1f1b"),
          ((1, 1, 2, 2), 2, "interleaved")]
LAUNCH = ["--gpus", "A30;A30", "--kind", "full", "--dead", "1", "--arch",
          "gpt2m", "--reduced", "--seq", "16", "--batch", "4", "--docs",
          "60", "--vocab", "256", "--ckpt-every", "2"]


# ------------------------------------------------------------------ #
# the worlds and the launchers, started at once in the background

def _chain(*stages) -> str:
    """A shell line running stages one after another, stopping at a
    failure; a stage is a list of ``(argv, out, err)`` run together."""
    def cmd(argv, out, err):
        return (f"{shlex.join(argv)} >{shlex.quote(str(out))} "
                f"2>{shlex.quote(str(err))}")

    def stage(cmds):
        if len(cmds) == 1:
            return cmd(*cmds[0])
        runs = "; ".join(f"{cmd(*c)} & p{i}=$!" for i, c in enumerate(cmds))
        waits = " && ".join(f"wait $p{i}" for i in range(len(cmds)))
        return f"{{ {runs}; {waits}; }}"

    return " && ".join(stage(s) for s in stages)


@pytest.fixture(scope="module")
def _started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("elastic")
    env = dict(subproc_env, OMP_NUM_THREADS="1", TMPDIR=str(root))
    py = sys.executable
    procs = {}
    for world in worker.SCENARIOS:
        procs[world] = subprocess.Popen(
            [py, os.path.join(HERE, "torch_elastic_worker.py"),
             str(root / f"world{world}"), str(world)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the port's chaos demo on two ranks, then its recovery on one
    ck = root / "launch"
    port = [py, "-m", "repro_torch.launch.replan", "--ckpt-dir", str(ck),
            "--device", "cpu"] + LAUNCH
    procs["launcher"] = subprocess.Popen(["bash", "-c", _chain(
        [([py, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2"] + port[1:]
          + ["--steps", "5", "--kill-step", "3", "--plan", "pipeshard"],
          root / "chaos.out", root / "chaos.err")],
        [(port + ["--steps", "8"], root / "rec.out", root / "rec.err")])],
        env=env, cwd=root)
    # the reference's chaos demo writes a checkpoint directory; both
    # recovery modes resume a copy of it
    ref = [py, "-m", "repro.launch.replan", "--devices", "2"] + LAUNCH
    src, a, b = root / "ref", root / "ref_port", root / "ref_ref"
    procs["cross"] = subprocess.Popen(["bash", "-c", _chain(
        [(ref + ["--ckpt-dir", str(src), "--steps", "3", "--kill-step", "1",
                 "--plan", "data"], root / "refchaos.out",
          root / "refchaos.err")],
        [(["cp", "-r", str(src), str(d)], root / f"cp{i}.out",
          root / f"cp{i}.err") for i, d in enumerate((a, b))],
        [(port[:4] + [str(a)] + port[5:] + ["--steps", "5"],
          root / "xport.out", root / "xport.err"),
         (ref + ["--ckpt-dir", str(b), "--steps", "5"], root / "xref.out",
          root / "xref.err")])], env=env, cwd=root)
    yield root, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_early(_started):
    """Start the worlds before the first test of the module."""


@pytest.fixture(scope="module")
def worlds(_started):
    root, procs = _started
    out = {}
    for world in worker.SCENARIOS:
        log, _ = procs[world].communicate(timeout=300)
        assert procs[world].returncode == 0, log[-4000:]
        out[world] = [torch.load(f"{root / f'world{world}'}.{r}",
                                 weights_only=False) for r in range(world)]
    return out


def _last_json(path):
    lines = [l for l in Path(path).read_text().splitlines()
             if l.startswith("{")]
    assert lines, Path(path).read_text()[-3000:]
    return json.loads(lines[-1])


def _chain_done(started, name, *errs):
    root, procs = started
    procs[name].wait(timeout=300)
    assert procs[name].returncode == 0, "\n".join(
        (root / e).read_text()[-3000:] for e in errs if (root / e).exists())
    return root


# ------------------------------------------------------------------ #
# host functions, against the reference

def _stack(n_layers, extra_shape=(3,), seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n_layers,) + extra_shape).astype(
                np.float32),
            "b": rng.standard_normal((n_layers, 2)).astype(np.float32)}


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def _outcome(fn, *args, **kw):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(*args, **kw), None
    except (ValueError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("split,n_stages,schedule", SPLITS)
def test_stage_views_equal_reference(split, n_stages, schedule):
    stack = _stack(sum(split))
    got, gvalid = treshard.stage_view(stack, split, n_stages, schedule)
    want, wvalid = jreshard.stage_view(stack, split, n_stages, schedule)
    _same(got, want)
    assert gvalid.dtype == wvalid.dtype and np.array_equal(gvalid, wvalid)
    # torch tensors in, the same values out
    tgot, _ = treshard.stage_view({k: torch.from_numpy(v)
                                   for k, v in stack.items()},
                                  split, n_stages, schedule)
    _same(tgot, want)
    back = treshard.unstage_view(got, split, n_stages, schedule)
    _same(back, jreshard.unstage_view(want, split, n_stages, schedule))
    _same(back, stack)


def test_stage_view_pads_by_repeating_last_layer():
    stack = _stack(3)
    staged, valid = treshard.stage_view(stack, (2, 1), 2)
    assert staged["w"].shape[0] == 4
    np.testing.assert_array_equal(staged["w"][3], stack["w"][2])
    np.testing.assert_array_equal(valid, [True, True, True, False])


def test_restage_equals_reference_and_round_trips():
    stack = _stack(7)
    src, _ = treshard.stage_view(stack, (4, 3), 2)
    dst, valid = treshard.restage(src, (4, 3), 2, (3, 3, 1), 3)
    jdst, jvalid = jreshard.restage(src, (4, 3), 2, (3, 3, 1), 3)
    _same(dst, jdst)
    np.testing.assert_array_equal(valid, jvalid)
    ref, _ = treshard.stage_view(stack, (3, 3, 1), 3)
    _same(dst, ref)
    back, _ = treshard.restage(dst, (3, 3, 1), 3, (4, 3), 2)
    _same(back, src)


def test_unstage_and_normalize_refuse_as_reference():
    staged, _ = treshard.stage_view(_stack(4), (2, 2), 2)
    for args in (((3, 3), 2), ((2, 2, 2), 2)):
        got = _outcome(treshard.unstage_view, staged, *args)
        want = _outcome(jreshard.unstage_view, staged, *args)
        assert got[1] is not None and got[1] == want[1], args
    cases = [(6, dict(sites=(0, 1))),
             (7, dict(sites=(0, 1, 2), stage_layers=(3, 3, 1))),
             (8, dict(sites=(0, 1), schedule="interleaved")),
             (7, dict(sites=(0, 1, 2)))]
    for n, kw in cases:
        got = _outcome(treshard.normalized_stage_layers, n,
                       tplans.Placement(**kw))
        want = _outcome(jreshard.normalized_stage_layers, n,
                        jplans.Placement(**kw))
        assert got == want, (n, kw)
    assert treshard.normalized_stage_layers(
        8, tplans.Placement((0, 1), schedule="interleaved")) == (2,) * 4


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_stage_roundtrip_property_equals_reference(data):
    n_stages = data.draw(st.integers(1, 4), label="n_stages")
    virt = data.draw(st.integers(1, 2), label="virt")
    split = tuple(data.draw(
        st.lists(st.integers(1, 4), min_size=n_stages * virt,
                 max_size=n_stages * virt), label="split"))
    schedule = "gpipe" if virt == 1 else f"interleaved{virt}"
    stack = _stack(sum(split), extra_shape=tuple(data.draw(
        st.lists(st.integers(1, 3), max_size=2), label="extra")),
        seed=data.draw(st.integers(0, 99), label="seed"))
    staged, valid = treshard.stage_view(stack, split, n_stages, schedule)
    jstaged, jvalid = jreshard.stage_view(stack, split, n_stages, schedule)
    _same(staged, jstaged)
    np.testing.assert_array_equal(valid, jvalid)
    assert int(valid.sum()) == sum(split)
    _same(treshard.unstage_view(staged, split, n_stages, schedule), stack)


@pytest.mark.parametrize("split,n_stages,schedule", SPLITS)
def test_stage_rows_are_stage_view_valid_rows(split, n_stages, schedule):
    """Reduced gpt2m's stack at each split: a stage's rows in the
    pipeline's local layout (``stage_rows``, what ``PipelineStep`` and
    ``plan_state_layout`` cut) are its valid rows of ``stage_view``."""
    import dataclasses
    cfg = dataclasses.replace(tget_config("gpt2m").reduced(),
                              dtype="float32", n_layers=sum(split))
    layers = TModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))["layers"]
    _, virt = tcost.parse_schedule(schedule)
    staged, valid = treshard.stage_view(layers, split, n_stages, schedule)
    per = virt * max(split)
    for s in range(n_stages):
        rows = torch.as_tensor(tpipe.stage_rows(split, n_stages, virt, s),
                               dtype=torch.long)
        sl = slice(s * per, (s + 1) * per)
        for path, leaf in _flat(layers).items():
            want = _flat(staged)[path][sl][torch.as_tensor(valid[sl])]
            assert torch.equal(leaf.index_select(0, rows), want), (s, path)


def _flat(tree):
    from repro_torch.train.checkpoint import flatten
    return flatten(tree)


def test_state_templates_and_hybrid_split_on_its_groups():
    """Templates carry the model's shapes on ``meta``; a hybrid's split
    partitions its groups (the stack), where the reference's
    ``normalized_stage_layers`` is handed ``cfg.n_layers``."""
    cfg = tget_config("zamba2-2.7b").reduced()
    import dataclasses
    cfg = dataclasses.replace(cfg, n_layers=8)
    model = TModel(cfg, device="cpu")
    p_like, o_like = treshard.state_templates(model)
    real = model.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(p_like).items()} == \
        {k: tuple(v.shape) for k, v in _flat(real).items()}
    assert all(t.device.type == "meta" for t in _flat(o_like).values())
    groups = tpipe.stack_length(cfg, p_like["layers"])
    assert groups == 4 and cfg.n_layers == 8
    split = treshard.check_pipeline_placement(
        cfg, p_like, tplans.Placement((0, 1), stage_layers=(3, 1)))
    assert split == (3, 1)
    with pytest.raises(ValueError, match="partition"):
        treshard.check_pipeline_placement(
            cfg, p_like, tplans.Placement((0, 1), stage_layers=(5, 3)))
    with pytest.raises(ValueError, match="Placement"):
        treshard.check_pipeline_placement(cfg, p_like, None)


# ------------------------------------------------------------------ #
# the survivor search, against the reference

def _sites(pkg, n, gpu="A30"):
    return [pkg.Site((gpu, gpu), name=f"S{i}") for i in range(n)]


def _topologies(pkg):
    link = pkg.Link(20e-3, 3.0)
    return {
        "ring3": (pkg.ring("r3", _sites(pkg, 3), [link] * 3), (1,)),
        "line3_middle": (pkg.line("l3", _sites(pkg, 3), [link] * 2), (1,)),
        "het_line": (pkg.line("het", [pkg.Site(("A30", "A30")),
                                      pkg.Site(("A30", "A30")),
                                      pkg.Site(("T4", "T4"))], [link] * 2),
                     (1,)),
        "full2": (pkg.fully_connected("f2", _sites(pkg, 2), link), (1,)),
    }


def _same_replan(got, want):
    assert got.technique == want.technique
    assert got.placement.sites == want.placement.sites
    assert got.placement.stage_order == want.placement.stage_order
    assert got.placement.stage_layers == want.placement.stage_layers
    assert got.placement.schedule == want.placement.schedule
    assert got.sites_old == want.sites_old
    assert got.dead_sites == want.dead_sites
    assert got.topology.name == want.topology.name
    assert got.topology.describe() == want.topology.describe()
    assert got.tflops == want.tflops


@pytest.mark.parametrize("name", ["ring3", "line3_middle", "het_line",
                                  "full2"])
def test_replan_equals_reference(name):
    ttop, dead = _topologies(ttopo)[name]
    jtop, _ = _topologies(jtopo)[name]
    got = treplan.replan(ttop, dead, tcost.paper_workload(
        tget_config("gpt2m")))
    want = jreplan.replan(jtop, dead, jcost.paper_workload(
        jget_config("gpt2m")))
    _same_replan(got, want)
    assert got.search_s >= 0
    if name == "line3_middle":
        assert len(got.placement.sites) == 1 and \
            got.technique != "pipeshard"
    if name == "het_line":
        assert got.sites_old == (0,)


@pytest.mark.parametrize("arch", ["gpt2m", "gpt2L"])
@pytest.mark.parametrize("gpus", ["A30;A30", "A30,A30;A30,A30"])
def test_replan_at_the_chips_full_size(arch, gpus):
    """The chip's recovery phases: 8 x 1024, V2 dead; the survivor
    search picks ``data`` on V1 in both packages."""
    got = treplan.replan(tlaunch.build_cli_topology("full", gpus, 20.2, 3.0),
                         (1,), tcost.Workload(tget_config(arch), 1024, 8,
                                              steps_per_epoch=4,
                                              microbatches=4))
    want = jreplan.replan(jlaunch.build_cli_topology("full", gpus, 20.2,
                                                     3.0),
                          (1,), jcost.Workload(jget_config(arch), 1024, 8,
                                               steps_per_epoch=4,
                                               microbatches=4))
    _same_replan(got, want)
    assert got.technique == "data" and got.sites_old == (0,)


def test_replan_refuses_as_reference():
    """Nothing dead, everything dead, and a model that fits nowhere
    (phi3.5-MoE on two-A30 sites: the reference's test takes
    llama3-405b, which the port does not have)."""
    ttop, _ = _topologies(ttopo)["ring3"]
    jtop, _ = _topologies(jtopo)["ring3"]
    for dead, arch in (((), "gpt2m"), ((0, 1, 2), "gpt2m"),
                       ((1,), "phi3.5-moe-42b-a6.6b")):
        got = _outcome(treplan.replan, ttop, dead,
                       tcost.paper_workload(tget_config(arch)))
        want = _outcome(jreplan.replan, jtop, dead,
                        jcost.paper_workload(jget_config(arch)))
        assert got[1] is not None and got[1] == want[1], (dead, arch)
    assert "memory" in got[1][1]


def test_kill_site_at_fires_only_at_its_step():
    hook = treplan.kill_site_at(3, (1,))
    for i in (0, 1, 2, 4):
        hook(i)
    with pytest.raises(treplan.SiteFailure) as e:
        hook(3)
    assert e.value.step == 3 and e.value.dead_sites == (1,)
    assert str(e.value) == str(jreplan.SiteFailure(3, (1,)))


def test_site_blocks_follow_site_order():
    topo = ttopo.fully_connected("f", _sites(ttopo, 3), ttopo.Link(20e-3,
                                                                   3.0))
    blocks = treplan.site_device_blocks(topo, list(range(6)))
    assert blocks == jreplan.site_device_blocks(
        jtopo.fully_connected("f", _sites(jtopo, 3), jtopo.Link(20e-3, 3.0)),
        list(range(6))) == [(0, 1), (2, 3), (4, 5)]
    assert treplan.placement_devices(blocks, (2, 0)) == [4, 5, 0, 1]
    with pytest.raises(ValueError, match="devices"):
        treplan.site_device_blocks(topo, list(range(5)))
    # a job relaunched on the survivors: their ranks in site order
    assert tlaunch.relaunch_blocks(topo, (1,), list(range(4))) == \
        [(0, 1), (), (2, 3)]


def test_cli_parsing_equals_reference():
    assert tlaunch.parse_gpus("A30,A30;T4") == \
        jlaunch.parse_gpus("A30,A30;T4") == [("A30", "A30"), ("T4",)]
    with pytest.raises(ValueError, match="empty"):
        tlaunch.parse_gpus(" ; ")
    for kind, gpus in (("line", "A30;A30;T4"), ("full", "A30;T4"),
                       ("ring", "A30,A30;T4;T4"), ("hub", "A30;T4;T4")):
        got = tlaunch.build_cli_topology(kind, gpus, 20.0, 3.0)
        want = jlaunch.build_cli_topology(kind, gpus, 20.0, 3.0)
        assert got.describe() == want.describe()
    t = tlaunch.build_cli_topology("line", "A30;A30;T4", 20.0, 3.0)
    assert t.n_sites == 3 and (0, 2) not in t.links
    with pytest.raises(ValueError, match="unknown"):
        tlaunch.build_cli_topology("mesh", "A30;A30", 20.0, 3.0)


# ------------------------------------------------------------------ #
# the checkpoint reader the reshard restores through

def _npz_as(kind, path):
    """A one-member shard ``np.savez`` never writes here, or a truncated
    one."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    if kind == "compressed":
        np.savez_compressed(path, w=a)
    elif kind == "fortran":
        np.savez(path, w=np.asfortranarray(a))
    elif kind == "objects":
        np.savez(path, w=np.array([{"a": 1}], dtype=object))
    else:
        np.savez(path, w=a)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 40)


@pytest.mark.parametrize("kind,match", [
    ("compressed", "compressed"), ("fortran", "Fortran"),
    ("objects", "objects"), ("truncated", "truncated|corrupt|zip")])
def test_checkpoint_reader_refuses_what_savez_does_not_write(
        tmp_path, kind, match):
    """``read_flat`` reads each member straight into its array and has no
    second path: a member it cannot read so raises."""
    from repro_torch.train.checkpoint import read_flat
    path = tmp_path / "params_00.npz"
    _npz_as(kind, path)
    with pytest.raises((ValueError, zipfile.BadZipFile), match=match):
        read_flat(str(tmp_path), {"files": {"params": [path.name]}},
                  "params")


def test_checkpoint_reader_equals_np_load(tmp_path):
    """Every dtype and shape ``save_checkpoint`` writes (fp32 leaves of
    any rank, the int32 step, an empty leaf, a zip64 header) reads back
    as ``np.load`` reads it."""
    from repro_torch.train.checkpoint import read_flat
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((5, 3, 2)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32),
              "step": np.asarray(11, np.int32),
              "empty": np.zeros((0, 4), np.float32)}
    np.savez(tmp_path / "opt_00.npz", **arrays)
    with zipfile.ZipFile(tmp_path / "opt_01.npz", "w") as z:
        with z.open("big.npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, arrays["w"])
    got = read_flat(str(tmp_path), {"files": {"opt": ["opt_00.npz",
                                                      "opt_01.npz"]}}, "opt")
    assert sorted(got) == sorted(list(arrays) + ["big"])
    for key, arr in dict(arrays, big=arrays["w"]).items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape
        assert np.array_equal(got[key], arr), key


def test_checkpoint_io_timing_script_reports_every_way(tmp_path):
    """``launch/checkpoint_io.py`` at the reduced size: every way timed,
    ``read_flat`` held to ``np.load`` on the checkpoint it times."""
    from repro_torch.launch import checkpoint_io
    report = checkpoint_io.measure(
        checkpoint_io.parse(["--reduced", "--repeats", "1"]), str(tmp_path))
    assert set(report["median_s"]) == {
        "write_serial", "write_threads", "verify_serial", "verify_threads",
        "read_np_load_serial", "read_np_load_threads", "read_flat"}
    assert report["gb"] > 0 and all(
        len(v) == 1 and v[0] > 0 for v in report["seconds"].values())


def test_elastic_modules_import_neither_jax_nor_repro():
    for rel in ("train/reshard.py", "train/replan.py", "launch/replan.py",
                "launch/reshard_check.py", "launch/checkpoint_io.py"):
        tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
        roots = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"jax", "jaxlib", "repro", "flax"}, rel


# ------------------------------------------------------------------ #
# the worlds

# scenario -> the fewest leaves each destination rank holds a block of
SPLIT_ACROSS = {"data_to_fsdp2": 3, "pipe_to_zero2": 2}
PLACE = [name for scs in worker.SCENARIOS.values() for name, _ in scs
         if not name.startswith("chaos")]


@pytest.mark.parametrize("name", PLACE)
def test_reshard_place_scenario(worlds, name):
    world = next(w for w, scs in worker.SCENARIOS.items()
                 if name in dict(scs))
    res = worlds[world][0]["reports"][name]
    assert res["params_bitexact"] and res["opt_bitexact"], res
    assert res["layout_bitexact"], res
    assert res["host_bitexact"], res
    assert res["max_param_diff"] == 0.0 and res["max_opt_diff"] == 0.0
    assert res["step"] == 2 and len(res["src_losses"]) == 2
    # one further step from the resharded state == the control
    assert res["loss_resharded"] == res["loss_control"], res
    assert all(np.isfinite(res["loss_control"]))
    if name == "stage_order_reversal":
        assert res["loss_src_continue"] == res["loss_control"]
    if name in SPLIT_ACROSS:
        # every destination rank holds blocks of leaves cut over both
        # ranks: fsdp its params and moments, zero2 its moments
        assert res["dst_ranks"] == 2
        assert all(n >= SPLIT_ACROSS[name] for n in res["split_leaves"])


def test_whisper_reshards_shard_to_pipeshard_and_back(worlds):
    """The world of 2 reshards a reduced whisper-small state (params and
    AdamW moments) from a checkpoint onto shard (a model axis of 2),
    onto pipeshard (2 stages) and onto shard again, each leg's
    checkpoint written from the last leg's gathered state
    (``worker.whisper_reshard``): every leg bit-exact against
    ``reshard_state`` and against the step's own cut, and gathered back
    to the checkpoint it came from; shard cuts the encoder's heads as the
    decoder's; the first stage holds the encoder's stack whole and the
    second none of it; the round trip gives the first leg's blocks."""
    for rank, res in enumerate(worlds[2]):
        rep = res["reports"]["whisper"]
        legs = rep["legs"]
        assert [leg["plan"] for leg in legs] == ["shard", "pipeshard",
                                                 "shard"]
        for leg in legs:
            for key in ("params_bitexact", "opt_bitexact",
                        "layout_bitexact", "gathered_bitexact"):
                assert leg[key], (rank, key, leg)
        assert legs[2]["round_trip_bitexact"], rank
        H, L, E = rep["heads"], rep["n_layers"], rep["n_enc"]
        assert legs[0]["encoder_wq"][0] == E
        assert legs[0]["encoder_wq"][2] == legs[0]["decoder_wq"][2] == H // 2
        assert legs[1]["encoder_wq"][0] == (E if rank == 0 else 0), rank
        assert legs[1]["decoder_wq"][0] == L // 2


def test_dsv2_reshards_shard_to_pipeshard_and_back(worlds):
    """The world of 2 takes a reduced deepseek-v2 state (MLA and the MoE
    family, 4 layers) through the same legs
    (``worker.dsv2_reshard``): every leg bit-exact against
    ``reshard_state`` and the step's own cut, gathered back to its
    checkpoint, and the round trip gives the first leg's blocks; shard
    cuts MLA's heads (``w_uq``) and the experts and keeps the latent's
    down-projection whole, pipeshard holds a stage's layers of each."""
    for rank, res in enumerate(worlds[2]):
        rep = res["reports"]["dsv2"]
        legs = rep["legs"]
        assert [leg["plan"] for leg in legs] == ["shard", "pipeshard",
                                                 "shard"]
        for leg in legs:
            for key in ("params_bitexact", "opt_bitexact",
                        "layout_bitexact", "gathered_bitexact"):
                assert leg[key], (rank, key, leg)
        assert legs[2]["round_trip_bitexact"], rank
        H, L, E = rep["heads"], rep["n_layers"], rep["experts"]
        uq, dkv, up = (legs[0]["shapes"][k] for k in worker.DSV2_LEAVES)
        assert (uq[0], uq[2], dkv[0], up[0], up[1]) == (L, H // 2, L, L,
                                                        E // 2), rank
        uq, dkv, up = (legs[1]["shapes"][k] for k in worker.DSV2_LEAVES)
        assert (uq[0], uq[2], dkv[0], up[0], up[1]) == (L // 2, H, L // 2,
                                                        L // 2, E), rank


def _chaos_workload():
    """The drill's workload in the reference's terms: reduced gpt2m, 4
    layers, fp32, the worker's vocabulary, seq 16, batch 8, m = 4."""
    import dataclasses

    from repro_torch.data import Tokenizer, synthetic_wikipedia
    vocab = Tokenizer.train(list(synthetic_wikipedia(60, seed=0)),
                            256).vocab_size
    cfg = dataclasses.replace(jget_config("gpt2m").reduced(), n_layers=4,
                              vocab_size=vocab, dtype="float32")
    return jcost.Workload(cfg, 16, 8, steps_per_epoch=6, microbatches=4)


@pytest.mark.parametrize("world,name", [(2, "chaos"), (3, "chaos_spare")])
def test_chaos_drill(worlds, world, name):
    """Site V2 of a two-site pipeshard run killed at step 3; in the world
    of three, rank 2 is on no site and only meets the fault hook."""
    ranks = worlds[world]
    res = ranks[0]["reports"][name]
    topo = jtopo.line("elastic-line", [jtopo.Site(("A30",), name=f"V{i + 1}")
                                       for i in range(2)],
                      [jtopo.Link(20e-3, 3.0)])
    want = jreplan.replan(topo, (1,), _chaos_workload())
    assert res["failed"] and res["technique"] == want.technique
    assert res["sites_old"] == [0] == list(want.sites_old)
    assert res["resumed_from"] == 2 and res["steps_lost"] == 1
    assert res["params_bitexact"] and res["opt_bitexact"], res
    assert res["max_param_diff"] == 0.0 and res["max_opt_diff"] == 0.0
    assert len(res["losses_pre"]) == 3 and len(res["losses_post"]) == 4
    assert res["losses_post"] == res["losses_control"]
    assert all(np.isfinite(res["losses_post"]))
    # the survivor wrote the step-0, step-2 and post-recovery saves; the
    # dead rank (and the spare) left after the replan, wrote nothing, and
    # exited 0
    assert [s for n, s in ranks[0]["writes"] if n == name] == [0, 2, 4, 6]
    for rank in ranks[1:]:
        run = rank["runs"][name]
        assert run["failed"] and run["left"], rank["rank"]
        assert run["losses_pre"] == (res["losses_pre"] if rank["rank"] == 1
                                     else [])
        assert [s for n, s in rank["writes"] if n == name] == []
        assert rank["reports"][name] is None
    assert ranks[1]["writes"] == []


# ------------------------------------------------------------------ #
# the launchers

def test_launcher_chaos_then_recovery(_started):
    root = _chain_done(_started, "launcher", "chaos.err", "rec.err")
    chaos = _last_json(root / "chaos.out")
    assert chaos["mode"] == "chaos" and chaos["failed"]
    assert chaos["technique"] == "data" and chaos["sites_old"] == [0]
    assert chaos["resumed_from"] == 2 and chaos["steps_lost"] == 1
    assert chaos["final_loss"] is not None
    assert (root / "chaos.out").read_text().count('"mode"') == 1
    rec = _last_json(root / "rec.out")
    assert rec["mode"] == "recovery" and rec["sites_old"] == [0]
    assert rec["resumed_from"] == 5
    assert rec["final_loss"] is not None and len(rec["step_s"]) == 3


def test_recovery_equals_reference_on_its_checkpoint(_started):
    root = _chain_done(_started, "cross", "refchaos.err", "xport.err",
                       "xref.err")
    got, want = _last_json(root / "xport.out"), _last_json(root / "xref.out")
    assert got["mode"] == want["mode"] == "recovery"
    assert got["technique"] == want["technique"]
    assert got["sites_old"] == want["sites_old"] == [0]
    assert got["resumed_from"] == want["resumed_from"] == 3
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=TRAIN_RTOL)
