"""The port's launch tooling against the JAX reference's, on the CPU.

* ``launch/analytic.py``: ``analytic_cost`` gives the reference's floats
  for every architecture and input shape at several (dp, tp, zero_deg,
  remat, window); ``placement_degrees`` and ``plan_degrees`` equal the
  reference's over the paper's topologies and every plan.
* ``models/registry.py``: ``input_specs`` gives the reference's shapes and
  dtypes as meta tensors (no storage), and its values from the same numpy
  seed.
* ``launch/roofline.py``: each term by hand at the H100's constants, both
  sides of 80 GB, the reference's keys less the two raw HLO fields.
* ``launch/collective_trace.py``: the reference's pod-crossing cases as
  rank groups; the dict layout of ``collective_bytes``.
* The kernels' meta rules (``kernels/ops.py``): each wrapper's output, and
  kernel A's saved tensors, have the shapes and dtypes of the plain
  version's on the CPU, and no kernel is launched; kernel 5 has none.
* ``launch/dryrun.py``: a reduced gpt2m step's peak on the meta device
  equals its peak on real CPU tensors; three full-size dry runs through
  the command line (gpt2m x train_4k x shard_zero on 16 x 16, llama3.2-3b
  x decode_32k x shard on 2 x 16 x 16, and whisper-small x decode_32k,
  which is not ported under the plans), started before the first test.

The dry run's collective counts against a real gloo world of 4 are in
``tests/test_torch_plan_families.py`` (its world-4 spawn).
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

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import plans as jplans  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch.hlo_parse import _groups_cross_pod  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import plans as tplans  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import analytic as tanalytic  # noqa: E402
from repro_torch.launch import collective_trace as ctrace  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

ARCHS = sorted(jconfigs.ARCH_CONFIGS)
SHAPES = sorted(jconfigs.INPUT_SHAPES)
# (dp, tp, zero_deg, remat, window)
DEGREES = ((1, 1, 1, True, 0), (16, 16, 16, True, 0), (32, 16, 32, False, 0),
           (8, 4, 2, True, 4096), (256, 1, 256, False, 1024))


# ------------------------------------------------------------------ #
# the full-size dry runs, through the command line, started at once

FULL_RUNS = {
    "gpt2m-train_4k-shard_zero": ["--arch", "gpt2m", "--shape", "train_4k"],
    "llama3.2-3b-decode_32k-multi_pod": ["--arch", "llama3.2-3b", "--shape",
                                         "decode_32k", "--multi-pod"],
    "whisper-small-decode_32k": ["--arch", "whisper-small", "--shape",
                                 "decode_32k"],
}


@pytest.fixture(scope="module")
def _full_started(tmp_path_factory, subproc_env):
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(subproc_env, OMP_NUM_THREADS="1")
    procs = {}
    for name, args in FULL_RUNS.items():
        out = root / f"{name}.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--json-out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_early(_full_started):
    """Start the command-line runs before the first test of the module."""


@pytest.fixture(scope="module")
def full_runs(_full_started):
    out = {}
    for name, (path, proc) in _full_started.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log[-4000:]
        last = json.loads(log.strip().splitlines()[-1])
        with open(path) as f:
            out[name] = (last, json.load(f))
    return out


# ------------------------------------------------------------------ #
# analytic cost and degrees

@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS
                                        for s in SHAPES])
def test_analytic_cost_equals_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape, tshape = jconfigs.get_shape(shape), tconfigs.get_shape(shape)
    assert dataclasses.asdict(jshape) == dataclasses.asdict(tshape)
    for dp, tp, zdeg, remat, window in DEGREES:
        kw = dict(n_devices=256, dp=dp, tp=tp, zero_deg=zdeg, remat=remat,
                  window=window)
        want = janalytic.analytic_cost(jcfg, jshape, **kw)
        got = tanalytic.analytic_cost(tcfg, tshape, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw


def test_input_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in
            tconfigs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown input shape"):
        tconfigs.get_shape("train_8k")


def _placements(topo):
    sites = range(len(topo.sites))
    return [(s,) for s in sites] + [tuple(sites)]


@pytest.mark.parametrize("cluster", sorted(jcost.PAPER_TOPOLOGIES))
def test_placement_degrees_equal_reference(cluster):
    jtopo, ttopo = jcost.PAPER_TOPOLOGIES[cluster], \
        tcost.PAPER_TOPOLOGIES[cluster]
    n = 0
    for name in jplans.PLANS:
        for sites in _placements(jtopo):
            for model in (1, 2):
                for batch in (32, 8, 3):
                    want = janalytic.placement_degrees(
                        jplans.get_plan(name), jtopo,
                        jplans.Placement(sites), batch, model=model)
                    got = tanalytic.placement_degrees(
                        tplans.get_plan(name), ttopo,
                        tplans.Placement(sites), batch, model=model)
                    assert got == want, (name, sites, model, batch)
                    n += 1
    assert n == len(jplans.PLANS) * 3 * 2 * 3


MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 2, 2), ("pod", "data", "model")),
          ((2, 8, 16), ("stage", "data", "model")))


@pytest.mark.parametrize("plan", sorted(jplans.PLANS))
def test_plan_degrees_equal_reference(plan):
    for shape, axes in MESHES:
        for batch in (256, 128, 32, 1):
            want = janalytic.plan_degrees(
                jplans.get_plan(plan), jplans.MeshSpec.of(shape, axes), batch)
            got = tanalytic.plan_degrees(
                tplans.get_plan(plan), tplans.MeshSpec.of(shape, axes), batch)
            assert got == want, (shape, batch)


# ------------------------------------------------------------------ #
# input specs

_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
       jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference_as_meta_tensors(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape in SHAPES:
        want = jregistry.input_specs(jcfg, jconfigs.get_shape(shape))
        got = tregistry.input_specs(tcfg, tconfigs.get_shape(shape))
        assert set(got) == set(want), shape
        for k, t in got.items():
            assert t.is_meta, (shape, k)
            assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
            assert t.dtype == _DT[want[k].dtype.type], (shape, k)


SMALL = (tconfigs.ShapeConfig("t", 32, 2, "train"),
         tconfigs.ShapeConfig("p", 24, 3, "prefill"),
         tconfigs.ShapeConfig("d", 32, 4, "decode"))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_values_equal_reference(arch):
    """Concrete batches of the reduced config from one numpy seed: the
    reference's values, bit for bit (floats compared in fp32)."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    for small in SMALL:
        jshape = jconfigs.ShapeConfig(**dataclasses.asdict(small))
        want = jregistry.input_specs(jcfg, jshape, abstract=False,
                                     rng=np.random.default_rng(7))
        got = tregistry.input_specs(tcfg, small, abstract=False,
                                    rng=np.random.default_rng(7),
                                    device="cpu")
        assert set(got) == set(want)
        for k, t in got.items():
            w = np.asarray(want[k].astype(jnp.float32)) \
                if t.is_floating_point() else np.asarray(want[k])
            g = t.float().numpy() if t.is_floating_point() else t.numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), (small, k)


def test_abstractify_keeps_shapes_and_dtypes_without_storage():
    from repro_torch.optim import init_adamw
    params = {"a": torch.ones((3, 4)),
              "b": {"c": torch.zeros(5, dtype=torch.int8)}}
    tree = tregistry.abstractify({"p": params, "opt": init_adamw(params),
                                  "n": 3})
    assert tree["n"] == 3
    assert tree["opt"].m["b"]["c"].dtype == torch.float32
    assert tree["p"]["b"]["c"].dtype == torch.int8
    assert tree["p"]["a"].is_meta and tuple(tree["p"]["a"].shape) == (3, 4)
    assert type(tree["opt"]).__name__ == "AdamWState"
    model = tregistry.build_model("gpt2m", device="meta")
    assert model.use_kernels and model.device.type == "meta"


def test_production_meshes_lie_over_a_fake_world():
    """The reference's production meshes over a fake world the process
    joins; over another world (a real one, or another size) they
    refuse."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_production_mesh(rank=17)
        assert tmesh.in_fake_world() and dist.get_world_size() == 256
        assert mesh.shape == {"data": 16, "model": 16}
        assert mesh.coord == {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="fake world of 512"):
            tmesh.make_production_mesh(multi_pod=True)
        dist.destroy_process_group()
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        with pytest.raises(RuntimeError, match="dry run's"):
            tmesh.make_production_mesh()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ #
# roofline

def _roofline(mem=1e9, dcn=0.0):
    return troofline.Roofline(
        arch="gpt2m", shape="train_4k", mesh="16x16", plan="shard",
        flops_total=2.0e15, hbm_bytes_per_device=6.7e9,
        collective_bytes_per_device=9.0e8,
        collective_breakdown={"all_reduce": 9.0e8},
        dcn_bytes_per_device=dcn, model_flops=1.0e15, n_devices=256,
        memory_per_device_bytes=mem)


def test_roofline_terms_by_hand():
    r = _roofline(dcn=3.0e7)
    assert r.compute_s == 2.0e15 / (256 * 989e12)
    assert r.memory_s == 6.7e9 / 3.35e12
    assert r.collective_s == 9.0e8 / 450e9 + 3.0e7 / 3.0e9
    assert r.collective_s > r.compute_s > r.memory_s
    assert r.dominant == "collective"
    assert r.useful_flops_fraction == 0.5
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW,
            tmesh.HBM_BYTES, tmesh.WAN_BW) == (989e12, 3.35e12, 450e9, 80e9,
                                               3.0e9)
    assert _roofline(dcn=0.0).dominant == "compute"


@pytest.mark.parametrize("mem,fits", [(80e9, True), (80e9 + 1, False)])
def test_fits_hbm_at_80_gb(mem, fits):
    assert _roofline(mem=mem).fits_hbm is fits
    assert _roofline(mem=mem).to_dict()["fits_hbm"] is fits


def test_roofline_keys_are_the_references_less_hlo_fields():
    want = jroofline.Roofline(
        arch="a", shape="s", mesh="m", plan="p", flops_total=1.0,
        hbm_bytes_per_device=1.0, collective_bytes_per_device=1.0,
        collective_breakdown={}, dcn_bytes_per_device=0.0, model_flops=1.0,
        n_devices=1, memory_per_device_bytes=1.0, hlo_flops_raw=0.0,
        hlo_bytes_raw=0.0).to_dict()
    got = _roofline().to_dict()
    assert set(got) == (set(want) - {"hlo_flops_raw", "hlo_bytes_raw"}) \
        | {"wan_bw"}


def test_from_dry_run_splits_site_crossing_bytes():
    R = ctrace.CollectiveRecord
    records = [R("all_reduce", 100, (0, 1)), R("all_reduce", 40, (0, 256)),
               R("send", 8, (0, 256)), R("all_gather", 16, tuple(range(16)))]
    cost = tanalytic.AnalyticCost(flops_total=1.0, hbm_bytes_per_device=2.0,
                                  model_flops=0.5)
    r = troofline.from_dry_run(records, cost, 5.0, arch="a", shape="s",
                               mesh_name="2x16x16", plan="shard",
                               n_devices=512, pods=2)
    assert r.crosses_pod and r.dcn_bytes_per_device == 48.0
    assert r.collective_bytes_per_device == 116.0
    assert r.collective_breakdown["crossing"]["all_reduce"] == 40.0
    one = troofline.from_dry_run(records, cost, 5.0, arch="a", shape="s",
                                 mesh_name="16x16", plan="shard",
                                 n_devices=256)
    assert one.dcn_bytes_per_device == 0.0 and not one.crosses_pod
    assert one.collective_bytes_per_device == 164.0


# ------------------------------------------------------------------ #
# site crossing: the reference's three cases as rank groups

def _iota_groups(g, n, dims, perm=None):
    ids = np.arange(int(np.prod(dims))).reshape(dims)
    if perm:
        ids = ids.transpose(perm)
    return ids.reshape(g, n).tolist()


CROSS_CASES = {
    # [32,16]<=[512]: consecutive groups of 16 never cross a 256 boundary
    "iota_within": ("replica_groups=[32,16]<=[512]", 256,
                    _iota_groups(32, 16, [512])),
    # [256,2]<=[2,16,16]T(2,1,0): pairs (i, i+256) always cross
    "iota_crossing": ("replica_groups=[256,2]<=[2,16,16]T(2,1,0)", 256,
                      _iota_groups(256, 2, [2, 16, 16], (2, 1, 0))),
    "explicit": (None, 2, None),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_crosses_sites_matches_reference_cases(case):
    line, pod, groups = CROSS_CASES[case]
    if line is not None:
        want = _groups_cross_pod(f"x = f32[4] all-reduce(%y), {line}", pod)
        got = any(ctrace.crosses_sites(g, pod) for g in groups)
        assert got == want == (case == "iota_crossing")
        assert all(ctrace.crosses_sites(g, pod) == want for g in groups)
        return
    for text, ranks, want in (
            ("replica_groups={{0,1},{2,3}}", ((0, 1), (2, 3)), False),
            ("replica_groups={{0,2}}", ((0, 2),), True),
            ("replica_groups={{0,1}}", ((0, 1),), False),
            ("source_target_pairs={{0,3},{3,0}}", ((0, 3), (3, 0)), True),
            ("source_target_pairs={{0,1},{1,0}}", ((0, 1), (1, 0)), False)):
        assert _groups_cross_pod(text, pod_size=pod) == want
        assert any(ctrace.crosses_sites(r, pod) for r in ranks) == want
    assert not ctrace.crosses_sites((0, 300), 0)


def test_collective_bytes_has_the_references_layout():
    R = ctrace.CollectiveRecord
    out = ctrace.collective_bytes(
        [R("all_reduce", 10, (0, 1)), R("all_reduce", 5, (1, 2)),
         R("reduce_scatter", 7, (0, 2)), R("recv", 3, (2, 0))], pod_size=2)
    assert out["all_reduce"] == 10.0 and out["reduce_scatter"] == 0.0
    assert out["_crossing"]["all_reduce"] == 5.0
    assert out["_crossing"]["reduce_scatter"] == 7.0
    assert out["_crossing"]["recv"] == 3.0
    assert out["_calls"] == {"all_reduce": 2, "reduce_scatter": 1,
                             "all_gather": 0, "broadcast": 0, "send": 0,
                             "recv": 1}


# ------------------------------------------------------------------ #
# the kernels' meta rules

def _both(shape_dtypes, fill=None):
    """The same shapes as seeded CPU tensors and as meta tensors."""
    g = torch.Generator().manual_seed(0)
    cpu = []
    for shape, dt in shape_dtypes:
        if dt == torch.int8:
            cpu.append(torch.randint(-127, 128, shape, generator=g,
                                     dtype=torch.int8))
        elif dt == torch.bool:
            cpu.append(torch.ones(shape, dtype=torch.bool))
        else:
            cpu.append((torch.rand(shape, generator=g) * 0.5 + 0.1).to(dt))
    return cpu, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for t in cpu]


def _sig(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype)
    return tuple(_sig(o) for o in out)


BF = torch.bfloat16
F32 = torch.float32
META_CASES = {
    "flash_fwd": (lambda q, k, v: tops.flash_attention(q, k, v),
                  [((2, 32, 4, 64), BF), ((2, 32, 2, 64), BF),
                   ((2, 32, 2, 64), BF)]),
    "flash_fwd_window": (lambda q, k, v: tops.flash_attention(q, k, v,
                                                              window=8),
                         [((1, 24, 2, 80), BF)] * 3),
    "flash_fwd_split": (lambda q, k, v: tops.flash_attention(q, k, v),
                        [((1, 16, 4, 96), BF), ((1, 16, 4, 96), BF),
                         ((1, 16, 4, 64), BF)]),
    "flash_fwd_noncausal": (lambda q, k, v: tops.flash_attention(
        q, k, v, causal=False), [((2, 8, 2, 64), BF), ((2, 40, 2, 64), BF),
                                 ((2, 40, 2, 64), BF)]),
    "int8kv": (lambda q, kq, ks, vq, vs, valid: tops.flash_attention_int8kv(
        q, kq, ks, vq, vs, valid),
        [((3, 1, 8, 128), BF), ((3, 96, 2, 128), torch.int8),
         ((3, 96, 2), F32), ((3, 96, 2, 128), torch.int8),
         ((3, 96, 2), F32), ((3, 96), torch.bool)]),
    "int8kv_lse": (lambda q, kq, ks, vq, vs, valid:
                   tops.flash_attention_int8kv(q, kq, ks, vq, vs, valid,
                                               with_lse=True),
                   [((2, 1, 4, 64), BF), ((2, 1100, 4, 64), torch.int8),
                    ((2, 1100, 4), F32), ((2, 1100, 4, 64), torch.int8),
                    ((2, 1100, 4), F32), ((2, 1100), torch.bool)]),
    "ssd_scan": (lambda x, dt, b, c, a, h0: tops.ssd_scan(x, dt, b, c, -a, h0,
                                                          chunk=16),
                 [((2, 20, 2, 64), F32), ((2, 20, 2), F32),
                  ((2, 20, 64), F32), ((2, 20, 64), F32), ((2,), F32),
                  ((2, 2, 64, 64), F32)]),
    "mamba1_scan": (lambda x, dt, b, c, a, h0: tops.mamba1_scan(
        x, dt, b, c, -a, h0), [((2, 12, 32), F32), ((2, 12, 32), F32),
                               ((2, 12, 16), F32), ((2, 12, 16), F32),
                               ((32, 16), F32), ((2, 32, 16), F32)]),
    "rmsnorm_bf16": (lambda x, w: tops.rmsnorm(x, w),
                     [((3, 5, 256), BF), ((256,), F32)]),
    "rmsnorm_fp32": (lambda x, w: tops.rmsnorm(x, w, eps=1e-6),
                     [((7, 3072), F32), ((3072,), F32)]),
}


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_meta_rule_gives_the_plain_versions_shapes(case):
    fn, shapes = META_CASES[case]
    cpu, meta = _both(shapes)
    tops.reset_launch_counts()
    want, got = fn(*cpu), fn(*meta)
    assert _sig(got) == _sig(want)
    for t in (got,) if isinstance(got, torch.Tensor) else got:
        assert t.is_meta
    assert not any(tops.launch_counts().values())


@pytest.mark.parametrize("causal", [True, False])
def test_meta_rule_saves_what_training_saves(causal):
    """Kernel A's training forward on meta keeps what the card keeps:
    q, k, v, the output (fp32 where not causal) and the fp32 logsumexp,
    the plain version's shapes and dtypes on the CPU; its backward gives
    the gradients' shapes and dtypes."""
    cpu, meta = _both([((2, 16, 4, 64), BF), ((2, 16, 2, 64), BF),
                       ((2, 16, 2, 64), BF)])
    sigs = {}
    for name, qkv in (("cpu", cpu), ("meta", meta)):
        q, k, v = (t.requires_grad_(True) for t in qkv)
        out = tops.flash_attention(q, k, v, causal=causal)
        saved = [_sig(t) for t in out.grad_fn.saved_tensors]
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        sigs[name] = (_sig(out), saved, [_sig(g) for g in grads])
        assert all(g.device.type == name for g in grads)
    assert sigs["meta"] == sigs["cpu"]
    kept = sigs["meta"][1][3]
    assert kept[1] == (BF if causal else F32)
    assert sigs["meta"][1][4] == ((2, 4, 16), F32)


def test_meta_rules_check_what_the_card_checks():
    """The meta rule refuses what the kernel refuses: fp32 operands of
    kernel A, head dims it was not built for, and a gradient through
    its backward at 128; kernel 5, calibration's only, has no rule."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        tops.flash_attention(q, q, q)
    q = torch.empty((1, 8, 2, 48), dtype=BF, device="meta")
    with pytest.raises(ValueError, match="built for"):
        tops.flash_attention(q, q, q)
    q = torch.empty((1, 8, 2, 128), dtype=BF, device="meta",
                    requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        tops.flash_attention(q, q, q)
    x = torch.empty((4, 32, 16), device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.rmsnorm(x, torch.empty(16, device="meta"))
    with pytest.raises(NotImplementedError, match="calibration only"):
        tops.int8_matmul(torch.empty((32, 32), device="meta"),
                         torch.empty((32, 32), device="meta"), block_m=32,
                         block_k=32, block_n=32)


def test_kernel_b_meta_rule_plans_the_h100s_splits():
    """At a cache the planner splits on the H100's 132 SMs, the meta rule
    allocates the splits' partials as the card does."""
    from repro_torch.kernels import _build, quantized
    assert _build.sm_count(torch.device("meta")) == 132
    splits, _ = quantized.int8kv_splits(2, 4, 1100, 132)
    assert splits > 1
    seen = []

    from torch.utils._python_dispatch import TorchDispatchMode

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.empty.memory_format:
                seen.append((tuple(out.shape), out.dtype))
            return out

    _, meta = _both(META_CASES["int8kv_lse"][1])
    with Spy():
        META_CASES["int8kv_lse"][0](*meta)
    assert ((2, 4, splits, 2), F32) in seen
    assert ((2, 4, splits, 64), F32) in seen


# ------------------------------------------------------------------ #
# the dry run

@pytest.mark.parametrize("use_kernels", [False, True])
def test_meta_peak_equals_cpu_peak(use_kernels):
    """One training step of reduced gpt2m (bf16, one device) under
    ``MemTracker``: the peak on meta tensors equals the peak on real CPU
    tensors, category by category."""
    from repro_torch.core.steps import build_train_step
    from repro_torch.optim import init_adamw
    cfg = tconfigs.get_config("gpt2m").reduced()
    shape = tconfigs.ShapeConfig("t", 32, 4, "train")
    peaks = {}
    for dev in ("meta", "cpu"):
        model = tregistry.build_model(cfg, use_kernels=use_kernels,
                                      device=dev)
        params = model.init(torch.Generator(), device=dev)
        batch = tregistry.input_specs(
            cfg, shape, abstract=dev == "meta",
            rng=np.random.default_rng(0), device="cpu")
        step = build_train_step(model, tconfigs.TrainConfig())
        peaks[dev] = dryrun.trace(step, (params, init_adamw(params), batch))
    assert peaks["meta"]["split"] == peaks["cpu"]["split"]
    assert peaks["meta"]["peak"] == peaks["meta"]["split"]["Total"] > 0
    assert peaks["meta"]["records"] == []


def test_one_device_dry_run_prices_the_kernel_path():
    rec = dryrun.run_one("gpt2m", tconfigs.ShapeConfig("t", 256, 2, "train"),
                         None, verbose=False)
    assert rec["status"] == "ok" and rec["use_kernels"]
    assert rec["mesh"] == "one device" and rec["n_devices"] == 1
    assert rec["state_bytes"]["params"] == 4 * sum(
        t.numel() for t in _leaves(tregistry.build_model(
            "gpt2m", device="meta").init(torch.Generator(), device="meta")))
    assert rec["memory_per_device_bytes"] > sum(rec["state_bytes"].values())
    assert not any(v["calls"] for v in rec["collectives"].values())


def _leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def test_skips_and_not_ported_are_apart():
    for arch, shape, status, words in (
            ("whisper-small", "long_500k", "skip", "out of scope"),
            ("gpt2m", "long_500k", "skip", "no sub-quadratic"),
            ("minicpm3-4b", "train_4k", "not_ported", "item 13"),
            ("deepseek-v2-236b", "prefill_32k", "not_ported", "item 13"),
            ("whisper-small", "train_4k", "not_ported", "item 14"),
            # a batch of 32 as deep as the stack: ServePlan refuses it
            ("phi3.5-moe-42b-a6.6b", "prefill_32k", "not_ported",
             "queue 3")):
        rec = dryrun.run_one(arch, shape, "shard", verbose=False)
        assert rec["status"] == status and words in rec["reason"], rec


@pytest.mark.parametrize("name", sorted(FULL_RUNS))
def test_full_size_dry_runs(full_runs, name):
    last, rec = full_runs[name]
    assert set(last) <= {"arch", "shape", "plan", "status", "dominant",
                         "reason", "memory_per_device_bytes",
                         "collective_bytes_per_device",
                         "dcn_bytes_per_device"}
    if name.startswith("whisper"):
        assert last["status"] == "not_ported" and "item 14" in last["reason"]
        assert last["plan"] == "shard"
        return
    assert last["status"] == "ok" and last["dominant"] in (
        "compute", "memory", "collective")
    assert rec["memory_per_device_bytes"] > 0 and rec["fits_hbm"]
    assert rec["collective_bytes_per_device"] > 0
    counted = sum(v["bytes"] for v in rec["collectives"].values())
    assert counted == rec["collective_bytes_per_device"] \
        + rec["dcn_bytes_per_device"]
    if name.startswith("gpt2m"):
        assert (rec["plan"], rec["mesh"], rec["n_devices"]) == (
            "shard_zero", "16x16", 256)
        assert rec["collectives"]["reduce_scatter"]["calls"] > 0
        assert rec["dcn_bytes_per_device"] == 0 and rec["use_kernels"]
    else:
        assert (rec["plan"], rec["mesh"], rec["n_devices"]) == (
            "shard", "2x16x16", 512)
        # the logits' gather over the batch's (pod, data) ranks crosses
        assert rec["dcn_bytes_per_device"] > 0 and rec["crosses_pod"]
