"""The port's planning core and calibration against the JAX reference.

``repro_torch.core`` (topology, cost model, search, selector) and
``repro_torch.calib`` (overlay, fit, micro-bench) are copies of the
reference's pure-Python modules; on the same inputs they must give the
very same floats and the very same JSON bytes.  The micro-bench's device
work (the timed kernels) is the only part that differs, and it runs here
on the CPU through the kernels' plain PyTorch versions.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.calib import microbench as jmb  # noqa: E402
from repro.calib.fit import fit_calibration as j_fit  # noqa: E402
from repro.calib.overlay import Calibration as JCal  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.plans import Placement as JPlacement  # noqa: E402
from repro.core.search import PlanSearch as JSearch  # noqa: E402
from repro.core.selector import CostModelProber as JProber  # noqa: E402
from repro.core.selector import select_technique as j_select  # noqa: E402
from repro.launch import calibrate as j_calibrate  # noqa: E402
from repro_torch.calib import microbench as tmb  # noqa: E402
from repro_torch.calib.fit import fit_calibration as t_fit  # noqa: E402
from repro_torch.calib.overlay import Calibration as TCal  # noqa: E402
from repro_torch.calib.overlay import LinkRate as TLinkRate  # noqa: E402
from repro_torch.configs import ARCH_CONFIGS  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core.plans import Placement as TPlacement  # noqa: E402
from repro_torch.core.search import PlanSearch as TSearch  # noqa: E402
from repro_torch.core.selector import (  # noqa: E402
    CostModelProber as TProber, LiveProber, probe_infeasible,
    select_technique as t_select)
from repro_torch.launch import calibrate as t_calibrate  # noqa: E402

CLUSTERS = sorted(jcm.PAPER_CLUSTERS)


def _workloads(arch="gpt2m"):
    return (jcm.paper_workload(j_config(arch)),
            tcm.paper_workload(t_config(arch)))


def _edge3(topo_mod):
    """The three-site example topology of examples/select_technique.py,
    built with the given package's own constructors."""
    S, L = topo_mod.Site, topo_mod.Link
    return topo_mod.make_topology(
        "edge3", [S(("A30", "A30"), name=n) for n in "ABC"],
        {(0, 1): L(0.5e-3, 3.0), (1, 2): L(60e-3, 3.0),
         (0, 2): L(100e-3, 3.0)})


def _wl_fields(wl):
    return (wl.seq_len, wl.global_batch, wl.steps_per_epoch, wl.epochs,
            wl.microbatches, wl.tokens_per_step, wl.flops_per_step,
            wl.bytes_params(), wl.bytes_grads(), wl.bytes_train_state(),
            wl.activation_bytes_per_gpu(4))


def _sample_fields(s):
    d = dict(vars(s))
    wl = d.pop("wl")
    return d, None if wl is None else _wl_fields(wl)


def _same(a, b):
    """Bit-equal floats (None and inf included)."""
    if a is None or b is None:
        return a is b
    return a == b or (math.isnan(a) and math.isnan(b))


def test_static_tables_equal():
    assert set(ttopo.GPUS) == set(jtopo.GPUS)
    for name, g in jtopo.GPUS.items():
        assert vars(ttopo.GPUS[name]) == vars(g)
    assert "H100" not in ttopo.GPUS          # the card enters by overlay
    assert tcm.TECHNIQUES == jcm.TECHNIQUES
    assert tcm.ALL_TECHNIQUES == jcm.ALL_TECHNIQUES
    assert tcm.SCHEDULES == jcm.SCHEDULES
    assert sorted(tcm.PAPER_CLUSTERS) == CLUSTERS
    assert ttopo.TCP_WINDOW_BYTES == jtopo.TCP_WINDOW_BYTES


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("technique", jcm.TECHNIQUES)
def test_step_cost_bit_equal(cluster, technique):
    jwl, twl = _workloads()
    jc, tc = jcm.PAPER_CLUSTERS[cluster], tcm.PAPER_CLUSTERS[cluster]
    for vms in (None, [0], [1]):
        j = jcm.avg_tflops(technique, jwl, jc, vms)
        t = tcm.avg_tflops(technique, twl, tc, vms)
        assert _same(t, j), (vms, t, j)
        jcost = jcm.technique_step_cost(technique, jwl, jc, vms)
        tcost = tcm.technique_step_cost(technique, twl, tc, vms)
        assert _same(tcost.total_s, jcost.total_s), (vms,)
        assert vars(tcost) == vars(jcost)


@pytest.mark.parametrize("arch", sorted(ARCH_CONFIGS))
def test_workload_and_param_count_equal(arch):
    jcfg, tcfg = j_config(arch), t_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    jwl, twl = _workloads(arch)
    assert _wl_fields(twl) == _wl_fields(jwl)


def test_moe_active_params_not_ported():
    import dataclasses
    moe = dataclasses.replace(t_config("gpt2m"), family="moe")
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.active_param_count()


@pytest.mark.parametrize("where", ["TACC-TACC", "BRIS-STAR", "edge3"])
def test_plan_search_best_equal(where):
    jwl, twl = _workloads()
    if where == "edge3":
        jt, tt = _edge3(jtopo), _edge3(ttopo)
    else:
        jt = jcm.as_topology(jcm.PAPER_CLUSTERS[where])
        tt = tcm.as_topology(tcm.PAPER_CLUSTERS[where])
    jb, tb = JSearch(jwl, jt).best(), TSearch(twl, tt).best()
    assert tb.candidate.key == jb.candidate.key
    assert _same(tb.tflops, jb.tflops)
    jr = [(r.candidate.key, r.tflops) for r in JSearch(jwl, jt).search()]
    tr = [(r.candidate.key, r.tflops) for r in TSearch(twl, tt).search()]
    assert tr == jr


@pytest.mark.parametrize("cluster", ["TACC-TACC", "GAT-AMST"])
def test_algorithm1_selection_equal(cluster):
    jwl, twl = _workloads()
    js = j_select(JProber(jwl, jcm.PAPER_CLUSTERS[cluster]))
    ts = t_select(TProber(twl, tcm.PAPER_CLUSTERS[cluster]))
    assert (ts.technique, ts.vms, ts.probes) == \
        (js.technique, js.vms, js.probes)


def _synthetic(mb, cm, topo_mod, cal_cls, link_cls):
    wl = cm.paper_workload((j_config if mb is jmb else t_config)("gpt2m"))
    topo = cm.as_topology(cm.PAPER_CLUSTERS["TACC-TACC"])
    truth = cal_cls(site_tflops={0: 11.0, 1: 5.5},
                    links={(0, 1): link_cls(22e-3, 2.4)}, note="truth")
    samples = mb.synthetic_measurements(
        topo, truth, rng=np.random.default_rng(5), noise=0.05, wl=wl,
        step_placements=[("data", (0,), {}), ("zero2", (0, 1), {})])
    return topo, samples


def test_synthetic_samples_and_fit_byte_equal():
    from repro.calib.overlay import LinkRate as JLinkRate
    jt, js = _synthetic(jmb, jcm, jtopo, JCal, JLinkRate)
    tt, ts = _synthetic(tmb, tcm, ttopo, TCal, TLinkRate)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert _sample_fields(a) == _sample_fields(b)
    jf, tf = j_fit(jt, js, note="fit"), t_fit(tt, ts, note="fit")
    assert tf.calibration.dumps() == jf.calibration.dumps()
    assert (tf.residual, tf.n_samples, tf.n_iterations) == \
        (jf.residual, jf.n_samples, jf.n_iterations)


def test_calibrate_synthetic_json_byte_equal(tmp_path, capsys):
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    assert j_calibrate.main(["--synthetic", "0.05", "--out", str(jp)]) == 0
    assert t_calibrate.main(["--synthetic", "0.05", "--out", str(tp)]) == 0
    assert tp.read_bytes() == jp.read_bytes()
    # a JSON written by either package loads in the other
    jcal, tcal = JCal.loads(tp.read_text()), TCal.loads(jp.read_text())
    assert jcal.dumps() == tcal.dumps() == jp.read_text()
    out = capsys.readouterr().out
    assert out.count("search winner:") == 2


def test_calibrated_search_equal_under_one_overlay():
    """A fitted overlay loaded by both packages prices the same search."""
    jwl, twl = _workloads()
    text = TCal(site_tflops={0: 52.0}, links={(0, 0): TLinkRate(
        4e-6, 180.0)}, note="H100-like").dumps()
    jt = jcm.as_topology(jcm.PAPER_CLUSTERS["TACC-TACC"])
    tt = tcm.as_topology(tcm.PAPER_CLUSTERS["TACC-TACC"])
    jb = JSearch(jwl, jt, calibration=JCal.loads(text)).best()
    tb = TSearch(twl, tt, calibration=TCal.loads(text)).best()
    assert tb.candidate.key == jb.candidate.key
    assert _same(tb.tflops, jb.tflops)


def test_placement_validates_like_reference():
    p = TPlacement((0, 1), stage_order=(1, 0), stage_layers=(12, 12))
    q = JPlacement((0, 1), stage_order=(1, 0), stage_layers=(12, 12))
    assert (p.n_stages, p.pod_permutation()) == \
        (q.n_stages, q.pod_permutation())
    with pytest.raises(ValueError, match="permutation"):
        TPlacement((0, 1), stage_order=(0, 2))
    with pytest.raises(ValueError):
        TPlacement((0,), schedule="no-such-schedule")


def test_probe_infeasible_on_torch_oom_only():
    assert probe_infeasible(torch.OutOfMemoryError("CUDA out of memory"))
    assert probe_infeasible(MemoryError())
    assert not probe_infeasible(TypeError("bad argument"))
    assert not probe_infeasible(RuntimeError("out of memory"))

    def oom(technique, placement):
        raise torch.OutOfMemoryError("CUDA out of memory")

    def bug(technique, placement):
        raise TypeError("bad argument")

    assert LiveProber(oom).probe("data", None) is None
    with pytest.raises(TypeError):
        LiveProber(bug).probe("data", None)


def test_calibrate_on_cpu_profiles_and_fits(tmp_path, capsys):
    """The hardware path at ``--device cpu``: the micro-bench times the
    kernels' plain versions; the JSON loads in both packages and holds a
    positive site rate."""
    out = tmp_path / "cal.json"
    assert t_calibrate.main(["--device", "cpu", "--iters", "1",
                             "--out", str(out)]) == 0
    text = out.read_text()
    cal, jcal = TCal.loads(text), JCal.loads(text)
    assert cal.site_tflops[0] > 0 and jcal.site_tflops == cal.site_tflops
    assert json.loads(text)["note"] == "TACC-TACC fit"
    assert "profiled site 0: 8 samples" in capsys.readouterr().out


def test_calibrate_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        t_calibrate.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="is_available"):
        tmb.kernel_compute_samples(0, iters=1)


def test_kernel_compute_samples_on_cpu():
    rows = tmb.kernel_compute_samples(1, iters=1, sizes=(64,),
                                      device="cpu")
    # fp32 matmul and int8 matmul per size, then one flash sample
    assert [r.kind for r in rows] == ["compute"] * 3
    assert [r.flops for r in rows] == [2.0 * 64 ** 3] * 2 + [
        4.0 * 128 * 128 * 4 * 64]
    assert all(r.site == 1 and r.time_s > 0 for r in rows)
