"""Least-squares fit of measured rates into the cost model's coefficients.

The analytic cost model (``core/costmodel.py``) prices every step as a
sum that is *linear* in exactly two coefficient families per
``CostContext`` (docs/calibration.md §2 derives this from the
``TECHNIQUE_SPECS`` component terms):

  * ``theta_site = 1 / (tflops * 1e12)`` — seconds per FLOP of one GPU
    of a site (compute terms are ``flops_share * theta_site``), and
  * per site pair, ``alpha`` (link latency seconds; collectives pay
    ``rounds * alpha``) and ``beta = 1 / (gbps * 1e9)`` — seconds per
    byte (collectives pay ``fraction * volume_bytes * beta``).

So a measurement set — kernel timings (compute rows), ring-collective
timings at several sizes (link rows), and whole-step times pooled from
``LiveProber`` ε-epoch probes (step rows, whose design row
``step_design_row`` reads straight off the registered component
structure) — is an ordinary linear least-squares problem in those
coefficients.  ``fit_calibration`` solves it and returns a
``Calibration`` overlay; at zero measurement noise the recovery is
exact up to float roundoff (property-tested in tests/test_calib.py).

Step rows have one nonlinearity: the *structure* (which spanning link
is the worst, which stage paces the pipeline) depends on the
coefficients.  The fitter linearizes at the current estimate and
iterates to a fixpoint — micro rows pin the estimate well enough that
the structure is right after the first pass in practice.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.calib.overlay import Calibration, LinkRate, _key
from repro_torch.core.costmodel import (TECHNIQUE_SPECS, Workload,
                                        _act_byte_scale, _allreduce_time,
                                        _gather_time, _make_context,
                                        _state_byte_scale, technique_step_cost)
from repro_torch.core.topology import Topology

#: design-matrix coefficient keys
#:   ("site", i)          -> theta_site = 1 / (tflops * 1e12)
#:   ("alpha", (i, j))    -> link latency seconds (canonical i <= j)
#:   ("beta", (i, j))     -> 1 / (effective_gbps * 1e9)
CoefKey = Tuple[str, object]
Row = Dict[CoefKey, float]


# --------------------------------------------------------------------- #
# measurement samples
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Sample:
    """One timed measurement.  ``kind`` selects which fields apply:

    ``"compute"``    — ``site``, ``flops`` (FLOPs executed by ONE GPU of
                       that site), ``time_s``.
    ``"collective"`` — ``link`` (canonical site pair; ``(i, i)`` is the
                       intra link), ``n_ranks``, ``volume_bytes``,
                       ``time_s`` of one ring all-reduce.
    ``"step"``       — ``technique``, ``sites``, ``wl`` and the
                       placement knobs; ``time_s`` of one optimizer
                       step (a pooled ``LiveProber`` ε-epoch time).
    """
    kind: str
    time_s: float
    site: int = 0
    flops: float = 0.0
    link: Optional[Tuple[int, int]] = None
    n_ranks: int = 0
    volume_bytes: float = 0.0
    technique: str = ""
    sites: Optional[Tuple[int, ...]] = None
    wl: Optional[Workload] = None
    stage_order: Optional[Tuple[int, ...]] = None
    stage_layers: Optional[Tuple[int, ...]] = None
    schedule: str = "gpipe"
    carrier_dtype: str = "fp32"
    wire_dtype: str = "fp32"


def compute_sample(site: int, flops: float, time_s: float) -> Sample:
    return Sample("compute", time_s, site=site, flops=flops)


def collective_sample(link: Tuple[int, int], n_ranks: int,
                      volume_bytes: float, time_s: float) -> Sample:
    return Sample("collective", time_s, link=_key(*link), n_ranks=n_ranks,
                  volume_bytes=volume_bytes)


def step_sample(technique: str, sites: Sequence[int], wl: Workload,
                time_s: float, **knobs) -> Sample:
    return Sample("step", time_s, technique=technique,
                  sites=tuple(sites), wl=wl, **knobs)


# --------------------------------------------------------------------- #
# coefficient <-> Calibration conversions
# --------------------------------------------------------------------- #

def theta_value(key: CoefKey, cal: Calibration, topo: Topology) -> float:
    """The coefficient's current value under a calibration."""
    kind, k = key
    if kind == "site":
        return 1.0 / (cal.gpu_tflops(topo, k) * 1e12)
    link = cal.link(topo, k[0], k[1])
    if kind == "alpha":
        return link.latency_s
    return 1.0 / (link.effective_gbps * 1e9)


def row_dot(row: Row, cal: Calibration, topo: Topology) -> float:
    """Predicted seconds of a design row at a calibration — equals
    ``technique_step_cost(..., calibration=cal).total_s`` up to float
    roundoff when the row was built at the same linearization point."""
    return sum(w * theta_value(k, cal, topo) for k, w in row.items())


# --------------------------------------------------------------------- #
# design rows
# --------------------------------------------------------------------- #

def _add(row: Row, key: CoefKey, w: float) -> None:
    row[key] = row.get(key, 0.0) + w


def _allreduce_row(row: Row, volume_bytes: float, n: int,
                   pair: Tuple[int, int], scale: float = 1.0) -> None:
    """``scale * _allreduce_time(volume, n, link(pair))`` as a row."""
    if n <= 1:
        return
    _add(row, ("alpha", pair), scale * 2 * (n - 1))
    _add(row, ("beta", pair), scale * 2 * (n - 1) / n * volume_bytes)


def _gather_row(row: Row, volume_bytes: float, n: int,
                pair: Tuple[int, int], scale: float = 1.0) -> None:
    """``scale * _gather_time(...)`` (all-gather / reduce-scatter)."""
    if n <= 1:
        return
    _add(row, ("alpha", pair), scale * (n - 1))
    _add(row, ("beta", pair), scale * (n - 1) / n * volume_bytes)


def _worst_pair(cal: Calibration, topo: Topology, sel: Sequence[int],
                volume_bytes: float, n: int, timer) -> Tuple[int, int]:
    """The spanning pair a collective is priced on: argmax of ``timer``
    over the calibrated spanning links (first max, matching ``max()``
    in ``_collective_time``); single site -> its intra pair."""
    if len(sel) <= 1:
        return (sel[0], sel[0])
    best_t, best_pair = None, None
    for i, j in itertools.combinations(topo.select(sel), 2):
        t = timer(volume_bytes, n, cal.link(topo, i, j))
        if best_t is None or t > best_t:
            best_t, best_pair = t, (i, j)
    return best_pair


def step_design_row(technique: str, wl: Workload, topo: Topology,
                    sites: Optional[Sequence[int]] = None, *,
                    stage_order: Optional[Sequence[int]] = None,
                    stage_balance: str = "even",
                    stage_layers: Optional[Sequence[int]] = None,
                    schedule: str = "gpipe",
                    carrier_dtype: str = "fp32",
                    wire_dtype: str = "fp32",
                    calibration: Optional[Calibration] = None) -> Row:
    """The step time of one (technique × placement) as a linear row over
    the calibration coefficients, linearized at ``calibration`` (the
    max/argmax structure — worst spanning link, pace-setting site or
    stage — is frozen at that point; everything else is exact).

    ``row_dot(row, calibration, topo)`` reproduces
    ``technique_step_cost(..., calibration=calibration).total_s`` up to
    float roundoff — the consistency property in tests/test_calib.py.
    """
    cal = Calibration.identity() if calibration is None else calibration
    spec = TECHNIQUE_SPECS[technique]
    ctx = _make_context(wl, topo, sites, stage_order=stage_order,
                        stage_balance=stage_balance,
                        stage_layers=stage_layers, schedule=schedule,
                        carrier_dtype=carrier_dtype,
                        wire_dtype=wire_dtype,
                        comm=spec.comm_precision, calibration=cal)
    sel, n = ctx.sel, ctx.n
    n_layers = wl.cfg.n_layers
    state_scale = _state_byte_scale(ctx)
    act_scale = _act_byte_scale(ctx)
    row: Row = {}

    if technique != "pipeshard":
        # flat-pool compute: the slowest site's rate paces the pool
        pace = min(sel, key=lambda i: cal.gpu_tflops(topo, i))
        _add(row, ("site", pace), ctx.flops / n)

    if technique == "data":
        vol = ctx.g_bytes * state_scale
        pair = _worst_pair(cal, topo, sel, vol, n, _allreduce_time)
        _allreduce_row(row, vol, n, pair)
    elif technique == "zero2":
        vol = ctx.g_bytes * state_scale
        pair = _worst_pair(cal, topo, sel, vol, n, _allreduce_time)
        _allreduce_row(row, vol, n, pair, scale=2.2)
    elif technique == "shard":
        vol = ctx.act_stream_bytes * act_scale
        pair = _worst_pair(cal, topo, sel, vol, n, _allreduce_time)
        _allreduce_row(row, vol, n, pair, scale=4 * n_layers)
    elif technique == "shard_zero":
        n_rep = len(sel)
        share = ctx.act_stream_bytes * act_scale / n_rep
        pace_i, pace_t = None, None
        for i in sel:
            k = len(topo.sites[i].gpus)
            t = 4 * n_layers * _allreduce_time(share, k,
                                               cal.link(topo, i, i))
            if pace_t is None or t > pace_t:
                pace_i, pace_t = i, t
        _allreduce_row(row, share, len(topo.sites[pace_i].gpus),
                       (pace_i, pace_i), scale=4 * n_layers)
        if n_rep > 1:
            vol = ctx.g_bytes * state_scale / ctx.tp
            pair = _worst_pair(cal, topo, sel, vol, n_rep,
                               _allreduce_time)
            _allreduce_row(row, vol, n_rep, pair, scale=2.2)
    elif technique == "fsdp":
        p_vol = ctx.p_bytes * state_scale / n_layers
        pair = _worst_pair(cal, topo, sel, p_vol, n, _gather_time)
        _gather_row(row, p_vol, n, pair, scale=2 * n_layers)
        g_vol = ctx.g_bytes * state_scale
        pair = _worst_pair(cal, topo, sel, g_vol, n, _gather_time)
        _gather_row(row, g_vol, n, pair)
    elif technique == "pipeshard":
        g = ctx.pipeline()
        # compute: the slowest (layer-weighted) stage paces every tick
        pace_s, pace_t = 0, None
        for s in range(g.n_stages):
            share = (ctx.flops / g.n_stages if g.split is None
                     else g.stage_l[s] / n_layers * ctx.flops)
            t = share / g.mesh_tflops[s]
            if pace_t is None or t > pace_t:
                pace_s, pace_t = s, t
        site = g.order[pace_s]
        k = len(topo.sites[site].gpus)
        share = (ctx.flops / g.n_stages if g.split is None
                 else g.stage_l[pace_s] / n_layers * ctx.flops)
        _add(row, ("site", site), share / k * (1 + g.bubble))
        # per-stage intra-op all-reduces: slowest stage paces
        act_vol = ctx.act_stream_bytes * act_scale
        pace_s, pace_t = 0, None
        for s in range(g.n_stages):
            i = g.order[s]
            li = (n_layers / g.n_stages if g.split is None
                  else g.stage_l[s])
            t = 4 * li * _allreduce_time(act_vol,
                                         len(topo.sites[i].gpus),
                                         cal.link(topo, i, i))
            if pace_t is None or t > pace_t:
                pace_s, pace_t = s, t
        i = g.order[pace_s]
        li = (n_layers / g.n_stages if g.split is None
              else g.stage_l[pace_s])
        _allreduce_row(row, act_vol, len(topo.sites[i].gpus), (i, i),
                       scale=4 * li)
        # per-boundary p2p carriers
        m = wl.microbatches
        carrier_vol = m * (ctx.act_stream_bytes * ctx.carrier_scale / m)
        v = g.virt if (g.kind == "interleaved" and g.n_stages > 1) else 1
        for a, b in zip(g.order[:-1], g.order[1:]):
            pair = _key(a, b)
            _add(row, ("alpha", pair), v * 2 * m)
            _add(row, ("beta", pair), v * 2 * carrier_vol)
        if v > 1:
            pair = _key(g.order[-1], g.order[0])
            _add(row, ("alpha", pair), (v - 1) * 2 * m)
            _add(row, ("beta", pair),
                 (v - 1) * 2 * ctx.act_stream_bytes * ctx.carrier_scale)
    else:
        raise ValueError(f"no design row for technique {technique!r}")
    return row


def _sample_row(s: Sample, topo: Topology, cal: Calibration
                ) -> Tuple[Row, float]:
    """(design row, measured seconds) of any sample kind."""
    if s.kind == "compute":
        return {("site", s.site): s.flops}, s.time_s
    if s.kind == "collective":
        row: Row = {}
        _allreduce_row(row, s.volume_bytes, s.n_ranks, _key(*s.link))
        return row, s.time_s
    if s.kind == "step":
        row = step_design_row(
            s.technique, s.wl, topo, s.sites, stage_order=s.stage_order,
            stage_layers=s.stage_layers, schedule=s.schedule,
            carrier_dtype=s.carrier_dtype, wire_dtype=s.wire_dtype,
            calibration=cal)
        return row, s.time_s
    raise ValueError(f"unknown sample kind {s.kind!r}")


# --------------------------------------------------------------------- #
# the fitter
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class FitResult:
    """The fitted overlay plus diagnostics.

    Attributes:
        calibration: the fitted overlay (unmeasured sites/links fall
            through to the base/analytic prices).
        residual: RMS relative residual (predicted/measured - 1) over
            all samples at the fitted calibration.
        n_samples: number of samples fitted.
        n_iterations: linearize-and-solve passes taken.
    """
    calibration: Calibration
    residual: float
    n_samples: int
    n_iterations: int


#: relative weight of the pull-to-prior rows that regularize
#: directions no measurement constrains (perturbs well-measured
#: coefficients by ~ the square of this — far below fit tolerances)
_PRIOR_WEIGHT = 1e-6


def _solve(rows: List[Tuple[Row, float]], keys: List[CoefKey],
           cal: Calibration, topo: Topology) -> Dict[CoefKey, float]:
    """One relative least-squares solve.  Each measurement row is scaled
    by 1 / time so multiplicative noise is homoskedastic, and each
    *column* by the coefficient's prior value — the raw thetas span
    ~1e-14 s/FLOP to ~1e-2 s, and without the normalization the design
    matrix is so ill-conditioned that even noiseless recovery loses
    half its digits.  A weak prior row per coefficient pulls unmeasured
    directions toward the current calibration."""
    idx = {k: c for c, k in enumerate(keys)}
    priors = [theta_value(k, cal, topo) for k in keys]
    scales = [p if p > 0.0 else 1.0 for p in priors]
    a = np.zeros((len(rows) + len(keys), len(keys)))
    b = np.zeros(len(rows) + len(keys))
    for r, (row, t) in enumerate(rows):
        for k, w in row.items():
            a[r, idx[k]] = w * scales[idx[k]] / t
        b[r] = 1.0
    for c in range(len(keys)):
        a[len(rows) + c, c] = _PRIOR_WEIGHT
        b[len(rows) + c] = _PRIOR_WEIGHT * priors[c] / scales[c]
    ratio, *_ = np.linalg.lstsq(a, b, rcond=None)
    out = {}
    for c, k in enumerate(keys):
        v = float(ratio[c]) * scales[c]
        # a non-positive rate/latency is unphysical — keep the prior
        if k[0] == "alpha":
            out[k] = v if v >= 0.0 else priors[c]
        else:
            out[k] = v if v > 1e-18 else priors[c]
    return out


def _to_calibration(theta: Mapping[CoefKey, float], base: Calibration,
                    topo: Topology, note: str) -> Calibration:
    sites = dict(base.site_tflops)
    links = dict(base.links)
    for (kind, k), v in theta.items():
        if kind == "site":
            sites[k] = 1.0 / (v * 1e12)
    pairs = {k for kind, k in theta if kind in ("alpha", "beta")}
    for k in sorted(pairs):
        fallback = base.link(topo, k[0], k[1])
        alpha = theta.get(("alpha", k), fallback.latency_s)
        if ("beta", k) in theta:
            gbps = 1.0 / (theta[("beta", k)] * 1e9)
        else:
            gbps = fallback.effective_gbps
        links[k] = LinkRate(alpha, gbps)
    return Calibration(sites, links, note)


def fit_calibration(topo: Topology, samples: Sequence[Sample], *,
                    base: Optional[Calibration] = None, max_iter: int = 5,
                    note: str = "fitted") -> FitResult:
    """Fit a ``Calibration`` overlay to a measurement set.

    Args:
        topo: the topology the measurements were taken on.
        samples: compute / collective / step ``Sample``s (see
            ``repro_torch.calib.microbench`` for harnesses that produce them).
        base: starting overlay; unmeasured coefficients keep its values
            (default: the identity — analytic prices).
        max_iter: linearize-and-solve passes for step-row structure.
        note: provenance string stored on the result.

    Returns:
        A ``FitResult``; exact recovery at zero noise, noise-bounded
        otherwise (tests/test_calib.py pins both).
    """
    samples = list(samples)
    if not samples:
        raise ValueError("cannot fit an empty measurement set")
    base0 = base if base is not None else Calibration.identity()
    cal = base0
    has_steps = any(s.kind == "step" for s in samples)
    n_iter = 0
    for n_iter in range(1, (max_iter if has_steps else 1) + 1):
        rows = [_sample_row(s, topo, cal) for s in samples]
        keys = sorted({k for row, _ in rows for k in row},
                      key=lambda k: (k[0], str(k[1])))
        theta = _solve(rows, keys, cal, topo)
        new_cal = _to_calibration(theta, base0, topo, note)
        drift = max((abs(theta[k] / theta_value(k, cal, topo) - 1.0)
                     for k in keys), default=0.0)
        cal = new_cal
        if drift < 1e-12:
            break
    sq = 0.0
    for s in samples:
        row, t = _sample_row(s, topo, cal)
        if s.kind == "step":
            pred = technique_step_cost(
                s.technique, s.wl, topo, s.sites,
                stage_order=s.stage_order, stage_layers=s.stage_layers,
                schedule=s.schedule, carrier_dtype=s.carrier_dtype,
                wire_dtype=s.wire_dtype, calibration=cal).total_s
        else:
            pred = row_dot(row, cal, topo)
        sq += (pred / t - 1.0) ** 2
    return FitResult(cal, float(np.sqrt(sq / len(samples))),
                     len(samples), n_iter)
