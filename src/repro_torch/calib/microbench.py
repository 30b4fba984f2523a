"""Micro-benchmark harnesses producing ``fit.Sample`` measurement sets.

Three measurement families (docs/calibration.md §1):

  * ``kernel_compute_samples`` — times the port's kernels
    (``ops.int8_matmul``, kernel 5; ``ops.flash_attention``, kernel A)
    and the fp32 ``torch.matmul`` at several sizes, on the card (the
    plain PyTorch versions when asked for the CPU), each with its known
    FLOP count → per-site compute rows.
  * ``host_ring_collective_samples`` — emulates the ring all-reduce's
    2(n-1) chunk exchanges over host memory at several payload sizes →
    per-link α/β rows (on one host this measures the loopback/memory
    path standing in for the intra-site link; real deployments run it
    once per site pair).
  * ``RecordingProber`` — wraps any ``core.selector`` prober (the live
    ε-epoch ``LiveProber`` included) and pools every probed step time
    into step rows, so Algorithm-1 probes stop being thrown away.

``synthetic_measurements`` generates the same three families from a
*known* ground-truth ``Calibration`` with bounded multiplicative noise —
the synthetic-ground-truth harness the fitter is proven against
(tests/test_calib.py) and that ``benchmarks/calib_bench.py`` closes the
before/after ``search_vs_measured_error`` loop with.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.calib.fit import (Sample, collective_sample, compute_sample,
                                   step_sample)
from repro_torch.calib.overlay import Calibration, _key
from repro_torch.core.costmodel import Workload, technique_step_cost
from repro_torch.core.plans import Placement
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops


def _time_s(fn, *args, iters: int = 2) -> float:
    """Warm once, then average wall seconds per call (the
    benchmarks/kernel_bench.py convention); on the card each timed call
    ends in ``torch.cuda.synchronize()``."""
    def run():
        out = fn(*args)
        if out.is_cuda:
            torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters


def kernel_compute_samples(site: int = 0, *, iters: int = 2,
                           sizes: Sequence[int] = (128, 192),
                           seed: int = 0,
                           device: str = "cuda") -> List[Sample]:
    """Compute rows from real kernel timings on this host.

    Args:
        site: which topology site this host stands for.
        iters: timed calls per kernel after the warm-up call.
        sizes: square matmul sizes M=K=N to time.
        seed: PRNG seed for the operand data.
        device: ``"cuda"`` times the kernels on the card (and raises
            without one); ``"cpu"`` times their plain PyTorch versions.

    Returns:
        One ``"compute"`` sample per timing, FLOPs attributed per GPU.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: List[Sample] = []

    def put(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=dev, dtype=dtype)

    for m in sizes:
        x, w = put((m, m)), put((m, m))
        flops = 2.0 * m * m * m
        out.append(compute_sample(site, flops,
                                  _time_s(torch.matmul, x, w, iters=iters)))
        out.append(compute_sample(
            site, flops,
            _time_s(lambda *a: ops.int8_matmul(
                *a, block_m=64, block_k=64, block_n=64), x, w,
                iters=iters)))
    b, s, h, kv, d = 1, 128, 4, 2, 64
    # kernel A takes bf16; the plain version runs the fp32 operands
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    q = put((b, s, h, d), dtype)
    k = put((b, s, kv, d), dtype)
    v = put((b, s, kv, d), dtype)
    flops = 4.0 * b * s * s * h * d
    out.append(compute_sample(
        site, flops,
        _time_s(lambda *a: ops.flash_attention(*a, causal=True), q, k, v,
                iters=iters)))
    return out


def host_ring_collective_samples(pair: Tuple[int, int] = (0, 0), *,
                                 n_ranks: int = 2,
                                 sizes_bytes: Sequence[float] = (
                                     1 << 20, 4 << 20, 16 << 20),
                                 iters: int = 2) -> List[Sample]:
    """Collective rows from an emulated ring all-reduce over host
    memory: 2(n-1) chunk exchanges of volume/n bytes each (the
    reduce-scatter + all-gather decomposition ``_allreduce_time``
    prices), timed wall-clock.

    On a single host this measures the loopback/memcpy path — a real
    per-link measurement runs the same exchange across the actual
    socket (``repro_torch.launch.calibrate`` documents the protocol).
    """
    out: List[Sample] = []
    for volume in sizes_bytes:
        chunk = max(int(volume) // max(n_ranks, 1) // 4, 1)   # fp32 words
        src = np.ones(chunk, np.float32)
        acc = np.zeros(chunk, np.float32)
        buf = np.empty(chunk, np.float32)

        def once() -> None:
            for _ in range(2 * (n_ranks - 1)):
                np.copyto(buf, src)        # the "send/recv" hop
                np.add(acc, buf, out=acc)  # the reduce (or gather write)

        once()
        t0 = time.perf_counter()
        for _ in range(iters):
            once()
        out.append(collective_sample(
            pair, n_ranks, float(volume),
            (time.perf_counter() - t0) / iters))
    return out


@dataclass
class RecordingProber:
    """A ``core.selector.Prober`` that pools every ε-epoch step time.

    Wraps any inner prober (``LiveProber`` on hardware,
    ``CostModelProber`` in tests/benches) and converts each successful
    probe back to the step seconds the TFLOP/s figure came from
    (``time = flops_per_step / (tflops * 1e12)``), recording a
    ``"step"`` sample per probe — the measurements Algorithm 1 used to
    throw away become fitter rows.
    """
    inner: object               # anything with .probe(technique, placement)
    wl: Workload
    samples: List[Sample] = field(default_factory=list)

    @property
    def n_sites(self) -> int:
        return getattr(self.inner, "n_sites", 2)

    def probe(self, technique: str, placement: Optional[Placement]
              ) -> Optional[float]:
        tflops = self.inner.probe(technique, placement)
        if tflops and placement is not None:
            self.samples.append(step_sample(
                technique, tuple(placement.sites), self.wl,
                self.wl.flops_per_step / (tflops * 1e12),
                stage_order=placement.stage_order,
                stage_layers=placement.stage_layers,
                schedule=placement.schedule))
        return tflops


def synthetic_measurements(
        topo: Topology, truth: Calibration, *,
        rng: np.random.Generator, noise: float = 0.0,
        compute_flops: Sequence[float] = (1e12, 4e12),
        link_scales: Sequence[float] = (0.3, 3.0, 30.0),
        step_placements: Sequence[Tuple[str, Tuple[int, ...], dict]] = (),
        wl: Optional[Workload] = None) -> List[Sample]:
    """The synthetic-ground-truth harness: measurement sets whose exact
    generating coefficients are known.

    Times are computed from ``truth`` by the very formulas the cost
    model prices with, then perturbed multiplicatively by
    ``1 + noise * u`` with ``u ~ U(-1, 1)`` — so at ``noise=0`` the
    fitter must recover ``truth`` exactly (up to float roundoff), and
    under noise the recovery error is provably noise-bounded.

    Args:
        topo: the topology being "measured".
        truth: the ground-truth overlay generating the times.
        rng: noise source.
        noise: multiplicative noise bound (0 = exact).
        compute_flops: per-site kernel sizes (FLOPs per GPU).
        link_scales: per-link payload sizes as multiples of the link's
            latency-bandwidth product (spanning the α- and β-dominated
            regimes keeps both coefficients well-conditioned).
        step_placements: optional ``(technique, sites, knobs)`` whole-
            step probes, priced under ``truth`` (requires ``wl``).
        wl: the workload for step placements.
    """
    def jitter() -> float:
        return 1.0 + noise * float(rng.uniform(-1.0, 1.0)) if noise \
            else 1.0

    out: List[Sample] = []
    for i in range(topo.n_sites):
        rate = truth.gpu_tflops(topo, i) * 1e12
        for flops in compute_flops:
            out.append(compute_sample(i, flops,
                                      flops / rate * jitter()))
    pairs = [(i, i) for i in range(topo.n_sites)]
    pairs += [_key(i, j) for i in range(topo.n_sites)
              for j in range(i + 1, topo.n_sites)]
    for pair in pairs:
        link = truth.link(topo, *pair)
        alpha_s = link.latency_s
        rate = link.effective_gbps * 1e9
        base_bytes = max(alpha_s, 1e-6) * rate
        n = 2
        for scale in link_scales:
            volume = base_bytes * scale
            t = 2 * (n - 1) * alpha_s \
                + 2 * (n - 1) / n * volume / rate
            out.append(collective_sample(pair, n, volume, t * jitter()))
    for technique, sel, knobs in step_placements:
        assert wl is not None, "step placements need a workload"
        t = technique_step_cost(technique, wl, topo, sel,
                                calibration=truth, **knobs).total_s
        out.append(step_sample(technique, sel, wl, t * jitter(),
                               **knobs))
    return out
