"""Calibration launcher: profile this host, fit a measured-rate overlay,
and write it as JSON the search can load (docs/calibration.md §3).

    PYTHONPATH=src python -m repro_torch.launch.calibrate \
        --cluster TACC-TACC --model gpt2m --out calibration.json

    PYTHONPATH=src python -m repro_torch.launch.calibrate --device cpu \
        --iters 1 --out calibration.json

The micro-bench runs on the card (``--device cuda``, the default, which
raises without one) at the model's widths (``d_model`` and ``d_ff``:
1024 and 4096 for gpt2m); ``--device cpu`` times the kernels' plain
PyTorch versions instead, at sizes 128 and 192.  ``--sizes`` sets them
for either.  At 128 and 192 a kernel on the card runs for microseconds,
so the host's launch and synchronisation time dominate the sample and
the fitted rate falls far below what the model's products reach.  The
JSON is the reference's ``Calibration`` schema:
``repro.calib.overlay.Calibration.loads`` reads it too.

Measurement protocol per host (each site runs the same command with its
own ``--site``; link rows need one run per site *pair* with the ring
harness pointed across the real socket):

  1. kernel micro-bench (``calib.microbench.kernel_compute_samples``)
     — the int8 matmul and flash-attention kernels + the fp32 matmul —
     yields the site's achieved-TFLOPs rows;
  2. ring-collective micro-bench (``host_ring_collective_samples``) —
     the 2(n-1)-exchange decomposition the cost model prices, timed at
     several payload sizes — yields the link's α/β rows;
  3. optionally, ε-epoch Algorithm-1 probes pooled through
     ``RecordingProber`` (``--probe-steps``) — whole-step rows that tie
     the per-component fits together.

``--synthetic NOISE`` replaces the hardware measurements with the
synthetic-ground-truth harness (a pinned slow-A30 truth) so the whole
profile→fit→search loop runs end-to-end on any machine, with no device
(the reference's ``benchmarks/calib_bench.py`` drives the same loop).
"""
import argparse
import json
import sys
from typing import Tuple

# the micro-bench's matmul sizes on the CPU, where the plain versions
# are slow at a model's widths (the reference's defaults)
CPU_SIZES = (128, 192)


def default_sizes(model: str, device: str) -> Tuple[int, ...]:
    """The micro-bench's square matmul sizes for ``model`` on ``device``:
    the model's widths on the card, ``CPU_SIZES`` on the CPU."""
    import torch

    from repro_torch.configs import get_config

    if torch.device(device).type != "cuda":
        return CPU_SIZES
    cfg = get_config(model)
    return tuple(dict.fromkeys(w for w in (cfg.d_model, cfg.d_ff) if w > 0))


def _sizes(text: str) -> Tuple[int, ...]:
    sizes = tuple(int(x) for x in text.split(",") if x.strip())
    if not sizes or min(sizes) <= 0:
        raise argparse.ArgumentTypeError(f"--sizes wants positive "
                                         f"integers, got {text!r}")
    return sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cluster", default="TACC-TACC",
                    help="paper cluster name (repro_torch.core.costmodel"
                         ".PAPER_CLUSTERS) to calibrate against")
    ap.add_argument("--model", default="gpt2m",
                    help="workload config for step probes and the "
                         "before/after search report")
    ap.add_argument("--site", type=int, default=0,
                    help="which site index this host stands for")
    ap.add_argument("--out", default=None,
                    help="write the fitted calibration JSON here")
    ap.add_argument("--probe-steps", action="store_true",
                    help="pool analytic Algorithm-1 probes as step rows "
                         "(on hardware, wire a LiveProber instead)")
    ap.add_argument("--synthetic", type=float, default=None,
                    metavar="NOISE",
                    help="skip hardware profiling: fit against the "
                         "synthetic slow-A30 ground truth perturbed by "
                         "this multiplicative noise bound")
    ap.add_argument("--iters", type=int, default=2,
                    help="timed iterations per micro-bench point")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions) "
                         "for the kernel micro-bench")
    ap.add_argument("--sizes", type=_sizes, default=None, metavar="M,M",
                    help="square matmul sizes of the kernel micro-bench, "
                         "comma-separated (default: the model's d_model "
                         "and d_ff on the card, 128,192 on the CPU)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.calib.fit import fit_calibration
    from repro_torch.calib.microbench import (RecordingProber,
                                              host_ring_collective_samples,
                                              kernel_compute_samples,
                                              synthetic_measurements)
    from repro_torch.calib.overlay import Calibration, LinkRate
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import (PAPER_CLUSTERS, as_topology,
                                            paper_workload)
    from repro_torch.core.search import PlanSearch
    from repro_torch.core.selector import CostModelProber

    wl = paper_workload(get_config(args.model))
    topo = as_topology(PAPER_CLUSTERS[args.cluster])
    rng = np.random.default_rng(args.seed)

    if args.synthetic is not None:
        truth = Calibration(
            site_tflops={i: 0.6 * min(
                25.0, Calibration.identity().gpu_tflops(topo, i))
                for i in range(topo.n_sites)},
            links={(0, min(1, topo.n_sites - 1)): LinkRate(22e-3, 2.4)},
            note="synthetic slow ground truth")
        samples = synthetic_measurements(
            topo, truth, rng=rng, noise=args.synthetic, wl=wl,
            step_placements=[("data", (0,), {}),
                             ("zero2", tuple(range(topo.n_sites)), {})])
        print(f"synthetic harness: {len(samples)} samples at "
              f"noise={args.synthetic}")
    else:
        sizes = args.sizes or default_sizes(args.model, args.device)
        samples = kernel_compute_samples(args.site, iters=args.iters,
                                         sizes=sizes, seed=args.seed,
                                         device=args.device)
        samples += host_ring_collective_samples(
            (args.site, args.site), iters=args.iters)
        print(f"profiled site {args.site}: {len(samples)} samples "
              f"(kernel compute at sizes {','.join(map(str, sizes))} + "
              f"host-ring collective)")
        if args.probe_steps:
            rec = RecordingProber(CostModelProber(wl, topo), wl)
            PlanSearch(wl, topo, probe_fn=rec.probe).search()
            samples += rec.samples
            print(f"pooled {len(rec.samples)} step probes")

    fr = fit_calibration(topo, samples, note=f"{args.cluster} fit")
    cal = fr.calibration
    print(cal.describe(topo))
    print(f"fit residual {fr.residual:.3e} over {fr.n_samples} samples "
          f"({fr.n_iterations} linearization passes)")

    before = PlanSearch(wl, topo).best()
    after = PlanSearch(wl, topo, calibration=cal).best()
    print(f"search winner: {before.candidate.key} "
          f"({before.tflops:.2f} TFLOP/s analytic) -> "
          f"{after.candidate.key} ({after.tflops:.2f} calibrated)")

    if args.out:
        with open(args.out, "w") as f:
            f.write(cal.dumps())
        print(f"wrote {args.out}")
        # round-trip check: the file must load back to the same overlay
        with open(args.out) as f:
            assert Calibration.loads(f.read()) == cal
    return 0


if __name__ == "__main__":
    sys.exit(main())
