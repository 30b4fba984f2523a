"""Measured-rate calibration: close the analytic cost model to hardware.

``overlay``    — the ``Calibration`` overlay (per-site achieved TFLOP/s,
                 per-link measured α/rate), JSON round-trippable, with
                 ``Calibration.identity()`` bit-for-bit equal to the
                 analytic prices in ``core/costmodel.py``.
``microbench`` — micro-benchmark harness over the port's kernels (int8
                 blocked matmul, flash attention) and the fp32 matmul,
                 a host ring-collective emulation, the
                 ``RecordingProber`` adapter pooling ``LiveProber``
                 ε-epoch step times, and
                 the synthetic-ground-truth measurement generator the
                 test harness fits against.
``fit``        — the least-squares fitter recovering per-site TFLOP/s
                 and per-link α/β from measurements; the design matrix
                 comes straight from the ``TECHNIQUE_SPECS`` component
                 terms (docs/calibration.md derives it).
"""
from repro_torch.calib.overlay import Calibration, LinkRate, MeasuredLink
from repro_torch.calib.fit import (FitResult, Sample, fit_calibration,
                                   step_design_row)

__all__ = [
    "Calibration", "LinkRate", "MeasuredLink",
    "FitResult", "Sample", "fit_calibration", "step_design_row",
]
