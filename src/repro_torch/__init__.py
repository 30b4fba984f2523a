"""PyTorch port of the ``repro`` serving and calibration paths for
NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
names (``configs``, ``models``, ``kernels``, ``serve``, ``core``,
``calib``, ``launch``) and its stacked ``[L, ...]`` parameter layout with
the same ``/``-joined keys, and imports nothing of it.  It serves the
dense (GPT-2, llama3.2), MoE (phi3.5-MoE), SSM (falcon-mamba) and hybrid
(zamba2) families, pretrains GPT-2 on one card, and calibrates the cost
model and plan search to a measured card.  Its kernels (attention
forward and backward, int8-KV decode, two scans, an int8 matmul and the
RMSNorm) are CUDA C++ for ``sm_90a`` under ``csrc/``, compiled with
``nvcc`` at first use (``kernels/_build.py``), so importing the package
needs no compiler.

Entry points (``Model``, ``Engine``, ``ContinuousEngine``,
``launch/serve.py``, ``launch/calibrate.py``) default to
``device="cuda"`` and raise when no card is present; pass
``device="cpu"`` to run the plain PyTorch versions.
"""
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; raises for a CUDA device when no
    card is present instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev
