#!/usr/bin/env python
"""Shim for ``python -m repro_torch.analysis`` runnable from the repo root
without setting PYTHONPATH:

    python tools/lint_repro_torch.py [--format json] [--passes ...]

The reference's passes over the PyTorch port; see docs/static-analysis.md
for the pass catalog and baseline workflow.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.analysis.__main__ import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
