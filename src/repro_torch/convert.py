"""Carry weights from the reference package into the port.

Two sources, both read with numpy alone:

  * a parameter tree already on the host — nested dicts of arrays, or a
    flat dict keyed by the ``/``-joined tree paths that the reference's
    checkpoints use (``embed/table``, ``layers/attn/wq``, ...);
  * a reference checkpoint directory: npz shards plus ``manifest.json``,
    each shard checked against the manifest's sha256 before it is read.

Either way the result is the port's nested dict of fp32 tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.train.checkpoint import flatten, load_manifest, read_flat


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def params_from_numpy(tree: Mapping[str, Any], *, device="cpu",
                      dtype=torch.float32) -> Dict[str, Any]:
    """Nested or flat (``/``-keyed) host arrays -> the port's nested dict
    of tensors on ``device``.  Floating leaves take ``dtype``."""
    flat = flatten(tree) if any(isinstance(v, Mapping)
                                for v in tree.values()) else dict(tree)
    out = {}
    for key, leaf in flat.items():
        t = torch.from_numpy(np.array(leaf))     # a writable host copy
        if t.is_floating_point():
            t = t.to(dtype)
        out[key] = t.to(device)
    return unflatten(out)


def load_checkpoint(path: str, *, device="cpu", verify: bool = True
                    ) -> Dict[str, Any]:
    """Params of a reference checkpoint directory (``step_XXXXXXXX``),
    read through ``train/checkpoint.py``.

    Raises:
        ValueError: no manifest, a shard is missing, or a shard's sha256
            disagrees with the manifest.
    """
    manifest = load_manifest(path, verify=verify)
    return params_from_numpy(read_flat(path, manifest, "params"),
                             device=device)
