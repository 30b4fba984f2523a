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

import hashlib
import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


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


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_checkpoint(path: str, *, device="cpu", verify: bool = True
                    ) -> Dict[str, Any]:
    """Params of a reference checkpoint directory (``step_XXXXXXXX``).

    Raises:
        ValueError: no manifest, a shard is missing, or a shard's sha256
            disagrees with the manifest.
    """
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isfile(mpath):
        raise ValueError(f"{path}: no manifest.json (not a complete "
                         f"checkpoint)")
    with open(mpath) as f:
        manifest = json.load(f)
    sums = manifest.get("checksums", {})
    flat = {}
    for fname in manifest["files"]["params"]:
        shard = os.path.join(path, fname)
        if not os.path.isfile(shard):
            raise ValueError(f"{path}: shard {fname} is missing")
        if verify and fname in sums and _sha256(shard) != sums[fname]:
            raise ValueError(f"{path}: shard {fname} fails its sha256 "
                             f"check (truncated or corrupt)")
        with np.load(shard) as z:
            flat.update({k: z[k] for k in z.files})
    return params_from_numpy(flat, device=device)
