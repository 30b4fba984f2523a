"""Checkpoints in the reference's on-disk format (port of
``repro/train/checkpoint.py``), so either package restores what the
other wrote: params and optimizer state as npz shards keyed by the
``/``-joined tree paths (``params/...`` files hold ``embed/table``, ...;
``opt`` files hold ``step``, ``m/...`` and ``v/...``), and a
``manifest.json`` with each shard's sha256.

Durability contract, the reference's:

  * saves are atomic: shards and manifest go to ``step_XXXXXXXX.tmp``,
    the manifest is fsynced, and the directory is renamed into place
    last, so ``latest_checkpoint`` never returns a partial save;
  * every shard's sha256 is checked on restore, so a truncated or
    corrupt shard raises instead of resuming from garbage;
  * restore refuses a dtype change unless ``allow_cast=True``.

Tensors go to the host as numpy arrays; numpy has no bfloat16, so the
port checkpoints its fp32 masters and int32 step (bf16 leaves raise).
The shards are written, hashed and read in threads, one a file, and
each member, stored uncompressed by ``np.savez``, is read straight into
its array (``_read_npz``): a gpt2m checkpoint is 4.26 GB.
Under a plan ``train/loop.py`` gathers the params and moments into the
one-device layout first (a pipeline's stages included), and rank 0
writes them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested mappings and NamedTuples -> {"a/b/c": leaf}, keyed as the
    reference's tree paths are (dict keys, NamedTuple field names)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten_like(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_like(v, flat, f"{prefix}/{k}"
                                            if prefix else k)
                            for k, v in zip(like._fields, like)))
    return flat[prefix]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state=None, *,
                    n_files: int = 4, extra: Optional[Dict] = None) -> str:
    """Atomically write one checkpoint directory; returns its path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.isdir(tmp):                   # stale staging from a crash
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    manifest: Dict[str, Any] = {"step": step, "files": {},
                                "checksums": {}, "extra": extra or {}}
    jobs = []
    for name, tree in trees.items():
        flat = {k: v.detach().cpu().numpy()
                for k, v in flatten(tree).items()}
        keys = sorted(flat)
        shards = [keys[i::n_files] for i in range(n_files)]
        for i, ks in enumerate(shards):
            if not ks:
                continue
            fname = f"{name}_{i:02d}.npz"
            manifest["files"].setdefault(name, []).append(fname)
            jobs.append((fname, {k: flat[k] for k in ks}))

    def write(job) -> str:
        fname, arrays = job
        np.savez(os.path.join(tmp, fname), **arrays)
        return sha256(os.path.join(tmp, fname))

    with ThreadPoolExecutor(max_workers=len(jobs) or 1) as pool:
        for (fname, _), digest in zip(jobs, pool.map(write, jobs)):
            manifest["checksums"][fname] = digest
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(path):                  # re-saving the same step
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _complete(ckpt_dir: str, d: str) -> bool:
    return not d.endswith(".tmp") and \
        os.path.isfile(os.path.join(ckpt_dir, d, "manifest.json"))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest complete checkpoint: ``.tmp`` staging directories and
    directories without a manifest are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and _complete(ckpt_dir, d))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Integrity-check a checkpoint directory and return its manifest.

    Raises:
        ValueError: no manifest (a partial save), a listed shard is
            missing, or a shard's sha256 disagrees with the manifest.
            Manifests without checksums verify that shards exist only.
    """
    mpath = os.path.join(path, "manifest.json")
    if not os.path.isfile(mpath):
        raise ValueError(f"{path}: no manifest.json — incomplete "
                         f"checkpoint (crashed mid-save?)")
    with open(mpath) as f:
        manifest = json.load(f)
    sums = manifest.get("checksums", {})
    fnames = [f for fs in manifest.get("files", {}).values() for f in fs]
    for fname in fnames:
        if not os.path.isfile(os.path.join(path, fname)):
            raise ValueError(f"{path}: shard {fname} listed in the "
                             f"manifest is missing")
    checked = [f for f in fnames if sums.get(f) is not None]
    with ThreadPoolExecutor(max_workers=len(checked) or 1) as pool:
        got = pool.map(lambda f: sha256(os.path.join(path, f)), checked)
        for fname, digest in zip(checked, got):
            if digest != sums[fname]:
                raise ValueError(f"{path}: shard {fname} fails its "
                                 f"sha256 check — truncated or corrupt")
    return manifest


def load_manifest(path: str, *, verify: bool = True) -> Dict[str, Any]:
    """The manifest of a checkpoint directory, integrity-checked first
    (``verify_checkpoint``) unless ``verify`` is False."""
    if verify:
        return verify_checkpoint(path)
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _read_member(f, info: zipfile.ZipInfo) -> np.ndarray:
    """One ``.npy`` member of an open zip file, stored uncompressed as
    ``np.savez`` writes it (C order, no objects, a version 1 or 2
    header), read by one ``readinto`` into a new array.

    Raises:
        ValueError: a compressed member, another layout, or a truncated
            or corrupt one.
    """
    where = f"{f.name}: member {info.filename}"
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{where} is compressed; checkpoints are written "
                         f"by np.savez, uncompressed")
    f.seek(info.header_offset)
    head = f.read(30)
    if head[:4] != b"PK\x03\x04":
        raise ValueError(f"{where} has no local zip header — truncated or "
                         f"corrupt")
    n, m = struct.unpack("<HH", head[26:30])
    f.seek(info.header_offset + 30 + n + m)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"{where} has an .npy header of version "
                         f"{version}, not one np.savez writes here")
    if fortran or dtype.hasobject:
        raise ValueError(f"{where} is in Fortran order or holds objects; "
                         f"checkpoints hold C-order numbers")
    arr = np.empty(shape, dtype)
    if arr.nbytes and f.readinto(arr.reshape(-1).view(np.uint8)) \
            != arr.nbytes:
        raise ValueError(f"{where} is truncated")
    return arr


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of one ``.npz`` shard, by key, each member read
    straight into its array (``np.load`` takes a member through
    ``zipfile`` 256 KiB at a time: several times slower,
    ``launch/checkpoint_io.py``)."""
    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
    with open(path, "rb") as f:
        return {info.filename[:-4] if info.filename.endswith(".npy")
                else info.filename: _read_member(f, info) for info in infos}


def read_flat(path: str, manifest: Dict[str, Any], name: str
              ) -> Dict[str, np.ndarray]:
    """Every array of the ``name`` shards ("params" or "opt"), by key,
    the shards read in threads."""
    fnames = manifest["files"].get(name, [])
    flat: Dict[str, np.ndarray] = {}
    with ThreadPoolExecutor(max_workers=len(fnames) or 1) as pool:
        for arrays in pool.map(lambda f: _read_npz(os.path.join(path, f)),
                               fnames):
            flat.update(arrays)
    return flat


def _load(path, flat, name, like, allow_cast: bool):
    out = {}
    for key, leaf in flatten(like).items():
        if key not in flat:
            raise ValueError(f"{name}/{key}: not in checkpoint {path}")
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(arr if arr.flags.writeable else np.array(arr))
        if t.dtype != leaf.dtype and not allow_cast:
            raise ValueError(
                f"{key}: checkpoint dtype {t.dtype} != template "
                f"{leaf.dtype}; a silent cast would lose master-weight "
                f"precision — pass allow_cast=True to convert deliberately")
        out[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _unflatten_like(like, out)


def restore_checkpoint(path: str, params_like, opt_like=None, *,
                       allow_cast: bool = False, verify: bool = True
                       ) -> Tuple[Any, Any, int]:
    """Restore onto templates (trees of tensors fixing structure, shapes,
    dtypes and devices).  Returns (params, opt_state or None, step).

    Raises:
        ValueError: integrity failure, a missing key, a shape mismatch,
            or (without ``allow_cast``) a dtype mismatch.
    """
    manifest = load_manifest(path, verify=verify)
    params = _load(path, read_flat(path, manifest, "params"), "params",
                   params_like, allow_cast)
    opt = None
    if opt_like is not None and "opt" in manifest["files"]:
        opt = _load(path, read_flat(path, manifest, "opt"), "opt", opt_like,
                    allow_cast)
    return params, opt, manifest["step"]
