"""Checkpoint I/O timing of the port: the seconds a checkpoint of a
model's params and AdamW moments (``train/checkpoint.py``'s format)
takes to write, to verify and to read back on the host, each way
beside the one-shard-after-another way it replaced.

  * write: ``np.savez`` then sha256, one shard after another, against
    ``save_checkpoint`` (the shards in threads, one a file);
  * verify: sha256 one shard after another against
    ``verify_checkpoint`` (threads);
  * read: ``np.load`` one shard after another, ``np.load`` in threads,
    and ``read_flat`` (threads, each stored member read straight into
    its array).

The checkpoints go to a temporary directory (``TMPDIR``), removed at
the end.  The state is random fp32 made from ``--seed`` on the host, shaped as
the architecture's (full size unless ``--reduced``).  The ways alternate
(forward, then backward, ``--repeats`` times), every read is warm (the
files were just written), and the last line is a JSON report with each
way's seconds and GB/s.

    PYTHONPATH=src python -m repro_torch.launch.checkpoint_io \\
        --arch gpt2m --repeats 3
"""
import argparse
import json
import os
import shutil
import statistics
import tempfile
import time


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2m")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (default the full one)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def host_state(arch: str, reduced: bool, seed: int):
    """Random fp32 (params, AdamW state) trees on the host, shaped as the
    architecture's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.optim import AdamWState
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.reshard import state_templates

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    p_like, o_like = state_templates(Model(cfg, device="cpu"))
    g = torch.Generator().manual_seed(seed)

    def fill(t):
        return torch.randn(t.shape, generator=g, dtype=t.dtype)

    return tree_map(fill, p_like), AdamWState(
        step=torch.tensor(7, dtype=torch.int32), m=tree_map(fill, o_like.m),
        v=tree_map(fill, o_like.v))


def write_serial(out_dir: str, params, opt, n_files: int = 4) -> None:
    """``save_checkpoint``'s shards written and hashed one after another
    (no manifest: only the shards' I/O is timed)."""
    import numpy as np

    from repro_torch.train.checkpoint import flatten, sha256
    os.makedirs(out_dir)
    for name, tree in (("params", params), ("opt", opt)):
        flat = {k: v.numpy() for k, v in flatten(tree).items()}
        keys = sorted(flat)
        for i in range(n_files):
            ks = keys[i::n_files]
            if ks:
                path = os.path.join(out_dir, f"{name}_{i:02d}.npz")
                np.savez(path, **{k: flat[k] for k in ks})
                sha256(path)


def _np_load(path: str):
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def read_np_load(path: str, manifest, threads: bool):
    """Every array of the checkpoint by ``np.load``, the shards one after
    another or in threads."""
    from concurrent.futures import ThreadPoolExecutor
    fnames = [os.path.join(path, f) for fs in manifest["files"].values()
              for f in fs]
    flat = {}
    if threads:
        with ThreadPoolExecutor(max_workers=len(fnames)) as pool:
            for arrays in pool.map(_np_load, fnames):
                flat.update(arrays)
    else:
        for f in fnames:
            flat.update(_np_load(f))
    return flat


def read_port(path: str, manifest):
    from repro_torch.train.checkpoint import read_flat
    flat = {}
    for name in manifest["files"]:
        flat.update(read_flat(path, manifest, name))
    return flat


def verify_serial(path: str, manifest) -> None:
    from repro_torch.train.checkpoint import sha256
    for fs in manifest["files"].values():
        for f in fs:
            if sha256(os.path.join(path, f)) != manifest["checksums"][f]:
                raise ValueError(f"{path}/{f}: sha256 disagrees")


def measure(args, root: str):
    import numpy as np

    from repro_torch.train.checkpoint import (load_manifest,
                                              save_checkpoint,
                                              verify_checkpoint)
    params, opt = host_state(args.arch, args.reduced, args.seed)
    path = save_checkpoint(root, 0, params, opt)
    manifest = load_manifest(path)
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for fs in manifest["files"].values() for f in fs)
    want = read_np_load(path, manifest, threads=False)
    for key, arr in read_port(path, manifest).items():
        if not np.array_equal(arr, want[key]):
            raise ValueError(f"{key}: read_flat disagrees with np.load")
    del want

    n = [0]

    def fresh_dir():
        n[0] += 1
        return os.path.join(root, f"serial_{n[0]}")

    ways = {
        "write_serial": lambda: write_serial(fresh_dir(), params, opt),
        "write_threads": lambda: save_checkpoint(root, n[0] + 1000,
                                                 params, opt),
        "verify_serial": lambda: verify_serial(path, manifest),
        "verify_threads": lambda: verify_checkpoint(path),
        "read_np_load_serial": lambda: read_np_load(path, manifest, False),
        "read_np_load_threads": lambda: read_np_load(path, manifest, True),
        "read_flat": lambda: read_port(path, manifest),
    }
    times = {k: [] for k in ways}
    order = list(ways)
    for r in range(args.repeats):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            got = ways[name]()
            times[name].append(time.perf_counter() - t0)
            del got
            if name.startswith("write"):        # keep one checkpoint
                for d in os.listdir(root):
                    if os.path.join(root, d) != path:
                        shutil.rmtree(os.path.join(root, d))
    return {"arch": args.arch, "reduced": args.reduced, "gb": nbytes / 1e9,
            "repeats": args.repeats, "seconds": times,
            "median_s": {k: statistics.median(v) for k, v in times.items()},
            "median_gb_s": {k: nbytes / 1e9 / statistics.median(v)
                            for k, v in times.items()}}


def main(argv=None) -> None:
    args = parse(argv)
    with tempfile.TemporaryDirectory(prefix="ckpt_io_") as root:
        report = measure(args, root)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
