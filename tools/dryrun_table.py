"""The dry run over every architecture × input shape on the 16 x 16
production mesh under the default plans (shard_zero for training, shard
for serving), one ``python -m repro_torch.launch.dryrun`` process a
combination, a few at a time, on the host (no card).  Prints a markdown
table: each row ``ok`` with its roofline terms, peak and trace seconds,
``skip`` (the reference's own skips) or ``fail`` (the error the port's
step raised).  Every figure is
predicted from the H100 data sheet's constants.

    python tools/dryrun_table.py [--jobs 3] [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def run(arch: str, shape: str, out_dir: str, multi_pod: bool):
    out = os.path.join(out_dir, f"{arch}-{shape}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--json-out", out] + (
        ["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if not os.path.exists(out):
        raise RuntimeError(f"{arch} x {shape}: exit {proc.returncode}, no "
                           f"record\n{proc.stdout[-2000:]}"
                           f"{proc.stderr[-4000:]}")
    with open(out) as f:
        rec = json.load(f)
    if (rec["status"] == "fail") != (proc.returncode != 0):
        raise RuntimeError(f"{arch} x {shape}: exit {proc.returncode} with "
                           f"status {rec['status']}")
    return rec, wall


def row(rec, wall) -> str:
    head = f"| {rec['arch']} | {rec['shape']} | {rec['plan']} | " \
           f"{rec['status']} |"
    if rec["status"] != "ok":
        return head + f" {rec.get('reason') or rec['error']} ||||||"
    return head + (
        f" {rec['dominant']} | {rec['compute_s'] * 1e3:.3f} | "
        f"{rec['memory_s'] * 1e3:.3f} | {rec['collective_s'] * 1e3:.3f} | "
        f"{rec['memory_per_device_bytes'] / 1e9:.2f} | "
        f"{'yes' if rec['fits_hbm'] else 'no'} | {rec['trace_s']:.1f} "
        f"({wall:.0f}) |")


def main() -> int:
    from repro_torch.configs import ARCH_CONFIGS, INPUT_SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for each run's JSON (default: a "
                         "temporary one)")
    args = ap.parse_args()
    out_dir = args.out or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    combos = [(a, s) for a in ARCH_CONFIGS for s in INPUT_SHAPES]
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(
            lambda c: run(*c, out_dir, args.multi_pod), combos))
    print("| arch | shape | plan | status | dominant | compute ms | "
          "memory ms | collective ms | peak GB | fits 80 GB | trace s "
          "(process s) |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for rec, wall in results:
        print(row(rec, wall))
    return 0


if __name__ == "__main__":
    sys.exit(main())
