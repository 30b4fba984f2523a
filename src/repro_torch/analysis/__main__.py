"""The CLI: ``python -m repro_torch.analysis``, the reference's
``python -m repro.analysis`` over the port (docs/static-analysis.md).

Runs the four passes, matches findings against the checked-in baseline
(``tools/analysis_baseline_torch.json``), prints text or JSON, and exits
1 when any finding is not baselined (stale baseline entries count as
findings too, so the baseline cannot rot).

    PYTHONPATH=src python -m repro_torch.analysis                 # text
    PYTHONPATH=src python -m repro_torch.analysis --format json   # CI
    PYTHONPATH=src python -m repro_torch.analysis --passes schedlint
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis import (Baseline, Finding, PASSES, repo_root,
                                  run_passes)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="device-free static analysis of the PyTorch port")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the checkout this package "
                         "was imported from)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON (default: "
                         "tools/analysis_baseline_torch.json under --root; "
                         "'none' disables)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root or repo_root())
    if args.baseline == "none":
        baseline = Baseline([])
    else:
        baseline = Baseline.load(
            args.baseline
            or os.path.join(root, "tools", "analysis_baseline_torch.json"))

    results = run_passes(root, [p for p in args.passes.split(",") if p])
    all_findings: List[Finding] = [f for r in results for f in r.findings]
    new, accepted, stale = baseline.split(all_findings)
    new += stale

    report = {
        "root": root,
        "passes": {
            r.name: {"findings": len(r.findings), "stats": r.stats}
            for r in results},
        "findings": [
            dict(f.to_dict(), baselined=baseline.match(f) is not None)
            for f in all_findings] + [
            dict(f.to_dict(), baselined=False) for f in stale],
        "summary": {"total": len(all_findings) + len(stale),
                    "new": len(new), "baselined": len(accepted),
                    "stale_baseline": len(stale)},
        "exit_code": 1 if new else 0,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.format == "json":
        json.dump(report, sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        for r in results:
            stats = " ".join(f"{k}={v}" for k, v in sorted(
                r.stats.items()))
            print(f"[{r.name}] {len(r.findings)} finding(s); {stats}")
        for f in new:
            print(f.render())
        for f in accepted:
            e = baseline.match(f)
            print(f"{f.render()}  (baselined: {e['justification']})")
        s = report["summary"]
        print(f"{s['total']} finding(s): {s['new']} new, "
              f"{s['baselined']} baselined, {s['stale_baseline']} stale "
              f"baseline entr{'y' if s['stale_baseline'] == 1 else 'ies'}")
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
