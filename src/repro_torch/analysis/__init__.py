"""Device-free static analysis for the PyTorch port (port of
``repro/analysis``).

Four passes, one CLI (``python -m repro_torch.analysis``), the
reference's structured JSON findings, and a checked-in baseline for
accepted findings (``tools/analysis_baseline_torch.json``):

  * ``planlint``     — traces every (technique x placement x schedule x
    wire_dtype) the cost-model registry can express on meta tensors (the
    model with its kernels on, as ``launch.dryrun`` traces it) and the
    plans' own sharding rules, on a device-free ``MeshSpec``.  No card
    touched.
  * ``schedlint``    — exhaustively verifies ``core.pipeline
    .schedule_tables`` dependency soundness over a
    (schedule x S x m x v) grid.
  * ``donatecheck``  — AST pass flagging reads of a tree after it was
    passed to a call that updates it in place (``donate=True``: the
    ``reshard_check`` bug class, where a restored checkpoint fed a
    donating run and then its control, in the port's form).
  * ``conventions``  — repo-invariant lint: unit-suffix discipline in
    the cost model, no swallowing ``except`` handlers (the probe bug
    class, where a swallowed error read as an infeasible plan), every
    registered technique reachable from docs+tests.

Each pass is a function ``run(root) -> PassResult``; findings carry a
stable rule id, severity, ``file:line`` and a message.  The CLI in
``__main__`` matches findings against the baseline and exits non-zero
when any finding is not baselined (docs/static-analysis.md).  Imports
neither JAX nor the reference's package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Finding", "PassResult", "Baseline", "PASSES", "run_passes",
           "repo_root", "RULES"]

#: rule id -> one-line description (docs/static-analysis.md mirrors this;
#: conventions.CONV003 checks the techniques half of the docs contract).
RULES: Dict[str, str] = {
    "PLAN001": "PLANS / TECHNIQUE_SPECS drift (priced but not "
               "executable, or vice versa)",
    "PLAN002": "plan sharding inconsistent with the mesh (unknown axis, "
               "axis reuse, or non-divisible dimension)",
    "PLAN003": "unpartitionable stage split (validate_stages rejects "
               "the searched placement)",
    "PLAN004": "technique_state_bytes exceeds the site memory envelope "
               "the cost model assumes for a feasible placement",
    "PLAN005": "abstract loss/optimizer trace broken (the meta trace "
               "disagrees with the declared contract)",
    "SCHED001": "schedule table incomplete (an item never runs, runs "
                "twice, or warm-up/drain is cut short)",
    "SCHED002": "slot out of range (chunk/microbatch index invalid for "
                "the stage)",
    "SCHED003": "dependency race (a consume slot without a "
                "strictly-earlier matching produce)",
    "SCHED004": "ring send/receive mismatch (orphan arrival, lost "
                "non-banked send, or clobbered inbox)",
    "SCHED005": "tick-count formula violated for the schedule",
    "DON001": "donated tree read after the call that updates it in "
              "place (donate=True)",
    "DON002": "same tree passed to a donated and a non-donated "
              "argument of one call",
    "DON003": "donate= not statically checkable (non-literal, not a "
              "wrapper's pass-through)",
    "CONV001": "unit-suffix mixing (_s/_bytes/_gb added without a "
               "conversion)",
    "CONV002": "overbroad except swallows the error and falls through",
    "CONV003": "registered technique unreachable from docs or tests",
    "BASE001": "baseline entry matches no current finding (stale)",
}

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One analysis finding: stable rule id, severity, location, text."""
    rule: str
    severity: str
    file: str          # repo-relative posix path
    line: int
    message: str

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "severity": self.severity,
                "file": self.file, "line": self.line,
                "message": self.message}

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.severity} "
                f"[{self.rule}] {self.message}")


@dataclass
class PassResult:
    """Findings plus what-was-checked counters."""
    name: str
    findings: List[Finding] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)


@dataclass
class Baseline:
    """Accepted findings: list of {rule, file, match, justification}.

    A finding is baselined when an entry's rule and file match exactly
    and ``match`` is a substring of the message.  Entries that match
    nothing are themselves reported (BASE001) so the baseline cannot
    rot.
    """
    entries: List[Dict[str, str]] = field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([], path)
        with open(path) as f:
            data = json.load(f)
        entries = data.get("accepted", [])
        for e in entries:
            for k in ("rule", "file", "match", "justification"):
                if not isinstance(e.get(k), str) or not e[k].strip():
                    raise ValueError(
                        f"baseline entry {e!r} needs non-empty string "
                        f"fields rule/file/match/justification")
        return cls(entries, path)

    def match(self, f: Finding) -> Optional[Dict[str, str]]:
        for e in self.entries:
            if (e["rule"] == f.rule and e["file"] == f.file
                    and e["match"] in f.message):
                return e
        return None

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[Finding]]:
        """(new, accepted, stale-baseline-findings)."""
        new, accepted = [], []
        used: List[int] = []
        for f in findings:
            e = self.match(f)
            if e is None:
                new.append(f)
            else:
                accepted.append(f)
                used.append(self.entries.index(e))
        stale = [
            Finding("BASE001", "error",
                    os.path.relpath(self.path) if self.path else
                    "tools/analysis_baseline_torch.json", 1,
                    f"stale baseline entry {e['rule']} for {e['file']} "
                    f"(match {e['match']!r}) — no current finding "
                    f"matches; delete it")
            for i, e in enumerate(self.entries) if i not in used]
        return new, accepted, stale


def repo_root() -> str:
    """The repo checkout this package was imported from."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _pass_runners() -> Dict[str, Callable[[str], PassResult]]:
    from repro_torch.analysis import (conventions, donatecheck, planlint,
                                      schedlint)
    return {"planlint": planlint.run, "schedlint": schedlint.run,
            "donatecheck": donatecheck.run, "conventions": conventions.run}


#: pass name -> runner, in report order.
PASSES = ("planlint", "schedlint", "donatecheck", "conventions")


def run_passes(root: Optional[str] = None,
               passes: Optional[List[str]] = None) -> List[PassResult]:
    root = root or repo_root()
    runners = _pass_runners()
    out = []
    for name in passes or PASSES:
        if name not in runners:
            raise KeyError(f"unknown pass {name!r}; have {sorted(runners)}")
        out.append(runners[name](root))
    return out
