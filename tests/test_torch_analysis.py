"""repro_torch.analysis against the reference's repro.analysis: the four
passes over the port stay clean on the tree, agree with the reference
where they read the same things (the schedule grid, the plan search,
the unit and handler rules), and fire on seeded violations.  The torch
donation fixtures under tests/torch_analysis_fixtures/ reproduce the
``reshard_check`` bug in the port's form (a control run handed the
tensors a ``donate=True`` run overwrote) and its fix.
"""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import RULES as JRULES
from repro.analysis import conventions as jconventions
from repro.analysis import planlint as jplanlint
from repro.analysis import schedlint as jschedlint
from repro.core.costmodel import TECHNIQUE_SPECS as JSPECS
from repro.core.pipeline import schedule_tables as jtables
from repro.core.plans import MeshSpec as JMeshSpec
from repro_torch.analysis import (Baseline, Finding, PASSES, RULES,
                                  repo_root)
from repro_torch.analysis import conventions, donatecheck, planlint, schedlint
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core.costmodel import TECHNIQUE_SPECS
from repro_torch.core.pipeline import schedule_tables
from repro_torch.core.plans import PLANS, MeshSpec

ROOT = repo_root()
FIXTURES = os.path.join("tests", "torch_analysis_fixtures")
CONV_BAD = os.path.join(ROOT, "tests", "analysis_fixtures", "conv_bad.py")
COST_FILES = ("core/costmodel.py", "calib/overlay.py", "calib/fit.py",
              "calib/microbench.py", "serve/placement.py")


def rules_of(problems):
    """{rule, ...} from (rule, msg) pairs or Finding lists."""
    return {p[0] if isinstance(p, tuple) else p.rule for p in problems}


def test_rules_and_passes_are_the_references():
    assert set(RULES) == set(JRULES)
    assert set(PASSES) == {"planlint", "schedlint", "donatecheck",
                           "conventions"}


# ---------------------------------------------------------------- schedlint

def test_schedlint_equals_reference_over_the_grid():
    got, want = schedlint.run(ROOT), jschedlint.run(ROOT)
    assert got.findings == [] and want.findings == []
    assert got.stats == want.stats
    assert got.stats["cells_checked"] == 128
    assert (schedlint.GRID_SCHEDULES, list(schedlint.GRID_S),
            list(schedlint.GRID_M)) == (jschedlint.GRID_SCHEDULES,
                                        list(jschedlint.GRID_S),
                                        list(jschedlint.GRID_M))


def _drop_arrival(t):
    live = np.argwhere(t["arr_valid"])
    s, tick = live[len(live) // 2]
    t["arr_valid"][s, tick] = False


def _mislabel(t):
    s, tick = np.argwhere(t["arr_valid"])[0]
    t["arr_chunk"][s, tick] += 1


def _drop_run(t):
    assert t["active"][2, 2]
    t["active"][2, 2] = False


def _out_of_range(t):
    assert t["active"][0, 0]
    t["mb"][0, 0] = 9


def _double_run(t):
    assert t["active"][0, 1]
    t["mb"][0, 1] = 0


def _pad(t):
    for k in t:
        t[k] = np.concatenate(
            [t[k], np.zeros((t[k].shape[0], 1), t[k].dtype)], axis=1)


# the reference's corruptions (tests/test_analysis.py): (schedule, S, m,
# mutation, rules of which one must fire)
CORRUPTIONS = {
    "dropped-arrival": ("gpipe", 3, 4, _drop_arrival,
                        {"SCHED003", "SCHED004"}),
    "mislabeled-chunk": ("interleaved2", 2, 3, _mislabel, {"SCHED004"}),
    "dropped-run": ("1f1b", 4, 4, _drop_run, {"SCHED001"}),
    "out-of-range": ("gpipe", 2, 2, _out_of_range, {"SCHED002"}),
    "double-run": ("gpipe", 2, 3, _double_run, {"SCHED001"}),
    "tick-formula": ("gpipe", 2, 4, _pad, {"SCHED005"}),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_schedlint_corruption_fires_the_same_rules_in_both(case):
    sched, S, m, mutate, rules = CORRUPTIONS[case]
    got = {}
    for name, tables, check in (
            ("port", schedule_tables, schedlint.check_tables),
            ("reference", jtables, jschedlint.check_tables)):
        t = {k: v.copy() for k, v in tables(sched, S, m).items()}
        mutate(t)
        got[name] = check(t, sched, S, m)
    assert got["port"] == got["reference"]
    assert rules_of(got["port"]) & rules


# ----------------------------------------------------------------- planlint

@pytest.fixture(scope="module")
def planlint_runs():
    return planlint.run(ROOT), jplanlint.run(ROOT)


def test_planlint_stats_equal_reference(planlint_runs):
    got, want = planlint_runs
    assert got.findings == [] and want.findings == []
    assert got.stats == want.stats
    assert got.stats["candidates"] > 100


def test_plan_registry_drift_fires_both_ways_in_both():
    for check in (planlint.check_registry, jplanlint.check_registry):
        assert check(["dp", "pp"], ["dp", "pp"]) == []
        assert [d for _, d, _ in check(["dp", "pp"], ["dp"])] == \
            ["priced-only"]
        assert [d for _, d, _ in check(["dp"], ["dp", "pp"])] == \
            ["executable-only"]
    assert planlint.check_registry(sorted(TECHNIQUE_SPECS),
                                   sorted(PLANS)) == []


# (spec entries, leaf shape, the words of the problem or None)
SPEC_CASES = {
    "clean": ((("data", "model")), (8, 16), None),
    "clean-joint": (((None, ("data", "model"))), (8, 16), None),
    "unknown-axis": ((("tensor",)), (8, 16), "names axis"),
    "reused-axis": ((("data", "data")), (8, 16), "reuses"),
    "non-divisible": ((("data",)), (7, 16), "not divisible"),
    "more-entries": ((("data", None, "model")), (8,), "more entries"),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_check_specs_fires_as_reference(case):
    entries, shape, words = SPEC_CASES[case]
    got = planlint.check_specs(
        {"w": torch.empty(shape, device="meta")}, {"w": tuple(entries)},
        MeshSpec.of((2, 2), ("data", "model")), "t")
    want = jplanlint.check_specs(
        {"w": jax.ShapeDtypeStruct(shape, jnp.float32)}, {"w": P(*entries)},
        JMeshSpec.of((2, 2), ("data", "model")), "t")
    assert len(got) == len(want)
    if words is None:
        assert got == []
    else:
        assert any(words in p for p in got) and any(words in p for p in want)


def test_check_specs_counts_leaves_and_specs():
    mesh = MeshSpec.of((2, 2), ("data", "model"))
    shapes = {"w": torch.empty((8,), device="meta"),
              "b": torch.empty((2,), device="meta")}
    assert any("leaves but" in p
               for p in planlint.check_specs(shapes, {"w": ()}, mesh, "t"))
    assert any("non-spec leaf" in p for p in planlint.check_specs(
        {"w": shapes["w"]}, {"w": "data"}, mesh, "t"))


# -------------------------------------------------------------- conventions

def _both_on(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return ((conventions.check_units(tree), conventions.check_excepts(tree)),
            (jconventions.check_units(tree),
             jconventions.check_excepts(tree)))


def test_conventions_fire_as_reference_on_the_seeded_file():
    got, want = _both_on(CONV_BAD)
    assert got == want
    assert {line for line, _ in got[0]} == {10, 12}    # s+bytes, ms-gbps
    assert {line for line, _ in got[1]} == {22, 29}    # return None / pass


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
@pytest.mark.parametrize("rel", COST_FILES)
def test_conventions_equal_reference_on_the_cost_files(pkg, rel):
    got, want = _both_on(os.path.join(ROOT, "src", pkg, rel))
    assert got == want == ([], [])


def test_conventions_cover_the_port():
    res = conventions.run(ROOT)
    assert res.findings == [], [f.render() for f in res.findings]
    assert res.stats["techniques_checked"] == len(TECHNIQUE_SPECS) \
        == len(JSPECS)
    assert res.stats["binops_checked"] == \
        jconventions.run(ROOT).stats["binops_checked"]


def test_conventions_read_the_port_and_chip_smoke(tmp_path):
    """CONV002 reads src/repro_torch/ and chip_smoke.py (not the
    reference); CONV003 the port's tests only."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro").mkdir()
    bad = "def f():\n    try:\n        g()\n    except Exception:\n" \
          "        pass\n"
    for rel in ("src/repro_torch/a.py", "src/repro/b.py", "chip_smoke.py"):
        (tmp_path / rel).write_text(bad)
    hits = [f for f in conventions.run(str(tmp_path)).findings
            if f.rule == "CONV002"]
    assert sorted(f.file for f in hits) == ["chip_smoke.py",
                                            "src/repro_torch/a.py"]
    (tmp_path / "tests").mkdir()
    (tmp_path / "README.md").write_text(" ".join(TECHNIQUE_SPECS))
    (tmp_path / "tests" / "test_x.py").write_text(repr(list(
        TECHNIQUE_SPECS)))
    missing = conventions.check_reachability(str(tmp_path))
    assert len(missing) == len(TECHNIQUE_SPECS)
    (tmp_path / "tests" / "test_torch_x.py").write_text(repr(list(
        TECHNIQUE_SPECS)))
    assert conventions.check_reachability(str(tmp_path)) == []


# -------------------------------------------------------------- donatecheck

@pytest.fixture(scope="module")
def fixture_findings():
    findings, stats = donatecheck.analyze(ROOT, targets=(FIXTURES,))
    assert stats["donating_factories"] >= 1
    assert stats["donating_wrappers"] >= 1
    return findings


def _hits(findings, rule, line, fixture="donate_bad"):
    return [f for f in findings
            if f.rule == rule and f.line == line and fixture in f.file]


def test_donatecheck_reproduces_the_reshard_bug(fixture_findings):
    """donate_bad.run_place: the control run reads the params and moments
    the resharded run's train(..., donate=True) overwrote."""
    hits = _hits(fixture_findings, "DON001", 45)
    assert len(hits) == 2, [f.render() for f in fixture_findings]
    assert all("train()" in f.message and "line 42" in f.message
               for f in hits)


def test_donatecheck_loop_without_rebind_fires(fixture_findings):
    hits = _hits(fixture_findings, "DON001", 53)
    assert len(hits) == 2 and all("loop" in f.message for f in hits)


def test_donatecheck_double_slot_fires(fixture_findings):
    assert len(_hits(fixture_findings, "DON002", 60)) == 1


def test_donatecheck_non_literal_flag_fires(fixture_findings):
    hits = _hits(fixture_findings, "DON003", 65)
    assert len(hits) == 1 and hits[0].severity == "warning"


def test_donatecheck_to_and_detach_alias(fixture_findings):
    hits = _hits(fixture_findings, "DON001", 74)
    assert sorted(f.message.split("'")[1] for f in hits) == [
        "opt_state", "params"]
    assert len(_hits(fixture_findings, "DON001", 82)) == 1   # tree_map


def test_donatecheck_fixed_code_passes(fixture_findings):
    """The twin that clones, deep-copies, rebinds in its loop and passes
    its own flag through is clean; nothing else in the bad file fires."""
    assert [f for f in fixture_findings if "donate_good" in f.file] == []
    assert len(fixture_findings) == 9


def test_donatecheck_finds_the_ports_donating_callables():
    """On the tree: adamw_update writes in place under its flag,
    build_train_step and the step classes return donating callables,
    train passes its flag through; no finding."""
    reg = donatecheck.build_registry(
        donatecheck._load_modules(ROOT, donatecheck.TARGETS))
    w = reg.wrappers
    assert w["repro_torch.optim.adamw.adamw_update"].argnames == (
        "state", "params")
    assert w["repro_torch.train.loop.train"].argnames == (
        "params", "opt_state")
    for name in ("build_train_step", "PlanStep", "PipelineStep"):
        sig = reg.factories[f"repro_torch.core.steps.{name}"][None]
        assert sig.argnums == (0, 1) and sig.cond == donatecheck.ARG


# ----------------------------------------------------- baseline + CLI

def _f(rule="DON001", file="src/x.py", msg="tree 'p' reused"):
    return Finding(rule, "error", file, 1, msg)


def test_baseline_split_new_accepted_stale():
    b = Baseline([
        {"rule": "DON001", "file": "src/x.py", "match": "reused",
         "justification": "known"},
        {"rule": "CONV001", "file": "src/y.py", "match": "never",
         "justification": "stale"},
    ], path="tools/analysis_baseline_torch.json")
    new, accepted, stale = b.split([_f(), _f(file="src/z.py")])
    assert [f.file for f in new] == ["src/z.py"]
    assert [f.file for f in accepted] == ["src/x.py"]
    assert [f.rule for f in stale] == ["BASE001"]
    assert "CONV001" in stale[0].message


def test_baseline_load_rejects_incomplete_entries(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps(
        {"accepted": [{"rule": "DON001", "file": "src/x.py"}]}))
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(str(p))
    p.write_text(json.dumps({"accepted": []}))
    assert Baseline.load(str(p)).entries == []
    assert Baseline.load(str(tmp_path / "missing.json")).entries == []


def test_checked_in_baseline_is_empty():
    b = Baseline.load(os.path.join(ROOT, "tools",
                                   "analysis_baseline_torch.json"))
    assert b.entries == []


SEEDED_BUG = '''\
def adamw_update(params, grads, *, donate=False):
    if donate:
        params.copy_(params - grads)
        return params
    return params - grads


def run(params, grads):
    new = adamw_update(params, grads, donate=True)
    return params, new
'''
BUGGY = "src/repro_torch/buggy.py"


@pytest.fixture()
def seeded_root(tmp_path):
    """A minimal repo root whose port holds one donation bug."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / BUGGY).write_text(SEEDED_BUG)
    (tmp_path / "tools").mkdir()
    return tmp_path


def _baseline(root, justification):
    (root / "tools" / "analysis_baseline_torch.json").write_text(json.dumps(
        {"accepted": [{"rule": "DON001", "file": BUGGY, "match": "donated",
                       "justification": justification}]}))


def test_cli_fails_on_seeded_violation(seeded_root, capsys):
    out = seeded_root / "report.json"
    rc = cli_main(["--root", str(seeded_root), "--passes", "donatecheck",
                   "--format", "json", "--out", str(out)])
    assert rc == 1
    report = json.loads(out.read_text())
    assert report["summary"]["new"] == 1
    assert report["findings"][0]["rule"] == "DON001"
    assert report["findings"][0]["line"] == 10
    assert not report["findings"][0]["baselined"]
    assert json.loads(capsys.readouterr().out)["exit_code"] == 1


def test_cli_baselined_violation_passes(seeded_root, capsys):
    _baseline(seeded_root, "seeded fixture for the CLI test")
    rc = cli_main(["--root", str(seeded_root), "--passes", "donatecheck"])
    assert rc == 0
    assert "baselined: seeded fixture" in capsys.readouterr().out


def test_cli_stale_baseline_entry_fails(seeded_root, capsys):
    (seeded_root / BUGGY).write_text("x = 1\n")
    _baseline(seeded_root, "now stale")
    rc = cli_main(["--root", str(seeded_root), "--passes", "donatecheck"])
    assert rc == 1
    assert "BASE001" in capsys.readouterr().out


def test_cli_baseline_none_ignores_checked_in_file(seeded_root):
    _baseline(seeded_root, "would mask it")
    rc = cli_main(["--root", str(seeded_root), "--passes", "donatecheck",
                   "--baseline", "none", "--format", "json"])
    assert rc == 1


def test_full_cli_is_clean_on_tree(capsys):
    """All four passes over the port, with the checked-in (empty)
    baseline: exit 0."""
    rc = cli_main(["--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0, report["findings"]
    assert report["summary"] == {"total": 0, "new": 0, "baselined": 0,
                                 "stale_baseline": 0}
    assert set(report["passes"]) == set(PASSES)
    assert report["passes"]["planlint"]["stats"]["candidates"] > 100
    dc = report["passes"]["donatecheck"]["stats"]
    assert dc["donating_factories"] >= 2 and dc["donating_wrappers"] >= 2
