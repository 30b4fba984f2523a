"""Convention lint over the port (port of
``repro/analysis/conventions.py``): repo invariants the other passes
don't own.

  * CONV001 — unit-suffix discipline in the port's ``core/costmodel.py``
    and its ``calib`` stack (overlay / fit / microbench) and
    ``serve/placement.py``.  The cost model's names carry units
    (``latency_s``, ``bytes_total``, ``mem_gb``, ``effective_gbps``);
    adding or subtracting two quantities with *different* known units
    without a conversion is a sign error waiting to happen.  A small
    abstract interpreter infers a unit for every expression: suffixed
    names are their unit, multiplying by a unitless factor keeps the
    unit, and any division or unit x unit product counts as a conversion
    (result unknown) — only an Add/Sub of two *known, different* units
    is flagged, so ``bytes / gbps + latency_s`` stays legal and
    ``bytes + latency_s`` does not.
  * CONV002 — overbroad ``except`` that swallows, in ``src/repro_torch/``
    and ``chip_smoke.py``: a bare / ``Exception`` / ``BaseException``
    handler that never re-raises and just passes or returns ``None``
    (the probe bug class, where a swallowed error was indistinguishable
    from an infeasible plan).  Handlers that re-raise, or that report
    and continue, are fine.
  * CONV003 — registry reachability: every key of the port's
    ``TECHNIQUE_SPECS`` must appear in the docs (README/DESIGN/docs/*.md)
    and in the port's tests (``tests/test_torch_*.py``); an undocumented
    or untested technique is unreachable to users.

``check_units`` and ``check_excepts`` are the reference's, unchanged.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import Finding, PassResult

#: name suffix -> unit token (also ``bytes_*`` prefixes, see _unit_of)
UNIT_SUFFIXES = {"_s": "s", "_ms": "ms", "_bytes": "bytes", "_gb": "gb",
                 "_gbps": "gbps", "_tflops": "tflops"}
NONE, UNKNOWN = "", "?"

#: files under the CONV001 unit-algebra lint: the cost model and the
#: calibration stack that prices against it (overlay rates, fitter
#: design rows, micro-bench timings — all carry unit-suffixed names),
#: plus the serving placement pass built on those prices
_COST_RELS = (
    os.path.join("src", "repro_torch", "core", "costmodel.py"),
    os.path.join("src", "repro_torch", "calib", "overlay.py"),
    os.path.join("src", "repro_torch", "calib", "fit.py"),
    os.path.join("src", "repro_torch", "calib", "microbench.py"),
    os.path.join("src", "repro_torch", "serve", "placement.py"),
)
#: CONV002's files: the port's package and the script that drives it on
#: the card
_EXCEPT_DIR = os.path.join("src", "repro_torch")
_EXCEPT_FILES = ("chip_smoke.py",)
_COST_FILE = "src/repro_torch/core/costmodel.py"


def _unit_of_name(name: str) -> str:
    for suf, unit in UNIT_SUFFIXES.items():
        if name.endswith(suf):
            return unit
    if name.startswith("bytes_") or name == "bytes":
        return "bytes"
    return NONE


def _expr_unit(node: ast.AST, problems: List[Tuple[int, str]]) -> str:
    """Unit of an expression: '' unitless, '?' unknown/converted, or a
    unit token.  Appends (lineno, message) for mixed Add/Sub."""
    if isinstance(node, ast.Constant):
        return NONE
    if isinstance(node, ast.Name):
        return _unit_of_name(node.id)
    if isinstance(node, ast.Attribute):
        return _unit_of_name(node.attr)
    if isinstance(node, ast.UnaryOp):
        return _expr_unit(node.operand, problems)
    if isinstance(node, ast.BinOp):
        lu = _expr_unit(node.left, problems)
        ru = _expr_unit(node.right, problems)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if lu not in (NONE, UNKNOWN) and ru not in (NONE, UNKNOWN) \
                    and lu != ru:
                op = "+" if isinstance(node.op, ast.Add) else "-"
                problems.append((
                    node.lineno,
                    f"mixes units: [{lu}] {op} [{ru}] without a "
                    f"conversion"))
                return UNKNOWN
            if lu == ru:
                return lu
            return lu if ru == NONE else ru if lu == NONE else UNKNOWN
        if isinstance(node.op, ast.Mult):
            if lu == NONE:
                return ru
            if ru == NONE:
                return lu
            return UNKNOWN               # unit x unit: a conversion
        # Div / Pow / Mod / FloorDiv: always a conversion
        if lu == NONE and ru == NONE:
            return NONE
        return UNKNOWN
    if isinstance(node, (ast.Call, ast.Subscript, ast.IfExp)):
        return UNKNOWN
    return UNKNOWN


def check_units(tree: ast.AST) -> List[Tuple[int, str]]:
    """CONV001 core: all mixed-unit Add/Sub sites in a module AST."""
    problems: List[Tuple[int, str]] = []
    seen = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and id(node) not in seen:
            for sub in ast.walk(node):
                seen.add(id(sub))
            _expr_unit(node, problems)
    return problems


_BROAD = ("Exception", "BaseException")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Attribute):
        return t.attr in _BROAD
    if isinstance(t, ast.Tuple):
        return any(_is_broad(ast.ExceptHandler(type=e))
                   for e in t.elts)
    return False


def _swallows(handler: ast.ExceptHandler) -> Optional[str]:
    """Why this handler swallows, or None if it doesn't."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return None
    body = handler.body
    if all(isinstance(s, ast.Pass) for s in body):
        return "the handler is just `pass`"
    for node in ast.walk(handler):
        if isinstance(node, ast.Return):
            if node.value is None or (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is None):
                return "the handler returns None"
    return None


def check_excepts(tree: ast.AST) -> List[Tuple[int, str]]:
    """CONV002 core: swallowing broad handlers in a module AST."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and _is_broad(node):
            why = _swallows(node)
            if why:
                name = "bare except" if node.type is None else \
                    "except " + ast.dump(node.type) if not isinstance(
                        node.type, ast.Name) else f"except {node.type.id}"
                out.append((node.lineno,
                            f"{name} swallows the error: {why} — an "
                            f"error becomes indistinguishable from a "
                            f"legitimate None"))
    return out


def _iter_py(root: str, rel_dir: str):
    base = os.path.join(root, rel_dir)
    for dirpath, _, files in os.walk(base):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                yield path, os.path.relpath(path, root).replace(
                    os.sep, "/")


def _except_targets(root: str):
    """(path, repo-relative path) of every file CONV002 reads."""
    yield from _iter_py(root, _EXCEPT_DIR)
    for rel in _EXCEPT_FILES:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            yield path, rel


def check_reachability(root: str) -> List[Finding]:
    """CONV003: every registered technique appears in docs and the
    port's tests."""
    from repro_torch.core.costmodel import TECHNIQUE_SPECS
    doc_files = [os.path.join(root, "README.md"),
                 os.path.join(root, "DESIGN.md")]
    docs_dir = os.path.join(root, "docs")
    if os.path.isdir(docs_dir):
        doc_files += [os.path.join(docs_dir, f)
                      for f in sorted(os.listdir(docs_dir))
                      if f.endswith(".md")]
    doc_text = ""
    for p in doc_files:
        if os.path.exists(p):
            with open(p) as f:
                doc_text += f.read()
    test_text = ""
    for path, rel in _iter_py(root, "tests"):
        if os.path.basename(rel).startswith("test_torch_"):
            with open(path) as f:
                test_text += f.read()
    out = []
    for tech in sorted(TECHNIQUE_SPECS):
        missing = [w for w, text in (("docs", doc_text),
                                     ("tests", test_text))
                   if tech not in text]
        if missing:
            out.append(Finding(
                "CONV003", "error", _COST_FILE, 1,
                f"technique {tech!r} is registered but unreachable "
                f"from {' and '.join(missing)}"))
    return out


def run(root: str) -> PassResult:
    res = PassResult("conventions")
    # CONV001: the unit algebra of the cost model + calibration stack
    n_exprs = 0
    for rel in _COST_RELS:
        cost_path = os.path.join(root, rel)
        if not os.path.exists(cost_path):
            continue
        with open(cost_path) as f:
            tree = ast.parse(f.read(), filename=cost_path)
        n_exprs += sum(isinstance(n, ast.BinOp) for n in ast.walk(tree))
        for lineno, msg in check_units(tree):
            res.findings.append(Finding(
                "CONV001", "error", rel.replace(os.sep, "/"),
                lineno, msg))
    # CONV002: swallowing handlers in the port and chip_smoke.py
    n_handlers = 0
    for path, rel in _except_targets(root):
        with open(path) as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        n_handlers += sum(isinstance(n, ast.ExceptHandler)
                          for n in ast.walk(tree))
        for lineno, msg in check_excepts(tree):
            res.findings.append(Finding("CONV002", "error", rel,
                                        lineno, msg))
    res.findings.extend(check_reachability(root))
    from repro_torch.core.costmodel import TECHNIQUE_SPECS
    res.stats = {"binops_checked": n_exprs,
                 "handlers_checked": n_handlers,
                 "techniques_checked": len(TECHNIQUE_SPECS)}
    return res
