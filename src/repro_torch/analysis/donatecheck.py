"""Donation-aliasing checker over the port (port of
``repro/analysis/donatecheck.py``): flags reads of a tree after it was
passed to a call that updates it in place.

Torch has no ``donate_argnums``.  The port's form of the same bug class
is ``donate=True``: ``optim.adamw_update`` writes the new params and
moments into the trees it was given (``p.copy_``), and
``core.steps.build_train_step`` and ``train.loop.train`` pass that flag
through.  The reference's ``reshard_check`` bug — a restored checkpoint
passed to ``train(..., donate=True)`` and then read as the control
run's state — reads values the first run overwrote.

An AST pass over ``src/repro_torch/`` and ``chip_smoke.py`` (no imports,
no execution) with the reference's three layers:

  1. **Donating callables** — a function with a ``donate`` formal whose
     body (or a function nested in it) writes in place (a method
     ``x.name_(...)``, such as ``copy_``) into a tree one of its formals
     reaches, through aliases, attributes, subscripts and calls of the
     nested functions: those formals are donated when it is called with
     ``donate=True``.  And *donating factories*: functions that return
     a donating callable (a nested ``def``, a variable bound to one, a
     class whose ``__call__`` donates, possibly inside a tuple), e.g.
     ``core.steps.build_train_step``; callers that bind the result
     inherit its donation signature.
  2. **Donating wrappers** — a function that passes one of its own
     formals (or an alias of it) into a donated position donates that
     formal itself: unconditionally where the call donates ``True``,
     and when it is called with ``donate=True`` where the call passes
     its own flag through (``donate=donate``; a method's
     ``self.donate``, a closure's enclosing ``donate``).
     ``train(..., params=...)`` is the canonical wrapper.  Promotion
     iterates to a fixpoint across modules.
  3. **Read-after-donation** — at every donating call, each donated
     argument is resolved to its root bindings; a later load of a root
     that the call's own assignment did not rebind is DON001.  A
     donating call inside a loop whose donated root is never re-stored
     in that loop donates a stale tree on the second iteration — also
     DON001.

Aliasing in torch: ``y = x``, ``x.to(...)`` (it returns ``x`` itself at
the same device and dtype), ``x.detach()``, ``torch.as_tensor(x)`` and a
``tree_map``/``tree_map_with_path`` of a lambda made of those may all
hand back the input; any other call (``x.clone()``, ``copy.deepcopy``,
``np.array``, ``np.asarray``, ...) is taken to make a fresh tree and
breaks the chain.

Rules: DON001 read-after-donation, DON002 one tree in both a donated and
a non-donated argument of one call, DON003 a ``donate=`` that is neither
a literal nor a wrapper's pass-through of its own flag (unverifiable —
warning).

Out of scope: the serving caches that the engines write in place.  An
engine owns its cache, and no caller holds one across a step.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import Finding, PassResult

#: what the pass reads: the port's package and the script that drives it
#: on the card
TARGETS = (os.path.join("src", "repro_torch"), "chip_smoke.py")
#: calls that may hand back their (first) argument: functions, methods
#: of the receiver, and the tree maps that do so when their function does
ALIAS_FUNCS = {"as_tensor"}
ALIAS_METHODS = {"to", "detach"}
TREE_MAPS = {"tree_map", "tree_map_with_path"}
#: the donate flag's name, as a formal and as an instance attribute
FLAG = "donate"

# a donation's condition: always, when the callee's own ``donate``
# argument is true, or on a flag the call cannot see (``self.donate``, a
# closure's enclosing ``donate``)
ALWAYS, ARG, OUTER = None, "arg", "outer"


@dataclass(frozen=True)
class DonSig:
    """Donation signature of a callable: positional indices and
    parameter names donated, its formals (for keyword mapping; a
    method's without ``self``) and the condition of the donation."""
    argnums: Tuple[int, ...] = ()
    argnames: Tuple[str, ...] = ()
    params: Tuple[str, ...] = ()
    cond: Optional[str] = ALWAYS


@dataclass
class Registry:
    """Cross-module fixpoint state, keyed by qualified function name."""
    #: factory qname -> {return position (None = bare) -> DonSig}
    factories: Dict[str, Dict[Optional[int], DonSig]] = \
        field(default_factory=dict)
    #: wrapper qname -> DonSig (primitives are wrappers too)
    wrappers: Dict[str, DonSig] = field(default_factory=dict)
    #: qname -> formals (a method's without ``self``), for mapping a
    #: positional ``donate``
    formals: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    #: module qual -> _Module, for resolving package re-exports
    modules: Dict[str, "_Module"] = field(default_factory=dict)

    def canon(self, qname: Optional[str]) -> Optional[str]:
        """Follow re-export chains (``repro_torch.train.train`` ->
        ``repro_torch.train.loop.train``) to the defining module."""
        for _ in range(8):
            if qname is None:
                return None
            head, _, tail = qname.rpartition(".")
            mod = self.modules.get(head)
            if mod is None or tail not in mod.import_map \
                    or mod.import_map[tail] == qname:
                return qname
            qname = mod.import_map[tail]
        return qname


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain, e.g. ``self._cache0``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """The Name under attributes and subscripts (``state.m[k]`` ->
    ``state``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _call_name(call: ast.Call) -> Optional[str]:
    """Trailing name of the called expression (``torch.as_tensor`` ->
    ``as_tensor``)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _alias_arg(call: ast.Call, lookup=None) -> Optional[ast.AST]:
    """The argument ``call`` may hand back, or None for a fresh result:
    ``x.to(...)``, ``x.detach()``, ``torch.as_tensor(x)``, and a tree
    map (of ``torch.as_tensor``, or of a lambda or, through ``lookup``
    from a name to its ``def``, a function that may return its leaf or
    an alias of it) of its tree."""
    name = _call_name(call)
    if isinstance(call.func, ast.Attribute) and name in ALIAS_METHODS:
        return call.func.value
    if name in ALIAS_FUNCS and call.args:
        return call.args[0]
    if name in TREE_MAPS and len(call.args) >= 2:
        fn, leaf = call.args[0], int(name == "tree_map_with_path")
        chain = _attr_chain(fn) or ""
        if chain.rpartition(".")[2] in ALIAS_FUNCS:
            return call.args[1]
        node = lookup(fn.id) if lookup and isinstance(fn, ast.Name) \
            else fn
        if isinstance(node, (ast.Lambda, ast.FunctionDef)) \
                and _returns_leaf(node, leaf):
            return call.args[1]
    return None


def _returns_leaf(fn, leaf: int) -> bool:
    """Whether a lambda or ``def`` may return its ``leaf``-th formal or
    an alias of it (a branch of a conditional expression counts)."""
    formals = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if leaf >= len(formals):
        return False
    values = [fn.body] if isinstance(fn, ast.Lambda) else [
        n.value for n in _own_nodes(fn)
        if isinstance(n, ast.Return) and n.value is not None]
    while values:
        v = values.pop()
        if isinstance(v, ast.IfExp):
            values += [v.body, v.orelse]
            continue
        while isinstance(v, ast.Call):
            v = _alias_arg(v)
        if isinstance(v, ast.Name) and v.id == formals[leaf]:
            return True
    return False


def _is_inplace(call: ast.Call) -> bool:
    """``x.name_(...)``: a tensor method that writes into ``x``."""
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr.endswith("_") \
        and not f.attr.startswith("_")


def _formals(func: ast.FunctionDef, method: bool = False
             ) -> Tuple[str, ...]:
    names = [a.arg for a in (func.args.posonlyargs + func.args.args
                             + func.args.kwonlyargs)]
    if method and names and names[0] in ("self", "cls"):
        names = names[1:]
    return tuple(names)


@dataclass
class _Event:
    """One donating call inside a function body."""
    lineno: int
    stmt_idx: int
    callee: str
    roots: Set[str]                      # donated arg roots
    other_roots: Set[str]                # non-donated arg roots
    rebound: Set[str]                    # names the same stmt assigns
    loops: Tuple[int, ...]               # enclosing loop ids
    cond: Optional[str]                  # ALWAYS, ARG or OUTER


@dataclass
class _Access:
    stmt_idx: int
    lineno: int
    name: str
    kind: str                            # "load" | "store"
    loops: Tuple[int, ...]


@dataclass
class _Func:
    """A function definition with its place: qualified name, enclosing
    function and class, and whether it is a method."""
    node: ast.FunctionDef
    qname: str
    parent: Optional["_Func"]
    cls: Optional[str]                   # qualified name of its class
    method: bool

    @cached_property
    def returns(self) -> List[ast.AST]:
        """The values of the function's own ``return`` statements."""
        return [n.value for n in _own_nodes(self.node)
                if isinstance(n, ast.Return) and n.value is not None]

    def flag_owner(self) -> Optional[str]:
        """ARG where ``donate`` is this function's formal, OUTER where an
        enclosing function's, else None."""
        if FLAG in _formals(self.node):
            return ARG
        p = self.parent
        while p is not None:
            if FLAG in _formals(p.node):
                return OUTER
            p = p.parent
        return None


class _FuncWalker:
    """Linearizes one function body: alias map, donating-callable
    bindings, donation events, and name accesses in source order."""

    def __init__(self, module: "_Module", reg: Registry, func: _Func,
                 record: bool = True):
        self.module, self.reg, self.func = module, reg, func
        self.record = record             # name accesses, for DON001
        self.aliases: Dict[str, str] = {}
        self.donating_vars: Dict[str, DonSig] = {}
        self.events: List[_Event] = []
        self.accesses: List[_Access] = []
        self.non_literal: List[int] = []
        self.idx = 0

    # -- roots ------------------------------------------------------- #
    def _root(self, name: str) -> str:
        seen = set()
        while name in self.aliases and name not in seen:
            seen.add(name)
            name = self.aliases[name]
        return name

    def _expr_roots(self, node: ast.AST) -> Set[str]:
        """Root bindings an argument expression may alias."""
        if isinstance(node, ast.Name):
            return {self._root(node.id)}
        if isinstance(node, ast.Attribute):
            chain = _attr_chain(node)
            return {self._root(chain)} if chain else set()
        if isinstance(node, (ast.Tuple, ast.List)):
            out: Set[str] = set()
            for e in node.elts:
                out |= self._expr_roots(e)
            return out
        if isinstance(node, ast.Call):
            src = _alias_arg(node, self.lookup)
            return self._expr_roots(src) if src is not None else set()
        return set()                     # fresh (or unknown) result

    def lookup(self, name: str) -> Optional[ast.FunctionDef]:
        """The ``def`` a name calls from this function's scope."""
        fake = ast.Call(func=ast.Name(id=name), args=[], keywords=[])
        q = self.module.resolve_call(fake, self.func)
        return self.module.defs.get(q)

    # -- the donate flag of a call ----------------------------------- #
    def flag_of(self, call: ast.Call, callee: Optional[str]):
        """The condition under which ``call`` donates: ALWAYS for a
        literal true ``donate``, ARG or OUTER for a pass-through of a
        flag, False where it does not donate (absent or a false
        literal), and "?" for anything else (DON003)."""
        value = None
        for kw in call.keywords:
            if kw.arg == FLAG:
                value = kw.value
        if value is None and callee:
            formals = self.reg.formals.get(callee, ())
            if FLAG in formals:
                pos = formals.index(FLAG)
                if pos < len(call.args):
                    value = call.args[pos]
        if value is None:
            return False
        return _flag_value(value, self.func)

    # -- statement walk ---------------------------------------------- #
    def walk(self) -> None:
        self._walk_body(self.func.node.body, ())

    def _walk_body(self, body: Sequence[ast.stmt],
                   loops: Tuple[int, ...]) -> None:
        for stmt in body:
            self.idx += 1
            self._statement(stmt, loops)
            for child_body, child_loops in _sub_bodies(stmt, loops):
                self._walk_body(child_body, child_loops)

    def _statement(self, stmt: ast.stmt, loops: Tuple[int, ...]) -> None:
        idx = self.idx
        targets = _target_names(stmt)
        # only the statement's own expressions: bodies of compound
        # statements are walked (and indexed) by _walk_body, so a
        # try/for header must not pre-record its children's loads
        exprs = _own_exprs(stmt)
        # donation events before bindings: the call reads old state
        for e in exprs:
            for call in self.module.calls_in(e):
                self._check_flag(call)
                self._maybe_event(call, idx, targets, loops)
        self._bindings(stmt, targets)
        if self.record:
            self._record_accesses(exprs, stmt, idx, targets, loops)

    def _check_flag(self, call: ast.Call) -> None:
        """DON003: any ``donate=`` that is neither a literal nor a
        pass-through of a flag."""
        for kw in call.keywords:
            if kw.arg == FLAG and _flag_value(kw.value, self.func) == "?":
                self.non_literal.append(call.lineno)

    def _record_accesses(self, exprs, stmt: ast.stmt, idx: int,
                         targets: Set[str],
                         loops: Tuple[int, ...]) -> None:
        own = set()
        for e in exprs:
            for node in ast.walk(e):
                if isinstance(node, ast.Lambda):
                    continue
                name = None
                if isinstance(node, ast.Attribute):
                    name = _attr_chain(node)
                elif isinstance(node, ast.Name):
                    name = node.id
                if name is None or name in own:
                    continue
                own.add(name)
                kind = "store" if name in targets else "load"
                self.accesses.append(_Access(
                    idx, getattr(node, "lineno", stmt.lineno),
                    self._root(name), kind, loops))
        for t in targets:
            if t not in own:
                self.accesses.append(_Access(
                    idx, stmt.lineno, t, "store", loops))

    def _bindings(self, stmt: ast.stmt, targets: Set[str]) -> None:
        if not isinstance(stmt, ast.Assign) or not targets:
            return
        value = stmt.value
        tnodes = stmt.targets[0]
        # step_fn = build_train_step(..., donate=True), or a class
        # whose __call__ donates, built with its flag
        if isinstance(value, ast.Call):
            rets = self._factory_rets(value)
            if rets is not None:
                if isinstance(tnodes, ast.Name) and None in rets:
                    self.donating_vars[tnodes.id] = rets[None]
                elif isinstance(tnodes, (ast.Tuple, ast.List)):
                    for pos, el in enumerate(tnodes.elts):
                        if isinstance(el, ast.Name) and pos in rets:
                            self.donating_vars[el.id] = rets[pos]
                return
        # aliases: y = x / y = x.detach() / y = torch.as_tensor(x)
        src: Optional[str] = None
        node = value
        while isinstance(node, ast.Call):
            node = _alias_arg(node, self.lookup)
        if isinstance(node, ast.Name):
            src = node.id
        elif isinstance(node, ast.Attribute):
            src = _attr_chain(node)
        if src is not None and isinstance(tnodes, ast.Name):
            if self._root(src) != tnodes.id:
                self.aliases[tnodes.id] = self._root(src)
            return
        # fresh (unconditional) binding severs an earlier alias
        if isinstance(tnodes, ast.Name):
            self.aliases.pop(tnodes.id, None)
            self.donating_vars.pop(tnodes.id, None)

    def _factory_rets(self, call: ast.Call
                      ) -> Optional[Dict[Optional[int], DonSig]]:
        """The donating callables a call of a factory returns, with the
        condition of this call's flag applied; None for any other call
        (and for a factory call that does not donate)."""
        qname = self.reg.canon(self.module.resolve_call(call, self.func))
        rets = self.reg.factories.get(qname or "")
        if not rets:
            return None
        out: Dict[Optional[int], DonSig] = {}
        init = f"{qname}.__init__"
        flag = self.flag_of(call, init if init in self.reg.formals
                            else qname)
        for pos, sig in rets.items():
            cond = sig.cond
            if cond == ARG:
                if flag is False or flag == "?":
                    continue
                cond = flag
            out[pos] = DonSig(sig.argnums, sig.argnames, sig.params, cond)
        return out or None

    def _maybe_event(self, call: ast.Call, idx: int, targets: Set[str],
                     loops: Tuple[int, ...]) -> None:
        sig: Optional[DonSig] = None
        callee, cond = "", ALWAYS
        if isinstance(call.func, ast.Name) \
                and call.func.id in self.donating_vars:
            sig, callee = self.donating_vars[call.func.id], call.func.id
            cond = sig.cond
        else:
            qname = self.reg.canon(self.module.resolve_call(call,
                                                            self.func))
            if qname and qname in self.reg.wrappers:
                sig, callee = self.reg.wrappers[qname], qname
                cond = sig.cond
                if cond == ARG:
                    flag = self.flag_of(call, qname)
                    if flag is False or flag == "?":
                        return
                    cond = flag
        if sig is None:
            return
        donated: Set[str] = set()
        other: Set[str] = set()
        pos_names = sig.params
        for i, arg in enumerate(call.args):
            roots = self._expr_roots(arg)
            is_donated = i in sig.argnums or (
                i < len(pos_names) and pos_names[i] in sig.argnames)
            (donated if is_donated else other).update(roots)
        for kw in call.keywords:
            if kw.arg is None or kw.arg == FLAG:
                continue
            roots = self._expr_roots(kw.value)
            (donated if kw.arg in sig.argnames else other).update(roots)
        if donated:
            self.events.append(_Event(call.lineno, idx, callee, donated,
                                      other, set(targets), loops, cond))


def _flag_value(value: ast.AST, func: _Func):
    """ALWAYS (a true literal), False (a false literal), ARG / OUTER (a
    pass-through of this function's, an enclosing function's or the
    instance's ``donate``), or "?" (anything else)."""
    if isinstance(value, ast.Constant):
        return ALWAYS if value.value else False
    if isinstance(value, ast.Name) and value.id == FLAG:
        return func.flag_owner() or "?"
    if _attr_chain(value) == f"self.{FLAG}" and func.cls is not None:
        return OUTER
    return "?"


def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expression nodes a statement itself evaluates — compound
    statements contribute only their headers (bodies are separate
    statements); nested function/class defs are opaque (their bodies
    are analyzed as functions in their own right)."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.While, ast.If)):
        return [stmt.test]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        out: List[ast.AST] = []
        for item in stmt.items:
            out.append(item.context_expr)
            if item.optional_vars is not None:
                out.append(item.optional_vars)
        return out
    if isinstance(stmt, (ast.Try, ast.FunctionDef,
                         ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    return [stmt]


def _sub_bodies(stmt: ast.stmt, loops: Tuple[int, ...]):
    """(body, loop-stack) pairs for a compound statement's children."""
    if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
        inner = loops + (id(stmt),)
        yield stmt.body, inner
        yield stmt.orelse, loops
    elif isinstance(stmt, ast.If):
        yield stmt.body, loops
        yield stmt.orelse, loops
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        yield stmt.body, loops
    elif isinstance(stmt, ast.Try):
        yield stmt.body, loops
        for h in stmt.handlers:
            yield h.body, loops
        yield stmt.orelse, loops
        yield stmt.finalbody, loops


def _target_names(stmt: ast.stmt) -> Set[str]:
    out: Set[str] = set()
    tnodes: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        tnodes = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
            and stmt.target is not None:
        tnodes = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        tnodes = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        tnodes = [i.optional_vars for i in stmt.items
                  if i.optional_vars is not None]
    for t in tnodes:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out |= {e.id for e in t.elts if isinstance(e, ast.Name)}
        elif isinstance(t, ast.Attribute):
            chain = _attr_chain(t)
            if chain:
                out.add(chain)
    return out


def _own_nodes(func: ast.FunctionDef):
    """The nodes of ``func``'s body, not of the functions nested in it."""
    todo = list(func.body)
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


class _Module:
    """One parsed file: import map + function defs with their scopes."""

    def __init__(self, path: str, rel: str, qual: str, tree: ast.Module):
        self.path, self.rel, self.qual, self.tree = path, rel, qual, tree
        self.import_map: Dict[str, str] = {}
        self.local_funcs: Dict[str, str] = {}
        self.funcs: List[_Func] = []
        self.defs: Dict[str, ast.FunctionDef] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self._calls: Dict[int, Tuple[ast.Call, ...]] = {}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.import_map[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.import_map[a.asname or a.name] = a.name
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                self.local_funcs[node.name] = f"{qual}.{node.name}"
        # function-local imports (the launch CLIs import inside main)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.import_map.setdefault(
                        a.asname or a.name, f"{node.module}.{a.name}")
        self._collect(tree.body, qual, None, None)

    def _collect(self, body, prefix: str, parent: Optional[_Func],
                 cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, ast.FunctionDef):
                f = _Func(node, f"{prefix}.{node.name}", parent, cls,
                          method=cls is not None and parent is None)
                self.funcs.append(f)
                self.defs[f.qname] = node
                self._collect(node.body, f.qname, f, cls)
            elif isinstance(node, ast.ClassDef):
                q = f"{prefix}.{node.name}"
                self.classes[q] = node
                self._collect(node.body, q, parent, q)
            else:
                for child_body in _nested_bodies(node):
                    self._collect(child_body, prefix, parent, cls)

    def calls_in(self, expr: ast.AST) -> Tuple[ast.Call, ...]:
        """Every call under ``expr``, kept: the fixpoint walks each body
        several times."""
        if id(expr) not in self._calls:
            self._calls[id(expr)] = tuple(
                n for n in ast.walk(expr) if isinstance(n, ast.Call))
        return self._calls[id(expr)]

    def resolve_call(self, call: ast.Call,
                     func: Optional[_Func] = None) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Name):
            p = func
            while p is not None:          # lexical scope: nested defs
                q = f"{p.qname}.{f.id}"
                if q in self.defs:
                    return q
                p = p.parent
            return self.local_funcs.get(f.id) or \
                self.import_map.get(f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and func is not None and func.cls:
                return f"{func.cls}.{f.attr}"
            mod = self.import_map.get(f.value.id)
            if mod:
                return f"{mod}.{f.attr}"
        return None


def _nested_bodies(node: ast.AST):
    """Statement lists inside a compound statement (defs inside an
    ``if`` or ``try`` are defs of the enclosing scope)."""
    for name in ("body", "orelse", "finalbody"):
        body = getattr(node, name, None)
        if isinstance(body, list):
            yield body
    for h in getattr(node, "handlers", ()):
        yield h.body


def _module_qual(root: str, path: str, base: str) -> str:
    """Import name of ``path``: relative to ``src/`` for the packages
    there, else to ``base`` (a scanned directory, or a file's own)."""
    src = os.path.join(root, "src")
    rel = os.path.relpath(path, src if path.startswith(src + os.sep)
                          else base)
    qual = rel[:-3].replace(os.sep, ".")
    if qual.endswith(".__init__"):
        qual = qual[: -len(".__init__")]
    return qual


def _load_modules(root: str,
                  targets: Sequence[str]) -> List[_Module]:
    mods = []
    for target in targets:
        base = os.path.join(root, target)
        if os.path.isfile(base):
            found = [(base, os.path.dirname(base))]
        else:
            found = [(os.path.join(d, fn), base)
                     for d, _, files in sorted(os.walk(base))
                     for fn in sorted(files) if fn.endswith(".py")]
        for path, where in found:
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError:
                    continue
            mods.append(_Module(path, rel, _module_qual(root, path, where),
                                tree))
    return mods


def _scan_function(module: _Module, reg: Registry, func: _Func,
                   record: bool = True) -> _FuncWalker:
    w = _FuncWalker(module, reg, func, record)
    w.walk()
    return w


def _written_formals(module: _Module, func: _Func) -> Tuple[str, ...]:
    """The formals of ``func`` (with a ``donate`` formal) whose trees
    its body, or a function nested in it, writes in place: through
    local aliases, attributes, subscripts and calls of the nested
    functions, to a fixpoint."""
    nested = [g for g in module.funcs
              if g is func or _inside(g, func)]
    by_q = {g.qname: g for g in nested}
    written: Dict[str, Set[str]] = {g.qname: set() for g in nested}

    def roots(expr: ast.AST, alias: Dict[str, str]) -> Set[str]:
        if isinstance(expr, (ast.Tuple, ast.List)):
            return set().union(set(), *(roots(e, alias) for e in expr.elts))
        while isinstance(expr, ast.Call):
            expr = _alias_arg(expr)
            if expr is None:
                return set()
        name = _base_name(expr)
        while name in alias:
            name = alias[name]
        return {name} if name else set()

    changed = True
    while changed:
        changed = False
        for g in nested:
            nodes = list(_own_nodes(g.node))
            # flow-insensitive: every single-name binding of an alias
            alias: Dict[str, str] = {}
            for node in nodes:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    src = roots(node.value, {})
                    if len(src) == 1:
                        alias[node.targets[0].id] = src.pop()
            hits: Set[str] = set()
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                if _is_inplace(node):
                    hits |= roots(node.func.value, alias)
                q = module.resolve_call(node, g)
                if q in by_q:
                    callee = _formals(by_q[q].node)
                    for i, a in enumerate(node.args):
                        if i < len(callee) and callee[i] in written[q]:
                            hits |= roots(a, alias)
                    for kw in node.keywords:
                        if kw.arg in written[q]:
                            hits |= roots(kw.value, alias)
            new = (hits & set(_formals(g.node))) - written[g.qname]
            if new:
                written[g.qname] |= new
                changed = True
    return tuple(p for p in _formals(func.node) if p in written[func.qname])


def _inside(g: _Func, func: _Func) -> bool:
    p = g.parent
    while p is not None:
        if p is func:
            return True
        p = p.parent
    return False


def _merge_cond(conds: Sequence[Optional[str]]) -> Optional[str]:
    """The condition of a function's donation from its events': always
    if any event donates always, else on its own flag if any passes it,
    else on a flag out of its callers' sight."""
    if ALWAYS in conds:
        return ALWAYS
    return ARG if ARG in conds else OUTER


def _promote(module: _Module, reg: Registry, func: _Func,
             w: _FuncWalker, written_cache: Dict[str, Tuple[str, ...]]
             ) -> bool:
    """Factory + wrapper promotion; returns True when the registry grew."""
    changed = False
    qname = func.qname
    formals = _formals(func.node)
    params = _formals(func.node, method=func.method)
    if reg.formals.get(qname) != params:
        reg.formals[qname] = params
        changed = True
    # wrapper: a formal reaches a donated position, or (a primitive)
    # the body writes a formal's tree in place under its flag
    if FLAG in formals and qname not in written_cache:
        written_cache[qname] = _written_formals(module, func)
    written = written_cache.get(qname, ())
    donated = [p for p in params if p in written
               or any(p in ev.roots for ev in w.events)]
    if donated:
        cond = _merge_cond([ARG] * bool(written) + [
            ev.cond for ev in w.events if set(donated) & ev.roots])
        sig = DonSig(tuple(params.index(p) for p in donated),
                     tuple(donated), params, cond)
        if reg.wrappers.get(qname) != sig:
            reg.wrappers[qname] = sig
            changed = True
    # factory: returns a donating callable (possibly inside a tuple)
    rets: Dict[Optional[int], DonSig] = {}

    def _sig_of(e) -> Optional[DonSig]:
        if isinstance(e, ast.Name):
            if e.id in w.donating_vars:
                s = w.donating_vars[e.id]
            else:
                s = reg.wrappers.get(f"{qname}.{e.id}")
            if s is not None and s.cond == OUTER and FLAG in formals:
                s = DonSig(s.argnums, s.argnames, s.params, ARG)
            return s
        if isinstance(e, ast.Call):
            got = w._factory_rets(e)
            return got.get(None) if got else None
        return None

    for v in func.returns:
        if isinstance(v, ast.Tuple):
            for pos, e in enumerate(v.elts):
                s = _sig_of(e)
                if s:
                    rets[pos] = s
        else:
            s = _sig_of(v)
            if s:
                rets[None] = s
    if rets and reg.factories.get(qname) != rets:
        reg.factories[qname] = rets
        changed = True
    return changed


def _promote_classes(module: _Module, reg: Registry) -> bool:
    """A class whose ``__call__`` donates is a factory: building it
    returns the donating callable (on its ``donate`` argument where
    ``__call__`` donates on ``self.donate``)."""
    changed = False
    for cls in module.classes:
        sig = reg.wrappers.get(f"{cls}.__call__")
        if sig is None:
            continue
        cond = ARG if sig.cond == OUTER else sig.cond
        rets = {None: DonSig(sig.argnums, sig.argnames, sig.params, cond)}
        if reg.factories.get(cls) != rets:
            reg.factories[cls] = rets
            changed = True
    return changed


def check_function(module: _Module, reg: Registry,
                   func: _Func) -> List[Finding]:
    """Emit DON001/DON002/DON003 findings for one function body."""
    w = _scan_function(module, reg, func)
    findings: List[Finding] = []
    for ev in w.events:
        live = {r for r in ev.roots if r not in ev.rebound}
        for root in sorted(live & ev.other_roots):
            findings.append(Finding(
                "DON002", "error", module.rel, ev.lineno,
                f"{root!r} is passed to both a donated and a "
                f"non-donated argument of {ev.callee}() — the "
                f"non-donated view reads a tree the call overwrites"))
        for root in sorted(live):
            hit = _read_after(w, ev, root)
            if hit is not None:
                findings.append(Finding(
                    "DON001", "error", module.rel, hit[0],
                    f"{root!r} is read after being donated to "
                    f"{ev.callee}() at line {ev.lineno} — {hit[1]}; "
                    f"donation overwrites the caller's tensors in place "
                    f"(take a fresh copy first: .clone(), "
                    f"copy.deepcopy)"))
    for lineno in w.non_literal:
        findings.append(Finding(
            "DON003", "warning", module.rel, lineno,
            f"donate= of this call is neither a literal nor a "
            f"pass-through of the caller's own flag — the donation "
            f"contract cannot be statically checked"))
    return findings


def _read_after(w: _FuncWalker, ev: _Event,
                root: str) -> Optional[Tuple[int, str]]:
    # linear scan: a load after the event, before any re-store
    for acc in w.accesses:
        if acc.stmt_idx <= ev.stmt_idx or acc.name != root:
            continue
        if acc.kind == "store":
            break
        return (acc.lineno, "read reaches the donated tensors")
    # loop rule: donated in a loop that never re-stores the root —
    # iteration k+1 re-donates (and re-reads) the overwritten tree
    if ev.loops:
        loop_id = ev.loops[-1]
        stored = any(acc.kind == "store" and acc.name == root
                     and loop_id in acc.loops for acc in w.accesses)
        if not stored:
            return (ev.lineno, "the enclosing loop never rebinds it, "
                               "so the next iteration donates an "
                               "overwritten tree")
    return None


def build_registry(mods: Sequence[_Module]) -> Registry:
    """The donating factories and wrappers of ``mods``, promoted to a
    fixpoint."""
    reg = Registry(modules={m.qual: m for m in mods})
    written: Dict[str, Tuple[str, ...]] = {}
    for _ in range(8):
        changed = False
        for mod in mods:
            for func in mod.funcs:
                w = _scan_function(mod, reg, func, record=False)
                changed |= _promote(mod, reg, func, w, written)
            changed |= _promote_classes(mod, reg)
        if not changed:
            break
    return reg


def analyze(root: str, targets: Sequence[str] = TARGETS
            ) -> Tuple[List[Finding], Dict[str, int]]:
    mods = _load_modules(root, targets)
    reg = build_registry(mods)
    findings: List[Finding] = []
    n_funcs = 0
    for mod in mods:
        for func in mod.funcs:
            n_funcs += 1
            findings.extend(check_function(mod, reg, func))
    stats = {"modules": len(mods), "functions": n_funcs,
             "donating_factories": len(reg.factories),
             "donating_wrappers": len(reg.wrappers)}
    return findings, stats


def run(root: str) -> PassResult:
    findings, stats = analyze(root)
    return PassResult("donatecheck", findings, stats)
