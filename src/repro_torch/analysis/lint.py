"""Mesh and in-place hygiene linter: the reference lint's rules that have a
torch form (``repro/analysis/lint.py``), over the port's source.

Each rule names a bug class the port's mesh code has really had: a reduction
that covered one rank's slice, and an in-place apply that wrote a table the
caller still read.

Rules
-----
``shard-full-aggregate``
    A shard scope calls a full (heat-fused) aggregate (``aggregate_rowsparse``
    / ``sparse_cohort_aggregate``) instead of ``aggregate_rowsparse_partial``:
    each rank holds a PARTIAL cohort, so the fused N/n_m heat correction
    applies per rank and the cross-rank combine then sums already-corrected
    partials.

``shard-missing-psum``
    ``.sum()`` / ``.mean()`` / ``torch.sum`` / ``torch.mean`` /
    ``tree_sq_sum`` in a shard scope with no collective in reach: the result
    collapses the RANK's slice only and reports one rank's value as the
    cohort's (or, on a model split, the slice's as the leaf's). A reduction
    nested in a collective, or whose assigned name feeds one later in the
    scope, is exempt. The collectives are a mesh's ``psum``, ``pmean``,
    ``pmax``, ``all_gather`` and ``reduce_scatter``
    (``repro_torch.launch.mesh.CohortMesh``) on any receiver, and
    ``repro_torch.sharding.parallel``'s ``reduce_from_model``,
    ``sum_over_model``, ``max_from_model`` and ``mean_over``. A value that is
    per rank by design carries an explained suppression.

``donated-reuse``
    A tensor written in place by a *writer* is read again by the caller. A
    writer is a function whose body writes one of its parameters in place:
    an in-place tensor method (one trailing ``_``: ``index_add_``, ``add_``,
    ``copy_``, ...) or the parameter passed as ``out=``, on the parameter or
    on a view of it (a slice, ``.view``, ``.narrow``, ``.select``, ``.t()``,
    ``.transpose``, ``.unsqueeze``, an element of ``.split`` / ``.chunk``, a
    loop over its items); or a function that passes its own parameter on to
    a writer. Writers are found across the files of one run, through
    ``from ... import``. The caller breaks the rule when it passes a name, or
    a view of it, to a writer and loads the name again later without
    rebinding it in the writing statement. The safe idiom rebinds it there:
    ``table = apply_rowsparse(table, rs)``. A write through a view is a
    write of the view's base, which a later read of the base sees.

Shard scopes
------------
The port has no ``shard_map``: every rank runs the same Python on its own
shard. A function decorated with, or passed to,
``repro_torch.launch.mesh.shard_body`` (a no-op marker) is the counterpart
of a ``shard_map`` body; a lambda passed to it is one too. From these roots
every function of the same module that a shard scope names joins the set,
until nothing changes. Calling a collective does not make a scope: the
sparse plane's combine helpers all-gather and then aggregate the gathered
stack once, which is right, and are never marked; nor is the model code,
whose per-rank reductions (over a rank's heads, a split norm's squares
before its sum) are right by design.

Rules not ported
----------------
``traced-float``, ``host-numpy`` and ``data-dep-shape`` name jit-trace
classes; under ``torch.func.vmap`` the same code raises at once. Their torch
form is a host sync or a data-dependent shape inside a CUDA-graph capture,
which comes with CUDA graphs. ``pallas-dim-semantics``,
``pallas-blockspec-misaligned`` and ``static-argnames-array`` have no
counterpart: the port has no Pallas and no jit. The Hopper kernels' launch
contracts are ``repro_torch.analysis.kernel_audit``'s.

Allowlist
---------
Append ``# repro-lint: ok <rule>[,<rule>] -- <reason>`` to the offending
line (or the line above it; a comment block above covers the first code line
after it). The reason is mandatory, and every rule named must be one of
``RULES`` (or ``*``): anything else is itself reported (``bare-allowlist``).

Usage
-----
    python -m repro_torch.analysis.lint [paths] [--json report.json] [--list-rules] [-q]

The default path is ``src/repro_torch``. Exit status 0 iff no violations;
2 if a file does not parse. Stdlib-only: ``python
src/repro_torch/analysis/lint.py`` runs without torch installed (``-m``
imports the package, which imports torch).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "donated-reuse": "tensor written in place by a writer and read again by "
                     "the caller without rebinding it",
    "shard-full-aggregate": "full heat-fused aggregate called inside a shard "
                            "body (partial + combine required)",
    "shard-missing-psum": "per-rank reduction in a shard body with no "
                          "collective in reach",
    "bare-allowlist": "repro-lint suppression without a ' -- reason'",
}

_ALLOW_RE = re.compile(
    r"#\s*repro-lint:\s*ok\s+([a-z0-9*,\s-]+?)\s*(?:--\s*(\S.*))?$")

#: the marker whose decorated or passed functions are shard bodies
_SHARD_MARKER = "shard_body"

#: full (heat-fused) aggregates that must never run per rank
_SHARD_BANNED_AGGREGATES = {"aggregate_rowsparse", "sparse_cohort_aggregate"}

#: collective callees (any receiver) that legitimately consume a per-rank
#: reduction: the mesh's and ``sharding/parallel.py``'s
_COLLECTIVE_CALLS = {"psum", "pmean", "pmax", "all_gather", "reduce_scatter",
                     "reduce_from_model", "sum_over_model", "max_from_model",
                     "mean_over"}

#: reduction callee tails that collapse a per-rank axis
_REDUCTION_TAILS = {"sum", "mean"}
_TREE_REDUCTIONS = {"tree_sq_sum"}

#: methods (and ``torch.<name>`` functions) whose result shares the
#: argument's storage; the last three do whenever they can
_VIEW_METHODS = {
    "view", "view_as", "narrow", "select", "t", "transpose", "swapaxes",
    "unsqueeze", "squeeze", "permute", "movedim", "expand", "expand_as",
    "split", "chunk", "unbind", "tensor_split", "diagonal", "unflatten",
    "as_strided", "detach", "contiguous", "reshape", "flatten"}
_VIEW_ATTRS = {"T", "mT"}
#: attribute reads that hold no storage of the object
_META_ATTRS = {"shape", "dtype", "device", "ndim", "layout", "is_cuda",
               "requires_grad", "itemsize", "num_rows"}

#: an in-place tensor method: one trailing underscore, not a dunder
_INPLACE_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_]*[A-Za-z0-9]_$")


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    rule: str
    path: str
    line: int
    reason: str

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string, or None for non-name expressions."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _name_tail(node: ast.AST) -> Optional[str]:
    """Last component of a (possibly dotted) callee name."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _target_names(target: ast.AST) -> List[str]:
    """Dotted names bound by an assignment target (tuples flattened)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_target_names(elt))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    d = _dotted(target)
    return [d] if d else []


def _flat_stmts(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements of a scope in source order, control-flow bodies flattened,
    nested function/class scopes skipped."""
    for st in body:
        yield st
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(st, attr, None)
            if sub:
                yield from _flat_stmts(sub)
        for handler in getattr(st, "handlers", []) or []:
            yield from _flat_stmts(handler.body)
        for case in getattr(st, "cases", []) or []:
            yield from _flat_stmts(case.body)


def _own_nodes(st: ast.stmt) -> Iterable[ast.AST]:
    """The nodes a statement evaluates itself: a compound statement's header
    (its test, iterable or context managers), never its body, a nested
    def/class body or a lambda body."""
    if isinstance(st, (ast.If, ast.While)):
        roots: List[ast.AST] = [st.test]
    elif isinstance(st, (ast.For, ast.AsyncFor)):
        roots = [st.iter, st.target]
    elif isinstance(st, (ast.With, ast.AsyncWith)):
        roots = list(st.items)
    elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        roots = list(st.decorator_list)
    elif isinstance(st, ast.Try) or type(st).__name__ == "TryStar":
        roots = []
    elif type(st).__name__ == "Match":
        roots = [st.subject]
    else:
        roots = [st]
    stack = roots[::-1]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.Lambda):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _stmt_targets(st: ast.stmt) -> List[str]:
    """Dotted names a statement binds (assignments, loop and ``with``
    targets)."""
    out: List[str] = []
    if isinstance(st, ast.Assign):
        for t in st.targets:
            out.extend(_target_names(t))
    elif isinstance(st, (ast.AugAssign, ast.AnnAssign, ast.For,
                         ast.AsyncFor)):
        out.extend(_target_names(st.target))
    elif isinstance(st, (ast.With, ast.AsyncWith)):
        for item in st.items:
            if item.optional_vars is not None:
                out.extend(_target_names(item.optional_vars))
    return out


def _params(fn: ast.AST) -> List[str]:
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


def _covers(name: str, other: str) -> bool:
    """Is ``other`` the object ``name`` names, or a part of it?"""
    return other == name or other.startswith(name + ".")


# ---------------------------------------------------------------------------
# per-module index
# ---------------------------------------------------------------------------


class _FuncInfo:
    __slots__ = ("node", "parent", "is_method", "children")

    def __init__(self, node, parent, is_method):
        self.node = node
        self.parent = parent          # enclosing _FuncInfo or None (module)
        self.is_method = is_method
        self.children: Dict[str, ast.AST] = {}


class _ModuleIndex(ast.NodeVisitor):
    """The function table: every def, its encloser and its nested defs."""

    def __init__(self):
        self.funcs: List[_FuncInfo] = []
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        self.top: Dict[str, ast.AST] = {}
        self._stack: List[_FuncInfo] = []
        self._class_depth = 0

    def _visit_func(self, node):
        parent = self._stack[-1] if self._stack else None
        info = _FuncInfo(node, parent,
                         is_method=self._class_depth > 0 and not self._stack)
        self.funcs.append(info)
        self.by_name.setdefault(node.name, []).append(info)
        if parent is not None:
            parent.children[node.name] = node
        elif not info.is_method:
            self.top[node.name] = node
        self._stack.append(info)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self._class_depth += 1
        self.generic_visit(node)
        self._class_depth -= 1


def _module_name(path: str) -> str:
    """Dotted module name of ``path``: its file name under every enclosing
    directory that holds an ``__init__.py``."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:]
    return ".".join(reversed(parts))


class _Module:
    """One parsed file: its index and what its imports bind."""

    def __init__(self, source: str, path: str):
        self.path = path
        self.source = source
        self.name = _module_name(path)
        self.is_package = os.path.basename(path) == "__init__.py"
        self.tree = ast.parse(source, filename=path)
        self.index = _ModuleIndex()
        self.index.visit(self.tree)
        #: local name -> (module, attribute or None for a module)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.imports[alias.asname] = (alias.name, None)
                    else:
                        head = alias.name.split(".")[0]
                        self.imports[head] = (head, None)
            elif isinstance(node, ast.ImportFrom):
                base = self._absolute(node.module, node.level)
                for alias in node.names:
                    if alias.name != "*":
                        self.imports[alias.asname or alias.name] = (base,
                                                                    alias.name)

    def _absolute(self, module: Optional[str], level: int) -> str:
        if not level:
            return module or ""
        pkg = self.name.split(".")
        if not self.is_package:
            pkg = pkg[:-1]
        pkg = pkg[:len(pkg) - (level - 1)]
        return ".".join(pkg + ([module] if module else []))


# ---------------------------------------------------------------------------
# shard scopes: shard-full-aggregate and shard-missing-psum
# ---------------------------------------------------------------------------


def _walk_shard_scope(root: ast.AST) -> Iterable[ast.AST]:
    """Own scope of a function/lambda, DESCENDING into lambdas.

    Lambda bodies are included (a shard body may be a lambda, and the names
    it calls live inside it); nested def/class scopes are excluded — they
    are shard scopes of their own when referenced.
    """
    stack = [root.body] if isinstance(root, ast.Lambda) else list(root.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _shard_roots(tree: ast.Module) -> Tuple[List[ast.AST], Set[str]]:
    """Functions decorated with the marker (nodes), and the names and
    lambdas passed to it."""
    nodes: List[ast.AST] = []
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_name_tail(d) == _SHARD_MARKER for d in node.decorator_list):
                nodes.append(node)
        elif isinstance(node, ast.Call) \
                and _name_tail(node.func) == _SHARD_MARKER and node.args:
            cand = node.args[0]
            if isinstance(cand, ast.Lambda):
                nodes.append(cand)
            elif isinstance(cand, ast.Call) \
                    and _name_tail(cand.func) == "partial" and cand.args:
                t = _name_tail(cand.args[0])
                if t:
                    names.add(t)
            else:
                t = _name_tail(cand)
                if t:
                    names.add(t)
    return nodes, names


def shard_scopes(index: _ModuleIndex, tree: ast.Module) -> List[ast.AST]:
    """Scopes that run on every rank with its shard (see the module
    docstring): the marker's roots, then every module function a shard scope
    names, to a fixpoint. Within-module only."""
    scopes: List[ast.AST] = []
    seen: Set[ast.AST] = set()
    work: List[ast.AST] = []
    done: Set[str] = set()

    def add_scope(node: ast.AST) -> None:
        if node not in seen:
            seen.add(node)
            work.append(node)

    root_nodes, names = _shard_roots(tree)
    for node in root_nodes:
        add_scope(node)
    while work or names - done:
        for name in sorted(names - done):
            done.add(name)
            for info in index.by_name.get(name, []):
                add_scope(info.node)
        while work:
            scope = work.pop()
            scopes.append(scope)
            for sub in _walk_shard_scope(scope):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in index.by_name:
                    names.add(sub.id)
    return scopes


def _is_reduction(call: ast.Call) -> bool:
    tail = _name_tail(call.func)
    if tail in _TREE_REDUCTIONS:
        return True
    if tail not in _REDUCTION_TAILS or not isinstance(call.func,
                                                      ast.Attribute):
        return False                   # the builtin sum() is host arithmetic
    root = _dotted(call.func) or ""
    return not root.startswith(("np.", "numpy.", "math."))


def _check_shard_hygiene(mod: _Module, out: List[Violation]) -> None:
    """shard-full-aggregate + shard-missing-psum over every shard scope."""
    path = mod.path
    for scope in shard_scopes(mod.index, mod.tree):
        sname = getattr(scope, "name", "<lambda>")
        nodes = list(_walk_shard_scope(scope))
        # reductions nested under a collective call are combined on the spot
        exempt: Set[ast.AST] = set()
        fed: Set[str] = set()     # names a collective consumes
        for n in nodes:
            if isinstance(n, ast.Call) \
                    and _name_tail(n.func) in _COLLECTIVE_CALLS:
                exempt.update(ast.walk(n))
                for a in list(n.args) + [kw.value for kw in n.keywords]:
                    fed.update(s.id for s in ast.walk(a)
                               if isinstance(s, ast.Name))
        # reductions whose assigned name feeds a collective elsewhere in the
        # scope are the two-statement combine idiom
        for n in nodes:
            if isinstance(n, ast.Assign):
                tnames: List[str] = []
                for t in n.targets:
                    tnames.extend(_target_names(t))
                if any(t in fed for t in tnames):
                    exempt.update(ast.walk(n.value))
        for n in nodes:
            if not isinstance(n, ast.Call):
                continue
            tail = _name_tail(n.func)
            if tail in _SHARD_BANNED_AGGREGATES:
                out.append(Violation(
                    "shard-full-aggregate", path, n.lineno, n.col_offset,
                    f"{tail}() inside the shard body {sname}(): each rank "
                    "holds a PARTIAL cohort, so the fused heat correction "
                    "applies per rank and the cross-rank combine sums "
                    "already-corrected partials — use "
                    "aggregate_rowsparse_partial + "
                    "combine_rowsparse_partials"))
                continue
            if not _is_reduction(n) or n in exempt:
                continue
            out.append(Violation(
                "shard-missing-psum", path, n.lineno, n.col_offset,
                f"{tail}() reduction in the shard body {sname}() with no "
                "collective in reach: the result collapses this RANK's "
                "slice only — combine it over the mesh axis (psum/pmean, "
                "sum_over_model), or suppress with the per-rank intent "
                "explained"))


# ---------------------------------------------------------------------------
# in-place writers: donated-reuse
# ---------------------------------------------------------------------------


def _view_source(e: ast.AST) -> Optional[ast.AST]:
    """The expression a view expression views, or None if ``e`` is not one."""
    if isinstance(e, ast.Subscript):
        return e.value
    if isinstance(e, ast.Attribute) and e.attr in _VIEW_ATTRS:
        return e.value
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr in _VIEW_METHODS:
        if _dotted(e.func.value) == "torch":
            return e.args[0] if e.args else None
        return e.func.value
    return None


def _base(e: ast.AST, aliases: Dict[str, str]) -> Tuple[Optional[str],
                                                       Optional[str]]:
    """``(name, root)`` of what ``e`` writes: the dotted name under any views,
    and the same name through the scope's aliases (``part = leaf[lo:hi]``
    makes ``part``'s root ``leaf``)."""
    while True:
        src = _view_source(e)
        if src is None:
            break
        e = src
    d = _dotted(e)
    if d is None:
        return None, None
    head, _, rest = d.partition(".")
    if head in aliases:
        return d, aliases[head] + ("." + rest if rest else "")
    return d, d


def _is_alias_value(e: ast.AST) -> bool:
    """Does binding ``e`` to a name share its storage (a name, an attribute,
    an item or a view)?"""
    if isinstance(e, ast.Name):
        return True
    if isinstance(e, ast.Attribute):
        return e.attr not in _META_ATTRS and (
            _dotted(e) is not None or e.attr in _VIEW_ATTRS)
    return _view_source(e) is not None


def _iter_aliases(target: ast.AST, it: ast.AST,
                  aliases: Dict[str, str]) -> Dict[str, str]:
    """Loop (or comprehension) variables bound to items of a container:
    ``for name, p in params.items()``, ``.values()``, ``enumerate``,
    ``zip`` and plain iteration."""
    out: Dict[str, str] = {}

    def bind(t: ast.AST, src: ast.AST) -> None:
        if isinstance(src, ast.Call) and isinstance(src.func, ast.Attribute) \
                and src.func.attr in ("items", "values") and not src.args:
            if src.func.attr == "items":
                if isinstance(t, ast.Tuple) and len(t.elts) == 2:
                    bind(t.elts[1], src.func.value)
                return
            src = src.func.value
        elif isinstance(src, ast.Call) and isinstance(src.func, ast.Name):
            if src.func.id == "enumerate" and src.args:
                if isinstance(t, ast.Tuple) and len(t.elts) == 2:
                    bind(t.elts[1], src.args[0])
                return
            if src.func.id == "zip":
                if isinstance(t, ast.Tuple) and len(t.elts) == len(src.args):
                    for sub, arg in zip(t.elts, src.args):
                        bind(sub, arg)
                return
        if not _is_alias_value(src):
            return
        _, root = _base(src, aliases)
        if root is None:
            return
        for name in _target_names(t):
            if "." not in name:
                out[name] = root

    bind(target, it)
    return out


def _update_aliases(st: ast.stmt, aliases: Dict[str, str]) -> None:
    """Rebind what ``st`` assigns: a view or item of a name aliases it, any
    other value ends an alias."""
    root = None
    if isinstance(st, ast.Assign) and _is_alias_value(st.value):
        _, root = _base(st.value, aliases)
    for name in _stmt_targets(st):
        aliases.pop(name, None)
    if root is not None:
        for t in st.targets:
            for name in _target_names(t):
                if "." not in name and name != root:
                    aliases[name] = root
    elif isinstance(st, (ast.For, ast.AsyncFor)):
        aliases.update(_iter_aliases(st.target, st.iter, aliases))


def _comp_aliases(nodes: Sequence[ast.AST],
                  aliases: Dict[str, str]) -> Dict[str, str]:
    """Aliases a statement's comprehensions bind, for that statement."""
    out = dict(aliases)
    for n in nodes:
        if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                          ast.GeneratorExp)):
            for g in n.generators:
                out.update(_iter_aliases(g.target, g.iter, out))
    return out


class _Project:
    """Every module of one run, and the writers found across them."""

    def __init__(self, modules: Sequence[_Module]):
        self.modules = list(modules)
        self.by_name: Dict[str, _Module] = {m.name: m for m in modules}
        self.module_of: Dict[ast.AST, _Module] = {}
        for m in modules:
            for info in m.index.funcs:
                self.module_of[info.node] = m
        #: function node -> the parameters it writes in place
        self.writes: Dict[ast.AST, Set[str]] = {}
        self._find_writers()

    # -- callee resolution -------------------------------------------------

    def _lookup(self, modname: str, name: str, depth: int = 0):
        mod = self.by_name.get(modname)
        if mod is None or depth > 8:
            return None
        if name in mod.index.top:
            return mod.index.top[name]
        imp = mod.imports.get(name)
        if imp is not None and imp[1] is not None:
            return self._lookup(imp[0], imp[1], depth + 1)
        return None

    def resolve(self, call: ast.Call, info: Optional[_FuncInfo],
                mod: _Module) -> Optional[ast.AST]:
        """The function a call runs, where the run can name it: a def in an
        enclosing scope or the module, an imported function, or a function
        of an imported module."""
        f = call.func
        if isinstance(f, ast.Name):
            cur = info
            while cur is not None:
                if f.id in cur.children:
                    return cur.children[f.id]
                cur = cur.parent
            if f.id in mod.index.top:
                return mod.index.top[f.id]
            imp = mod.imports.get(f.id)
            if imp is not None and imp[1] is not None:
                return self._lookup(imp[0], imp[1])
            # a callable handed in (a parameter): a nested def of that name
            # in the module, as the shard scopes resolve names
            cands = [i.node for i in mod.index.by_name.get(f.id, [])
                     if not i.is_method]
            return cands[0] if len(cands) == 1 else None
        d = _dotted(f)
        if d is None or "." not in d:
            return None
        head, _, rest = d.partition(".")
        prefix, _, attr = rest.rpartition(".")
        imp = mod.imports.get(head)
        if imp is None:
            return None
        modname = imp[0] if imp[1] is None else f"{imp[0]}.{imp[1]}"
        if prefix:
            modname = f"{modname}.{prefix}"
        return self._lookup(modname, attr)

    def _written_args(self, call: ast.Call, callee: ast.AST) -> List[ast.AST]:
        """The arguments of ``call`` bound to parameters ``callee`` writes."""
        written = self.writes.get(callee)
        if not written:
            return []
        args = callee.args
        pos = [a.arg for a in args.posonlyargs + args.args]
        out = []
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                break
            if i < len(pos) and pos[i] in written:
                out.append(a)
        for kw in call.keywords:
            if kw.arg in written:
                out.append(kw.value)
        return out

    # -- writers -------------------------------------------------------------

    def _direct_writes(self, call: ast.Call, mod: _Module) -> List[ast.AST]:
        """What a call writes in place itself: an in-place method's receiver
        (or, for ``torch.nn.init.normal_(w)``-style functions of a module,
        their first argument) and an ``out=`` argument."""
        out = [kw.value for kw in call.keywords if kw.arg == "out"]
        f = call.func
        if isinstance(f, ast.Attribute) and _INPLACE_RE.match(f.attr):
            recv = _dotted(f.value)
            head = recv.split(".")[0] if recv else None
            if head is not None and (head == "torch" or (
                    head in mod.imports and mod.imports[head][1] is None)):
                out.extend(call.args[:1])
            else:
                out.append(f.value)
        return out

    def _find_writers(self) -> None:
        changed = True
        while changed:
            changed = False
            for mod in self.modules:
                for info in mod.index.funcs:
                    params = set(_params(info.node))
                    got = self.writes.setdefault(info.node, set())
                    aliases: Dict[str, str] = {}
                    for st in _flat_stmts(info.node.body):
                        nodes = list(_own_nodes(st))
                        local = _comp_aliases(nodes, aliases)
                        for n in nodes:
                            if not isinstance(n, ast.Call):
                                continue
                            exprs = self._direct_writes(n, mod)
                            callee = self.resolve(n, info, mod)
                            if callee is not None:
                                exprs += self._written_args(n, callee)
                            for e in exprs:
                                _, root = _base(e, local)
                                head = root.split(".")[0] if root else None
                                if head in params and head not in got:
                                    got.add(head)
                                    changed = True
                        _update_aliases(st, aliases)

    # -- the rule --------------------------------------------------------------

    def check_reuse(self, mod: _Module, out: List[Violation]) -> None:
        for info in mod.index.funcs:
            self._reuse_block(info.node.body, {}, {}, info, mod, out)

    def _reuse_block(self, body, active, aliases, info, mod, out):
        """Walk a block in source order: ``active`` maps a name written in
        place to ``(line, writer)``, ``aliases`` a name to what it views.
        Branches are walked apart and joined; a block that always leaves
        (``return``, ``raise``, ``break``, ``continue``) gives None. Loop
        bodies are walked once: a read in the next iteration is not seen."""
        for st in body:
            self._reuse_stmt(st, active, aliases, info, mod, out)
            if isinstance(st, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
                return None
            branches: List[Sequence[ast.stmt]] = []
            fall_through = False
            if isinstance(st, ast.If):
                branches = [st.body, st.orelse]
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                branches, fall_through = [st.body + st.orelse], True
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                branches = [st.body]
            elif isinstance(st, ast.Try) or type(st).__name__ == "TryStar":
                branches = [st.body + st.orelse] + [h.body for h in st.handlers]
            elif type(st).__name__ == "Match":
                branches, fall_through = [c.body for c in st.cases], True
            else:
                continue
            ends = [(dict(active), dict(aliases))] if fall_through else []
            for branch in branches:
                end = self._reuse_block(branch, dict(active), dict(aliases),
                                        info, mod, out)
                if end is not None:
                    ends.append(end)
            if not ends:
                return None
            active, aliases = {}, {}
            for a, al in ends:
                active.update(a)
                aliases.update(al)
            if isinstance(st, ast.Try) and st.finalbody:
                end = self._reuse_block(st.finalbody, active, aliases, info,
                                        mod, out)
                if end is None:
                    return None
                active, aliases = end
        return active, aliases

    def _reuse_stmt(self, st, active, aliases, info, mod, out) -> None:
        """One statement's own nodes: its reads of written names, then its
        bindings, then the writes it makes (a name the statement rebinds is
        not written for later reads)."""
        nodes = list(_own_nodes(st))
        if active:
            for n in nodes:
                if isinstance(n, (ast.Name, ast.Attribute)) \
                        and isinstance(getattr(n, "ctx", None), ast.Load):
                    d = _dotted(n)
                    if d in active:
                        line, writer = active.pop(d)
                        out.append(Violation(
                            "donated-reuse", mod.path, n.lineno, n.col_offset,
                            f"{d!r} was written in place by {writer}() at "
                            f"line {line} and is read again here — rebind it "
                            "in the writing statement (x = f(x, ...)) or pass "
                            "a copy"))
        targets = _stmt_targets(st)
        for t in targets:
            for d in [d for d in active if _covers(t, d)]:
                del active[d]
        local = _comp_aliases(nodes, aliases)
        for n in nodes:
            if not isinstance(n, ast.Call):
                continue
            callee = self.resolve(n, info, mod)
            if callee is None:
                continue
            for e in self._written_args(n, callee):
                name, root = _base(e, local)
                if root is None:
                    continue
                # the name passed, its root, and every other name bound to
                # the root or a part of it
                hit = {name, root} | {a for a, r in aliases.items()
                                      if _covers(root, r) or _covers(r, root)}
                for d in hit:
                    if not any(_covers(t, d) for t in targets):
                        active[d] = (n.lineno, callee.name)
        _update_aliases(st, aliases)


# ---------------------------------------------------------------------------
# allowlist + driver
# ---------------------------------------------------------------------------


def _collect_allowlist(source: str, path: str):
    """line -> (rules, reason); plus bare-suppression violations.

    A suppression comment covers its own line and — when the comment block
    stands alone — every following comment-only continuation line plus the
    first code line after it, so multi-line explanations stay legal.
    """
    allow: Dict[int, Tuple[Set[str], Optional[str]]] = {}
    bare: List[Violation] = []
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _ALLOW_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        # the reason may continue onto following comment-only lines
        reason = m.group(2)
        j = i
        while j < len(lines) and lines[j].strip().startswith("#"):
            if reason is None:
                cont = lines[j].strip().lstrip("#").strip()
                if cont.startswith("--"):
                    cont = cont[2:].strip()
                reason = cont or None
            j += 1
        unknown = {r for r in rules if r != "*" and r not in RULES}
        if unknown:
            bare.append(Violation(
                "bare-allowlist", path, i, 0,
                f"repro-lint suppression names unknown rule(s) "
                f"{sorted(unknown)}"))
        if not reason:
            bare.append(Violation(
                "bare-allowlist", path, i, 0,
                "repro-lint suppression without a ' -- reason': every "
                "allowlisted line must explain itself"))
        entry = (rules, reason)
        allow[i] = entry
        # comment-only suppression: extend through the block to the first
        # code line it annotates
        if line.strip().startswith("#"):
            for k in range(i + 1, j + 2):
                allow.setdefault(k, entry)
    return allow, bare


def _lint_module(mod: _Module, project: _Project):
    allow, bare = _collect_allowlist(mod.source, mod.path)
    raw: List[Violation] = []
    project.check_reuse(mod, raw)
    _check_shard_hygiene(mod, raw)

    violations: List[Violation] = list(bare)
    suppressions: List[Suppression] = []
    for v in sorted(raw, key=lambda v: (v.line, v.col, v.rule)):
        hit = None
        for line in (v.line, v.line - 1):
            entry = allow.get(line)
            if entry and ("*" in entry[0] or v.rule in entry[0]):
                hit = entry
                break
        if hit and hit[1]:
            suppressions.append(Suppression(v.rule, mod.path, v.line, hit[1]))
        elif hit:                      # suppressed but unexplained: already a
            continue                   # bare-allowlist violation on that line
        else:
            violations.append(v)
    return violations, suppressions


def lint_source(source: str, path: str):
    """Lint one module's source on its own (writers from this module only).
    Returns (violations, suppressions); raises SyntaxError."""
    mod = _Module(source, path)
    return _lint_module(mod, _Project([mod]))


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".") and d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(paths: Sequence[str]):
    """Lint every .py file under ``paths``, writers resolved across them;
    returns (violations, suppressions, files_scanned). Raises SyntaxError."""
    modules = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            modules.append(_Module(f.read(), path))
    project = _Project(modules)
    violations: List[Violation] = []
    suppressions: List[Suppression] = []
    for mod in modules:
        v, s = _lint_module(mod, project)
        violations.extend(v)
        suppressions.extend(s)
    return violations, suppressions, len(modules)


def report_dict(violations, suppressions, files_scanned: int,
                paths: Sequence[str]) -> Dict[str, object]:
    return {
        "tool": "repro_torch.analysis.lint",
        "version": 1,
        "paths": list(paths),
        "files_scanned": files_scanned,
        "rules": dict(RULES),
        "ok": not violations,
        "violations": [v.as_dict() for v in violations],
        "suppressions": [s.as_dict() for s in suppressions],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="mesh and in-place hygiene linter (see the module "
                    "docstring for the rules)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report to PATH")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, desc in RULES.items():
            print(f"{name}: {desc}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    try:
        violations, suppressions, count = lint_paths(paths)
    except SyntaxError as e:
        print(f"{e.filename}:{e.lineno}: syntax error: {e.msg}",
              file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report_dict(violations, suppressions, count, paths),
                      f, indent=2)
    if not args.quiet:
        for v in violations:
            print(f"{v.path}:{v.line}:{v.col}: [{v.rule}] {v.message}",
                  file=sys.stderr)
        status = "clean" if not violations else f"{len(violations)} violation(s)"
        print(f"repro-lint: {count} file(s), {status}, "
              f"{len(suppressions)} explained suppression(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
