"""Capture-safety rules (``trace-*``): Python side effects inside code
recorded into a CUDA graph — the static half of the zero-recompile and
bit-parity contracts on the card.

The counterpart of ``photon_ml_tpu/analysis/rules_trace.py``, with the
same five rule ids and checks. What changes is the boundary. A jitted JAX
function's Python body runs at trace time only; the port has no tracer,
but it has the same shape of code: a body run once under
``torch.cuda.graph(...)`` and then replayed (the serving engines'
``_score_padded`` and ``_rank_padded``, one graph a padded bucket), or a
callable handed to ``torch.cuda.make_graphed_callables``. Anything impure
there runs once per capture: a print that "works" in a CPU test and never
fires on a replay, a clock or host RNG read baked into every replay, or a
host sync (``.item()``, ``np.asarray`` of a device tensor), which is
illegal while a stream captures and fails the capture outright. None of
those break a CPU test — the CPU path runs the same bodies eagerly — so
they rot silently until the card runs them. These rules walk every
function *reachable from a capture site* in the same module and flag what
AST analysis can actually prove:

- capture sites: the body of ``with torch.cuda.graph(...)`` (any alias of
  ``torch.cuda``, or a from-imported ``graph``) — its statements and every
  function it calls — and the callables passed to
  ``torch.cuda.make_graphed_callables`` (a name, ``self.<method>``, a
  lambda, or a tuple or list of them);
- reachability: same-file calls from captured code to a named function
  (module-level or nested, resolved lexically) or to ``self.<method>``
  (resolved to a method of the enclosing class) mark the callee captured
  too — cross-module reachability is out of static reach and out of
  scope, as in the reference;
- ``trace-print`` — ``print()`` inside captured code;
- ``trace-clock`` — any ``time.*`` call inside captured code;
- ``trace-random`` — stdlib ``random.*`` / ``np.random.*`` calls (host
  RNG state read once at capture; pass an explicit ``torch.Generator`` or
  a device tensor);
- ``trace-host-sync`` — ``.item()`` calls, ``np.asarray``/``np.array``,
  and ``float(x)``/``int(x)`` applied directly to a function parameter
  (almost certainly a device tensor): each forces a device-to-host sync,
  which a capture forbids;
- ``trace-mutable-global`` — a ``global`` statement, or a read of a
  module-level name bound to a mutable literal (``list``/``dict``/``set``
  and friends): the capture records whatever the state held then.

An effect meant to happen once per capture carries a justified
``# photon-lint: disable=trace-* -- reason`` suppression where it lives.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import weakref
from typing import Iterator, Optional

from photon_ml_tpu_torch.analysis.engine import FileContext, rule

#: ``torch.cuda`` attributes that open a capture over a block of code
_CAPTURE_BLOCK_ATTRS = frozenset({"graph"})

#: ``torch.cuda`` attributes that capture the callables they are given
_CAPTURE_CALLABLE_ATTRS = frozenset({"make_graphed_callables"})

#: container constructors whose module-level result is mutable shared state
_MUTABLE_CTORS = frozenset({"list", "dict", "set", "deque", "defaultdict",
                            "OrderedDict", "Counter"})


@dataclasses.dataclass(eq=False)
class _CaptureBlock:
    """The statements of one ``with torch.cuda.graph(...)`` body: captured
    code with no function of its own (no parameters)."""

    body: list
    name: str = "<capture>"


def _head_name(expr: ast.AST) -> Optional[str]:
    """The trailing identifier of a Name/Attribute chain (``torch.cuda.
    graph`` → ``graph``)."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


class _CudaNames:
    """How this file can spell ``torch.cuda.<attr>``: through a binding of
    ``torch`` (``import torch [as t]``, or a bare ``import torch.x``), of
    ``torch.cuda`` itself (``import torch.cuda as c``, ``from torch import
    cuda [as c]``), or a from-imported attribute (``from torch.cuda import
    graph [as g]``)."""

    def __init__(self, ctx: FileContext, attrs: frozenset):
        self.attrs = attrs
        self.torch = ctx.module_aliases("torch") | {
            "torch" for name, asname in ctx.imports
            if name.startswith("torch.") and asname is None}
        self.cuda = (ctx.module_aliases("torch.cuda")
                     | ctx.from_aliases("torch", "cuda"))
        self.names = ctx.from_aliases("torch.cuda", *attrs)

    def match(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if not (isinstance(expr, ast.Attribute) and expr.attr in self.attrs):
            return False
        mod = expr.value
        if isinstance(mod, ast.Name):
            return mod.id in self.cuda
        return (isinstance(mod, ast.Attribute) and mod.attr == "cuda"
                and isinstance(mod.value, ast.Name)
                and mod.value.id in self.torch)


class _Scopes:
    """Lexical scope index: resolve a bare function name at any node the
    way Python would (innermost def outward; class bodies are NOT in the
    chain — a method is never reachable by bare name from nested code),
    and ``self.<name>`` to a method of the enclosing class."""

    def __init__(self, tree: ast.Module):
        scope_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        #: id(node) -> innermost enclosing scope node (None = module)
        self.enclosing: dict[int, Optional[ast.AST]] = {}
        #: scope key -> {name: FunctionDef} of functions DIRECTLY inside
        self.defs: dict[Optional[int], dict[str, ast.AST]] = {None: {}}
        #: id(scope) -> its own enclosing scope
        self._parent: dict[int, Optional[ast.AST]] = {}
        # one breadth-first pass (ast.walk's order, so a later def of a
        # name in the same scope wins as in the reference), each node
        # carrying its innermost enclosing scope
        queue = collections.deque([(tree, None)])
        while queue:
            node, scope = queue.popleft()
            for child in ast.iter_child_nodes(node):
                self.enclosing[id(child)] = scope
                if isinstance(child, scope_types):
                    self._parent[id(child)] = scope
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        key = None if scope is None else id(scope)
                        self.defs.setdefault(key, {})[child.name] = child
                    queue.append((child, child))
                else:
                    queue.append((child, scope))

    def resolve(self, name: str, at: ast.AST) -> Optional[ast.AST]:
        scope = self.enclosing.get(id(at))
        first = True
        while True:
            # class scopes resolve names only for code directly in the
            # class body, never for nested functions (Python scoping)
            if not isinstance(scope, ast.ClassDef) or first:
                fn = self.defs.get(None if scope is None
                                   else id(scope), {}).get(name)
                if fn is not None:
                    return fn
            first = False
            if scope is None:
                return None
            scope = self._parent.get(id(scope))

    def resolve_method(self, name: str, at: ast.AST) -> Optional[ast.AST]:
        """``self.<name>`` at ``at``: the method ``name`` of the nearest
        enclosing class (``at`` lies in one of its methods)."""
        scope = self.enclosing.get(id(at))
        while scope is not None and not isinstance(scope, ast.ClassDef):
            scope = self._parent.get(id(scope))
        if scope is None:
            return None
        return self.defs.get(id(scope), {}).get(name)

    def callee(self, call: ast.Call) -> Optional[ast.AST]:
        """The same-file function a call reaches: by bare name, or as
        ``self.<method>``."""
        f = call.func
        if isinstance(f, ast.Name):
            return self.resolve(f.id, call)
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self"):
            return self.resolve_method(f.attr, call)
        return None


def _callable_args(arg: ast.AST) -> Iterator[ast.AST]:
    """The callables of ``make_graphed_callables``' first argument: one, or
    a tuple or list of them."""
    if isinstance(arg, (ast.Tuple, ast.List)):
        yield from arg.elts
    else:
        yield arg


#: each file's captured regions, computed once for the five rules
_TRACED: "weakref.WeakKeyDictionary[FileContext, list]" = \
    weakref.WeakKeyDictionary()


def traced_functions(ctx: FileContext) -> list:
    """Every captured region of this file: each ``with torch.cuda.graph``
    body, each callable given to ``make_graphed_callables``, and every
    function reachable from them by same-file calls (bare names resolve
    lexically, so a method that merely shares a name with a captured local
    function is not dragged in; ``self.<name>`` resolves to the enclosing
    class's method)."""
    traced = _TRACED.get(ctx)
    if traced is None:
        traced = _TRACED[ctx] = _find_traced(ctx)
    return traced


def _find_traced(ctx: FileContext) -> list:
    scopes = _Scopes(ctx.tree)
    blocks = _CudaNames(ctx, _CAPTURE_BLOCK_ATTRS)
    graphed = _CudaNames(ctx, _CAPTURE_CALLABLE_ATTRS)
    traced: list = []
    seen: set[int] = set()

    def add(node) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            traced.append(node)

    for node in ctx.walk():
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(item.context_expr, ast.Call)
                   and blocks.match(item.context_expr.func)
                   for item in node.items):
                add(_CaptureBlock(node.body))
        elif (isinstance(node, ast.Call) and graphed.match(node.func)
              and node.args):
            for arg in _callable_args(node.args[0]):
                if isinstance(arg, ast.Lambda):
                    add(arg)
                    continue
                fn = None
                if isinstance(arg, ast.Name):
                    fn = scopes.resolve(arg.id, node)
                elif (isinstance(arg, ast.Attribute)
                      and isinstance(arg.value, ast.Name)
                      and arg.value.id == "self"):
                    fn = scopes.resolve_method(arg.attr, node)
                if fn is not None:
                    add(fn)
    # fixed point over same-file calls by name and by self.<method>
    frontier = list(traced)
    while frontier:
        fn = frontier.pop()
        for node in _iter_traced_nodes(fn):
            if isinstance(node, ast.Call):
                callee = scopes.callee(node)
                if callee is not None and id(callee) not in seen:
                    add(callee)
                    frontier.append(callee)
    return traced


def _mutable_globals(tree: ast.Module) -> set[str]:
    """Module-level names bound to a mutable literal or container
    constructor — the closure captures a captured function must not read."""
    out: set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            value = stmt.value
            mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                         ast.ListComp, ast.DictComp,
                                         ast.SetComp))
            if (isinstance(value, ast.Call)
                    and _head_name(value.func) in _MUTABLE_CTORS):
                mutable = True
            if not mutable:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _iter_traced_nodes(fn) -> Iterator[ast.AST]:
    """Walk a captured region's body — nested defs included (they are
    recorded with it when called)."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        yield from ast.walk(stmt)


def _param_names(fn) -> set[str]:
    if isinstance(fn, _CaptureBlock):
        return set()
    args = fn.args
    names = [a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)


def _fn_label(fn) -> str:
    return getattr(fn, "name", "<lambda>")


@rule("trace-print", "no print() inside CUDA-graph-captured code",
      scope="all")
def check_trace_print(ctx: FileContext):
    for fn in traced_functions(ctx):
        for node in _iter_traced_nodes(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield ctx.finding(
                    "trace-print", node,
                    f"print() inside captured function {_fn_label(fn)}() — "
                    f"it runs once per capture (when the CUDA graph is "
                    f"recorded), never on a replay; log outside the "
                    f"capture")


@rule("trace-clock", "no time.* calls inside CUDA-graph-captured code",
      scope="all")
def check_trace_clock(ctx: FileContext):
    time_aliases = ctx.module_aliases("time")
    time_fn_names = ctx.from_aliases("time", "time", "perf_counter",
                                     "monotonic", "sleep", "process_time",
                                     "monotonic_ns", "perf_counter_ns",
                                     "time_ns")
    for fn in traced_functions(ctx):
        for node in _iter_traced_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit = (isinstance(f, ast.Attribute)
                   and isinstance(f.value, ast.Name)
                   and f.value.id in time_aliases) \
                or (isinstance(f, ast.Name) and f.id in time_fn_names)
            if hit:
                yield ctx.finding(
                    "trace-clock", node,
                    f"clock read inside captured function {_fn_label(fn)}() "
                    f"— it runs once per capture, and every replay of the "
                    f"graph keeps that instant; measure outside the capture "
                    f"(registry timers / spans)")


@rule("trace-random",
      "no host RNG (random.* / np.random.*) inside CUDA-graph-captured code",
      scope="all")
def check_trace_random(ctx: FileContext):
    random_aliases = ctx.module_aliases("random")
    np_aliases = ctx.module_aliases("numpy")
    random_fn_names = ctx.from_aliases(
        "random", "random", "randint", "randrange", "uniform", "choice",
        "shuffle", "sample", "gauss", "normalvariate")
    for fn in traced_functions(ctx):
        for node in _iter_traced_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit = False
            if isinstance(f, ast.Attribute):
                v = f.value
                # random.<fn>(...)
                if isinstance(v, ast.Name) and v.id in random_aliases:
                    hit = True
                # np.random.<fn>(...)
                elif (isinstance(v, ast.Attribute) and v.attr == "random"
                      and isinstance(v.value, ast.Name)
                      and v.value.id in np_aliases):
                    hit = True
            elif isinstance(f, ast.Name) and f.id in random_fn_names:
                hit = True
            if hit:
                yield ctx.finding(
                    "trace-random", node,
                    f"host RNG call inside captured function "
                    f"{_fn_label(fn)}() — the draw happens once per capture "
                    f"and every replay reuses it (bit-parity breaks across "
                    f"captures); pass an explicit torch.Generator or a "
                    f"device tensor instead")


@rule("trace-host-sync",
      "no host syncs (.item(), np.asarray, float(param)) inside "
      "CUDA-graph-captured code", scope="all")
def check_trace_host_sync(ctx: FileContext):
    np_aliases = ctx.module_aliases("numpy")
    for fn in traced_functions(ctx):
        params = _param_names(fn)
        for node in _iter_traced_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "item":
                yield ctx.finding(
                    "trace-host-sync", node,
                    f".item() inside captured function {_fn_label(fn)}() — "
                    f"a device-to-host sync, which a stream capture "
                    f"forbids (the capture fails); keep values on device "
                    f"or move the read outside the capture")
            elif (isinstance(f, ast.Attribute)
                  and f.attr in ("asarray", "array")
                  and isinstance(f.value, ast.Name)
                  and f.value.id in np_aliases):
                yield ctx.finding(
                    "trace-host-sync", node,
                    f"np.{f.attr}() inside captured function "
                    f"{_fn_label(fn)}() — materializes the value on the "
                    f"host, which a capture cannot do; use torch.as_tensor "
                    f"on the device or hoist the conversion out of the "
                    f"capture")
            elif (isinstance(f, ast.Name) and f.id in ("float", "int")
                  and len(node.args) == 1
                  and isinstance(node.args[0], ast.Name)
                  and node.args[0].id in params):
                yield ctx.finding(
                    "trace-host-sync", node,
                    f"{f.id}() over parameter {node.args[0].id!r} inside "
                    f"captured function {_fn_label(fn)}() — concretizes a "
                    f"device tensor (a host sync, which fails the "
                    f"capture); keep it a tensor or pass a Python number")


@rule("trace-mutable-global",
      "no mutable module-global capture inside CUDA-graph-captured code",
      scope="all")
def check_trace_mutable_global(ctx: FileContext):
    mutable = _mutable_globals(ctx.tree)
    for fn in traced_functions(ctx):
        local_stores: set[str] = set()
        for node in _iter_traced_nodes(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Store):
                local_stores.add(node.id)
        for node in _iter_traced_nodes(fn):
            if isinstance(node, ast.Global):
                yield ctx.finding(
                    "trace-mutable-global", node,
                    f"`global` inside captured function {_fn_label(fn)}() — "
                    f"writes to module state run once per capture, not per "
                    f"replay; return the value instead")
            elif (isinstance(node, ast.Name)
                  and isinstance(node.ctx, ast.Load)
                  and node.id in mutable and node.id not in local_stores):
                yield ctx.finding(
                    "trace-mutable-global", node,
                    f"captured function {_fn_label(fn)}() reads mutable "
                    f"module global {node.id!r} — the graph records "
                    f"whatever it held at capture (a replay never sees a "
                    f"later mutation, and a recapture changes behavior); "
                    f"pass it as an argument or make it immutable")
