"""Lock-discipline rules (``lock-*``): a static race detector scoped to
what AST analysis can actually prove. The counterpart of
``photon_ml_tpu/analysis/rules_concurrency.py``, the same checks.

The serving stack is heavily threaded — the MicroBatcher worker, the
watch-dir poller, the drift evaluator, the ``BackgroundSaver`` pools, the
HTTP handler threads — and a worker thread that dies silently is exactly
a concurrency defect no test flags. These rules enforce an
*annotation convention* that makes a class's locking contract checkable:

**The ``guarded-by`` convention.** In ``__init__`` (or the class body),
tag an attribute's initializing assignment with the lock that protects
it::

    self._queue = collections.deque()   # guarded-by: _cond
    self._pending = []                  # guarded-by: _lock

Any lock-like context manager attribute works (``threading.Lock``,
``RLock``, ``Condition``). Two rules then hold:

- ``lock-guarded-write`` — every write to an annotated attribute outside
  ``__init__`` (assignment, augmented assignment, ``self.x[...] = ...``
  subscript stores, and mutating container calls like ``self.x.append``)
  must occur lexically inside ``with self.<lock>:`` of the named lock.
  Lexically: a nested ``def`` resets the check (a closure defined under a
  ``with`` does NOT run under it).
- ``lock-missing-guard`` — any class that starts a ``threading.Thread``,
  constructs a ``ThreadPoolExecutor``, or ``.submit(...)``\\ s work must
  annotate every attribute it mutates outside ``__init__``: in a threaded
  class an unannotated mutation is an undocumented cross-thread write.

Two escape hatches, both deliberate and both visible in the source:

- a method whose name ends in ``_locked`` asserts "caller holds the
  lock" — its writes are exempt (the name is the contract; reqlog's
  ``_take_buffer_locked`` is the canonical example);
- ``# guarded-by: caller`` marks an attribute whose mutation is
  serialized by the owner's lifecycle contract rather than a lock (the
  ``self._thread`` start/stop idiom): the annotation satisfies
  completeness, and no ``with`` is required.

Anything else that is genuinely safe but unprovable (single-writer
stats, trace-time-only state) carries a justified
``# photon-lint: disable=lock-* -- reason`` suppression.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from photon_ml_tpu_torch.analysis.engine import FileContext, rule

GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

#: the "caller serializes mutation" pseudo-lock (lifecycle attributes)
CALLER_GUARD = "caller"

#: container-mutator method names counted as writes to the receiver
MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popleft", "appendleft",
    "clear", "add", "discard", "update", "setdefault", "sort",
})

#: method-name suffix asserting the caller holds the lock
LOCKED_SUFFIX = "_locked"


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.<attr>`` → attr name, else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_thread_launch(node: ast.Call) -> bool:
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name in ("Thread", "ThreadPoolExecutor", "ProcessPoolExecutor"):
        return True
    return isinstance(f, ast.Attribute) and f.attr == "submit"


def _guard_annotations(ctx: FileContext, cls: ast.ClassDef) -> dict[str, str]:
    """``{attr: lock_name}`` from ``# guarded-by:`` comments on attribute
    assignments in ``__init__`` (and class-body assignments)."""
    out: dict[str, str] = {}

    def scan_assign(stmt) -> None:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        attrs = [a for a in (_self_attr(t) for t in targets)
                 if a is not None]
        if not attrs:
            return
        for lineno in range(stmt.lineno, (stmt.end_lineno or stmt.lineno) + 1):
            m = GUARD_RE.search(ctx.line_text(lineno))
            if m:
                for attr in attrs:
                    out[attr] = m.group(1)
                return

    for stmt in cls.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    scan_assign(node)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            scan_assign(stmt)
    return out


def _is_threaded(cls: ast.ClassDef) -> bool:
    return any(isinstance(node, ast.Call) and _is_thread_launch(node)
               for node in ast.walk(cls))


def _with_locks(item_exprs) -> set[str]:
    out = set()
    for expr in item_exprs:
        attr = _self_attr(expr)
        if attr is not None:
            out.add(attr)
    return out


def _iter_writes(body, held: frozenset[str]
                 ) -> Iterator[tuple[str, ast.AST, frozenset[str]]]:
    """Yield ``(attr, node, locks_held)`` for every lexical write to a
    ``self`` attribute under ``body``. ``with self.<lock>:`` adds to the
    held set for its block; entering a nested function RESETS it (the
    closure runs later, lock not held)."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _iter_writes(stmt.body, frozenset())
            continue
        if isinstance(stmt, ast.Lambda):
            continue
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locks = _with_locks(i.context_expr for i in stmt.items)
            yield from _iter_writes(stmt.body, held | locks)
            continue
        # direct writes on this statement itself
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                yield from _target_writes(t, stmt, held)
            if stmt.value is not None:
                yield from _expr_writes(stmt.value, held)
            continue
        # recurse into compound statements (if/for/while/try/match...),
        # scanning their expressions; except-handlers and match-cases are
        # AST nodes that hold statement lists without being statements
        for _, value in ast.iter_fields(stmt):
            for v in (value if isinstance(value, list) else [value]):
                if isinstance(v, ast.stmt):
                    yield from _iter_writes([v], held)
                elif isinstance(v, ast.expr):
                    yield from _expr_writes(v, held)
                elif isinstance(v, ast.AST) and hasattr(v, "body") \
                        and isinstance(getattr(v, "body"), list):
                    yield from _iter_writes(v.body, held)


def _target_writes(t: ast.AST, stmt: ast.AST, held: frozenset[str]
                   ) -> Iterator[tuple[str, ast.AST, frozenset[str]]]:
    attr = _self_attr(t)
    if attr is not None:
        yield attr, stmt, held
        return
    if isinstance(t, ast.Subscript):
        attr = _self_attr(t.value)
        if attr is not None:
            yield attr, stmt, held
        return
    if isinstance(t, (ast.Tuple, ast.List)):
        for elt in t.elts:
            yield from _target_writes(elt, stmt, held)
    if isinstance(t, ast.Starred):
        yield from _target_writes(t.value, stmt, held)


def _expr_writes(expr: ast.expr, held: frozenset[str]
                 ) -> Iterator[tuple[str, ast.AST, frozenset[str]]]:
    """Mutating container calls (``self.x.append(...)``) inside an
    expression tree; nested lambdas reset the held set."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr in MUTATOR_METHODS:
                attr = _self_attr(node.func.value)
                if attr is not None:
                    yield attr, node, held


def _class_methods(cls: ast.ClassDef):
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt


def _check_class(ctx: FileContext, cls: ast.ClassDef):
    annotations = _guard_annotations(ctx, cls)
    threaded = _is_threaded(cls)
    if not annotations and not threaded:
        return
    for method in _class_methods(cls):
        if method.name == "__init__":
            continue
        if method.name.endswith(LOCKED_SUFFIX):
            # name-asserted contract: the caller holds the lock
            continue
        for attr, node, held in _iter_writes(method.body, frozenset()):
            lock = annotations.get(attr)
            if lock == CALLER_GUARD:
                continue
            if lock is not None:
                if lock not in held:
                    yield ctx.finding(
                        "lock-guarded-write", node,
                        f"write to self.{attr} (guarded-by: {lock}) "
                        f"outside `with self.{lock}:` in "
                        f"{cls.name}.{method.name} — either take the "
                        f"lock around the write or rename the method "
                        f"*{LOCKED_SUFFIX} if the caller holds it")
            elif threaded:
                yield ctx.finding(
                    "lock-missing-guard", node,
                    f"{cls.name} runs threads but mutates unannotated "
                    f"self.{attr} outside __init__ (in {method.name}) — "
                    f"annotate its __init__ assignment with "
                    f"`# guarded-by: <lock>` and take that lock here, or "
                    f"`# guarded-by: caller` for lifecycle-serialized "
                    f"state")


@rule("lock-guarded-write",
      "writes to guarded-by-annotated attributes happen under the named "
      "lock", scope="all")
def check_guarded_write(ctx: FileContext):
    for node in ctx.walk():
        if isinstance(node, ast.ClassDef):
            for f in _check_class(ctx, node):
                if f.rule == "lock-guarded-write":
                    yield f


@rule("lock-missing-guard",
      "thread-running classes annotate every attribute they mutate "
      "outside __init__", scope="all")
def check_missing_guard(ctx: FileContext):
    for node in ctx.walk():
        if isinstance(node, ast.ClassDef):
            for f in _check_class(ctx, node):
                if f.rule == "lock-missing-guard":
                    yield f
