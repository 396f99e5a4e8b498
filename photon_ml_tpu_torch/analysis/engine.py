"""One static-analysis engine behind every photon lint pass of the port.

Counterpart of ``photon_ml_tpu/analysis/engine.py``, pointed at
``photon_ml_tpu_torch/`` and the port's own scripts at the repo root
(``chip_smoke.py``, ``port_tree_report.py``), which take the place of the
reference's ``tools/`` under the ``"all"``-scope rules:

- **Rule registry**: a rule is a generator function registered with
  :func:`rule` (per-file, receives a :class:`FileContext`) or
  :func:`project_rule` (whole-tree, receives a :class:`Project` — for
  cross-file invariants like doc/catalog drift). Every rule has a stable
  id (``res-*``, ``tel-*``, ``trace-*``, ``lock-*``, ``obs-*``), the
  reference's ids one for one, that findings, ``--rules`` selection and
  suppression comments all use.
- **Findings**: ``path:line rule-id message`` (``Finding.render``) plus
  machine-readable JSON (:meth:`Report.to_json`). The reference's legacy
  ``path:line: message`` spelling belongs to its two hygiene shims, which
  the port does not have.
- **Suppressions**: ``# photon-lint: disable=<rule-id>[,<rule-id>] --
  <reason>`` on the offending line silences that rule THERE; on a
  ``def``/``class`` line it covers the whole lexical body. The
  justification is mandatory — a suppression without one (or naming an
  unknown rule id) is itself a finding (``lint-suppression``), so every
  sanctioned violation carries its why in the source.

Run through ``python -m photon_ml_tpu_torch.analysis`` (see its
``__main__``). The rule catalog and its conventions are the reference's
(ANALYSIS.md); the port's differences are named in each rule module.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Iterator, Mapping, Optional, Sequence

#: scopes a per-file rule may declare: "package" = photon_ml_tpu_torch/
#: only (the hygiene rules — the root scripts print and time on purpose),
#: "all" = photon_ml_tpu_torch/ + the root scripts
SCOPES = ("package", "all")

#: directories and files the engine scans (relative to the repo root)
SCAN_PREFIXES = ("photon_ml_tpu_torch", "chip_smoke.py",
                 "port_tree_report.py")

PACKAGE_PREFIX = "photon_ml_tpu_torch" + os.sep

#: the engine's own rule id for malformed suppression comments
SUPPRESSION_RULE_ID = "lint-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*photon-lint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"(?:\s*--\s*(.*\S))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: where, which rule, and why it matters."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered pass: ``check`` yields :class:`Finding`\\ s."""

    id: str
    summary: str
    scope: str  # "package" | "all" | "project"
    check: Callable[..., Iterable[Finding]]

    @property
    def is_project(self) -> bool:
        return self.scope == "project"


_REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, summary: str, *, scope: str = "package"):
    """Register a per-file rule: ``fn(ctx: FileContext) -> Iterable[Finding]``."""
    if scope not in SCOPES:
        raise ValueError(f"scope must be one of {SCOPES}, got {scope!r}")

    def wrap(fn):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(rule_id, summary, scope, fn)
        return fn

    return wrap


def project_rule(rule_id: str, summary: str):
    """Register a whole-tree rule: ``fn(project: Project) -> Iterable[Finding]``."""

    def wrap(fn):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(rule_id, summary, "project", fn)
        return fn

    return wrap


def all_rules() -> dict[str, Rule]:
    """The full registry (imports the rule modules on first use)."""
    from photon_ml_tpu_torch.analysis import (  # noqa: F401
        rules_concurrency,
        rules_project,
        rules_resilience,
        rules_telemetry,
        rules_trace,
    )

    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# per-file context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Suppression:
    """One ``# photon-lint: disable=...`` comment. ``end_line`` extends the
    cover to a whole ``def``/``class`` body when the comment sits on its
    header line."""

    line: int
    ids: tuple[str, ...]
    reason: Optional[str]
    end_line: int

    def covers(self, finding: Finding) -> bool:
        return (finding.rule in self.ids
                and self.line <= finding.line <= self.end_line)


class FileContext:
    """One parsed source file plus the per-file facts rules share."""

    def __init__(self, rel_path: str, source: str):
        self.path = os.path.normpath(rel_path)
        self.source = source
        self.tree = ast.parse(source, filename=rel_path)
        self.lines = source.splitlines()
        self._nodes: Optional[list] = None
        # raw import facts; each rule resolves the aliases it cares about
        # (the resolution semantics are rule contracts — e.g. a bare
        # `import a.b` binds `a`, so it never aliases the module `a.b`)
        self.imports: list[tuple[str, Optional[str]]] = []
        self.from_imports: list[tuple[str, str, Optional[str]]] = []
        for node in self.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports.append((a.name, a.asname))
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.from_imports.append((node.module or "", a.name,
                                              a.asname))

    def walk(self) -> list:
        """Every node of the tree in ``ast.walk``'s order, listed once per
        file for all the rules that scan it."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    @property
    def in_package(self) -> bool:
        return self.path.startswith(PACKAGE_PREFIX)

    def finding(self, rule_id: str, node: "ast.AST | int",
                message: str) -> Finding:
        line = node if isinstance(node, int) else node.lineno
        return Finding(self.path, line, rule_id, message)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def module_aliases(self, module: str) -> set[str]:
        """Names this file binds to ``module`` via ``import module [as x]``.
        Dotted modules are matched exactly and only contribute their
        ``as`` alias (a bare ``import a.b`` binds ``a``, not ``a.b``)."""
        out = set()
        for name, asname in self.imports:
            if name == module:
                if asname is not None:
                    out.add(asname)
                elif "." not in module:
                    out.add(module)
        return out

    def from_aliases(self, module: str, *names: str) -> set[str]:
        """Local names bound via ``from module import name [as x]``."""
        want = set(names)
        return {asname or name for mod, name, asname in self.from_imports
                if mod == module and name in want}

    def suppressions(self) -> list[Suppression]:
        """Parse suppression comments; header-line comments cover the whole
        ``def``/``class`` body."""
        regions: dict[int, int] = {}
        for node in self.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                regions[node.lineno] = node.end_lineno or node.lineno
        out = []
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            ids = tuple(s.strip() for s in m.group(1).split(","))
            out.append(Suppression(line=i, ids=ids, reason=m.group(2),
                                   end_line=regions.get(i, i)))
        return out


class Project:
    """Whole-tree view handed to project rules: every scanned
    :class:`FileContext` plus raw access to non-Python files (docs,
    tests) under the root."""

    def __init__(self, root: str, contexts: Mapping[str, FileContext]):
        self.root = root
        self.contexts = dict(contexts)

    def read_text(self, rel_path: str) -> Optional[str]:
        path = os.path.join(self.root, rel_path)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            return f.read()

    def iter_texts(self, rel_dir: str,
                   suffix: str = ".py") -> Iterator[tuple[str, str]]:
        """Yield ``(rel_path, text)`` for matching files under ``rel_dir``
        (sorted; used by coverage-style rules over tests/)."""
        base = os.path.join(self.root, rel_dir)
        if not os.path.isdir(base):
            return
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if not name.endswith(suffix):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.normpath(os.path.relpath(path, self.root))
                with open(path, encoding="utf-8") as f:
                    yield rel, f.read()


# ---------------------------------------------------------------------------
# discovery + execution
# ---------------------------------------------------------------------------


def iter_python_files(root: str,
                      prefixes: Sequence[str] = SCAN_PREFIXES,
                      ) -> Iterator[str]:
    """Relative paths of every ``.py`` under ``root/<prefix>`` in a
    deterministic (sorted) order; a prefix naming a ``.py`` file yields
    that file."""
    for prefix in prefixes:
        base = os.path.join(root, prefix)
        if os.path.isfile(base):
            if base.endswith(".py"):
                yield os.path.normpath(prefix)
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.normpath(os.path.relpath(
                        os.path.join(dirpath, name), root))


@dataclasses.dataclass
class Report:
    """One engine run: surviving findings + the suppression audit trail."""

    root: str
    rule_ids: tuple[str, ...]
    findings: list[Finding]
    suppressed: list[tuple[Finding, str]]
    #: how many files the run parsed
    n_files: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps({
            "version": 1,
            "rules": list(self.rule_ids),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [dict(f.to_dict(), reason=reason)
                           for f, reason in self.suppressed],
            "counts": {
                "files": self.n_files,
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
            },
        }, indent=indent, sort_keys=True)


def _sort_key(f: Finding):
    return (f.path, f.line, f.rule, f.message)


def check_context(ctx: FileContext, rules: Sequence[Rule],
                  known_ids: Iterable[str],
                  ) -> tuple[list[Finding], list[tuple[Finding, str]]]:
    """Run per-file rules over one context and apply its suppressions.
    Returns ``(findings, suppressed)`` — malformed suppressions come back
    as ``lint-suppression`` findings."""
    raw: list[Finding] = []
    for r in rules:
        if r.is_project:
            continue
        if r.scope == "package" and not ctx.in_package:
            continue
        raw.extend(r.check(ctx))
    suppressions = ctx.suppressions()
    known = set(known_ids) | {SUPPRESSION_RULE_ID}
    for s in suppressions:
        if s.reason is None:
            raw.append(ctx.finding(
                SUPPRESSION_RULE_ID, s.line,
                "suppression without justification — write `# photon-lint: "
                "disable=<rule-id> -- <why this violation is sanctioned>`"))
        for rid in s.ids:
            if rid not in known:
                raw.append(ctx.finding(
                    SUPPRESSION_RULE_ID, s.line,
                    f"suppression names unknown rule id {rid!r} (see "
                    f"`python -m photon_ml_tpu_torch.analysis "
                    f"--list-rules`)"))
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for f in raw:
        sup = next((s for s in suppressions
                    if s.reason is not None and s.covers(f)), None)
        if sup is None:
            findings.append(f)
        else:
            suppressed.append((f, sup.reason))
    return findings, suppressed


def run(root: str = ".", rule_ids: Optional[Sequence[str]] = None,
        prefixes: Sequence[str] = SCAN_PREFIXES) -> Report:
    """Run the selected rules (default: all) over ``root`` and report."""
    registry = all_rules()
    if rule_ids is None:
        selected = list(registry.values())
    else:
        unknown = [rid for rid in rule_ids if rid not in registry]
        if unknown:
            raise KeyError(f"unknown rule id(s) {unknown}; see --list-rules")
        selected = [registry[rid] for rid in rule_ids]
    contexts: dict[str, FileContext] = {}
    for rel in iter_python_files(root, prefixes):
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            contexts[rel] = FileContext(rel, f.read())
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, str]] = []
    for ctx in contexts.values():
        got, sup = check_context(ctx, selected, registry)
        findings.extend(got)
        suppressed.extend(sup)
    project = Project(root, contexts)
    by_path = {ctx.path: ctx.suppressions() for ctx in contexts.values()}
    for r in selected:
        if not r.is_project:
            continue
        for f in r.check(project):
            sup = next((s for s in by_path.get(f.path, ())
                        if s.reason is not None and s.covers(f)), None)
            if sup is None:
                findings.append(f)
            else:
                suppressed.append((f, sup.reason))
    findings.sort(key=_sort_key)
    suppressed.sort(key=lambda pair: _sort_key(pair[0]))
    return Report(root=root,
                  rule_ids=tuple(r.id for r in selected),
                  findings=findings, suppressed=suppressed,
                  n_files=len(contexts))


def check_source(source: str, rel_path: str,
                 rule_ids: Sequence[str]) -> list[Finding]:
    """Run a rule subset over one in-memory source (the fixture entry
    point; suppressions apply, project rules are not available here)."""
    registry = all_rules()
    ctx = FileContext(rel_path, source)
    findings, _ = check_context(ctx, [registry[rid] for rid in rule_ids],
                                registry)
    findings.sort(key=_sort_key)
    return findings
