"""Whole-tree consistency rules — invariants no single file can prove.
The counterpart of ``photon_ml_tpu/analysis/rules_project.py``.

- ``obs-metric-catalog``: OBSERVABILITY.md's metric catalog and the
  ``photon_*`` families registered with literal names in code must agree
  in BOTH directions. A metric registered but undocumented is a scrape
  nobody can interpret; a documented name no code registers is an
  operator chasing a series that does not exist (dashboards and alerts
  are written from the catalog).
- ``res-fault-coverage``: every site string in
  ``resilience/faults.py::SITES`` must appear in at least one
  ``fault_point``/``fault_value`` injection call site in the package AND
  in at least one test under ``tests/`` — a registered-but-never-
  exercised fault site is resilience coverage that silently is not.

The port's differences:

- the catalog is the reference's ``OBSERVABILITY.md``; the families it
  documents that the port registers nowhere, on purpose, are listed in
  :data:`OMITTED_FAMILIES`, each with its reason. Every other difference
  in either direction is a finding;
- fault coverage counts only the port's own tests
  (``tests/test_torch_*.py``): a JAX test that names a site exercises
  the JAX package's hook, not the port's.
"""

from __future__ import annotations

import ast
import os
import re

from photon_ml_tpu_torch.analysis.engine import Finding, Project, project_rule
from photon_ml_tpu_torch.analysis.rules_telemetry import _factory_calls

OBSERVABILITY_DOC = "OBSERVABILITY.md"
FAULTS_MODULE = os.path.join("photon_ml_tpu_torch", "resilience",
                             "faults.py")

#: this package: its rule tables name families and sites as literals,
#: which must not satisfy the rules themselves
ANALYSIS_PREFIX = os.path.join("photon_ml_tpu_torch", "analysis") + os.sep

#: the tests that count for fault coverage: the port's own
TESTS_DIR = "tests"
TEST_PREFIX = "test_torch_"

#: families the catalog documents that the port does not emit, by design:
#: ``{name: reason}``
OMITTED_FAMILIES = {
    "photon_xla_compiles_total":
        "reads XLA's compile pipeline (jax.monitoring); the port builds "
        "with nvcc and captures CUDA graphs, both counted under "
        "photon_compiles_total{fn}",
    "photon_xla_compile_seconds_total":
        "reads XLA's compile pipeline (jax.monitoring); the port's build "
        "and capture walls are photon_compile_seconds_total{fn}",
}

_METRIC_TOKEN_RE = re.compile(r"photon_[a-z0-9_]+")

#: ``photon_``-prefixed tokens that are not metric families (the package
#: name shows up in paths/imports inside catalog cells)
_NON_METRIC_TOKENS = frozenset({"photon_ml_tpu", "photon_ml_tpu_torch",
                                "photon_lint"})


def _doc_catalog(project: Project) -> dict[str, int]:
    """``{metric_name: first_line}`` from OBSERVABILITY.md's catalog — the
    first cell of every markdown table row (that is the catalog contract:
    a family is documented by owning a row, not by a passing mention in
    prose)."""
    text = project.read_text(OBSERVABILITY_DOC)
    out: dict[str, int] = {}
    if text is None:
        return out
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = stripped.split("|")
        if len(cells) < 2:
            continue
        first = cells[1]
        # strip label selectors: photon_compiles_total{fn="..."} → name
        for token in _METRIC_TOKEN_RE.findall(first.split("{")[0] if "{"
                                              in first else first):
            if token not in _NON_METRIC_TOKENS:
                out.setdefault(token, lineno)
    return out


def _registered_metrics(project: Project) -> dict[str, tuple[str, int]]:
    """``{name: (path, line)}`` of every metric family registered with a
    literal ``photon_*`` name."""
    out: dict[str, tuple[str, int]] = {}
    for ctx in project.contexts.values():
        for call in _factory_calls(ctx):
            if (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                name = call.args[0].value
                if name.startswith("photon_"):
                    out.setdefault(name, (ctx.path, call.lineno))
    return out


def _string_literals(project: Project) -> set[str]:
    out: set[str] = set()
    for ctx in project.contexts.values():
        if ctx.path.startswith(ANALYSIS_PREFIX):
            continue
        for node in ctx.walk():
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                out.add(node.value)
    return out


@project_rule("obs-metric-catalog",
              "OBSERVABILITY.md's metric catalog and literal photon_* "
              "registrations agree both ways")
def check_metric_catalog(project: Project):
    documented = _doc_catalog(project)
    registered = _registered_metrics(project)
    literals = None  # computed lazily — only needed for the doc direction
    for name, (path, line) in sorted(registered.items()):
        if name not in documented:
            yield Finding(
                path, line, "obs-metric-catalog",
                f"metric {name!r} is registered here but missing from "
                f"{OBSERVABILITY_DOC}'s catalog — add a table row (an "
                f"undocumented family is a scrape nobody can interpret)")
    for name, line in sorted(documented.items()):
        if name in registered or name in OMITTED_FAMILIES:
            continue
        if literals is None:
            literals = _string_literals(project)
        # dynamically-named families (registry plumbing) still count as
        # registered if the exact name appears as a literal anywhere
        if name in literals:
            continue
        yield Finding(
            OBSERVABILITY_DOC, line, "obs-metric-catalog",
            f"catalog documents {name!r} but no code registers that "
            f"family — fix the name or drop the row (operators alert on "
            f"series that must exist)")


def _declared_sites(project: Project) -> list[tuple[str, int]]:
    ctx = project.contexts.get(FAULTS_MODULE)
    if ctx is None:
        return []
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "SITES":
                    if isinstance(node.value, (ast.Tuple, ast.List)):
                        return [(elt.value, elt.lineno)
                                for elt in node.value.elts
                                if isinstance(elt, ast.Constant)
                                and isinstance(elt.value, str)]
    return []


def _injection_sites(project: Project) -> set[str]:
    out: set[str] = set()
    for ctx in project.contexts.values():
        if ctx.path == FAULTS_MODULE:
            continue
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in ("fault_point", "fault_value") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.add(node.args[0].value)
    return out


@project_rule("res-fault-coverage",
              "every registered fault site is injected somewhere and "
              "exercised by a test")
def check_fault_coverage(project: Project):
    declared = _declared_sites(project)
    if not declared:
        return
    injected = _injection_sites(project)
    test_texts = [(rel, text) for rel, text in project.iter_texts(TESTS_DIR)
                  if os.path.basename(rel).startswith(TEST_PREFIX)]
    for site, line in declared:
        if site not in injected:
            yield Finding(
                FAULTS_MODULE, line, "res-fault-coverage",
                f"fault site {site!r} is registered in SITES but no "
                f"fault_point/fault_value call injects it — a site the "
                f"framework never visits is chaos coverage that silently "
                f"is not")
        if not any(site in text for _, text in test_texts):
            yield Finding(
                FAULTS_MODULE, line, "res-fault-coverage",
                f"fault site {site!r} appears in no port test (tests/"
                f"{TEST_PREFIX}*.py) — "
                f"a never-exercised site can rot (the hook can drift off "
                f"the code path without any signal)")
