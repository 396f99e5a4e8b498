"""The port's lint engine (``photon_ml_tpu_torch/analysis/``) against the
JAX package's (``photon_ml_tpu/analysis/``), fixture by fixture.

Every per-rule fixture of ``tests/test_analysis_engine.py`` runs through
both engines: the reference test itself is called with its ``check``
helper replaced by one that checks the snippet with both, the port's copy
with the path prefix ``photon_ml_tpu/`` and the module prefix
``photon_ml_tpu.`` mapped to the port's. The two must give the same
``(rule, line)`` findings and the same suppressions, and the reference
test's own assertions then run on the port's findings. The same holds
for ``tests/test_photon_lint.py``'s ``tel-retained-vocab`` fixtures; the
project-rule fixtures (synthetic trees) lint the tree as written with the
JAX engine and a mapped copy with the port's, and compare the reports.

The ``trace-*`` fixtures are the exception: the port's boundary is a
CUDA-graph capture, not ``jax.jit``. Each JAX snippet is paired with the
same body registered by ``with torch.cuda.graph(g): self.f(...)`` inside
a class (or handed to ``torch.cuda.make_graphed_callables`` where the
reference passes a callable), laid out so the body keeps its lines; both
must give the same findings at the same lines."""

import inspect
import os
import re
import shutil
import textwrap

import pytest

import test_analysis_engine as ref
import test_photon_lint as ref_lint
from photon_ml_tpu.analysis import engine as j_engine
from photon_ml_tpu_torch.analysis import engine as t_engine

_MODULE_RE = re.compile(r"\bphoton_ml_tpu\b")


def port_path(rel):
    """``photon_ml_tpu/x.py`` → ``photon_ml_tpu_torch/x.py``; a test file
    ``tests/test_x.py`` → ``tests/test_torch_x.py`` (the port's fault
    coverage counts its own tests)."""
    parts = os.path.normpath(rel).split(os.sep)
    if parts[0] == "photon_ml_tpu":
        parts[0] = "photon_ml_tpu_torch"
    elif parts[0] == "tests" and parts[-1].startswith("test_"):
        parts[-1] = "test_torch_" + parts[-1][len("test_"):]
    return os.path.join(*parts)


def port_source(source):
    return _MODULE_RE.sub("photon_ml_tpu_torch", source)


def _checked(engine, source, rel, rule_ids):
    """``(findings, suppressed)`` of one in-memory source, each as sorted
    ``(rule, line)`` pairs, plus the findings themselves."""
    registry = engine.all_rules()
    found, suppressed = engine.check_context(
        engine.FileContext(rel, source), [registry[r] for r in rule_ids],
        registry)
    found.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return ([(f.rule, f.line) for f in found],
            sorted((f.rule, f.line, reason) for f, reason in suppressed),
            found)


def both_engines(source, rel, rule_ids):
    """Check ``source`` with both engines; assert they agree and return
    the port's findings."""
    want, want_sup, _ = _checked(j_engine, source, rel, rule_ids)
    got, got_sup, found = _checked(t_engine, port_source(source),
                                   port_path(rel), rule_ids)
    assert got == want, (rel, rule_ids)
    assert got_sup == want_sup, (rel, rule_ids)
    assert all(f.path == port_path(rel) for f in found)
    return found


def _check_both(source, rules, rel=ref.PKG):
    return both_engines(textwrap.dedent(source), rel, rules)


_PER_RULE = sorted(
    name for name, fn in vars(ref).items()
    if name.startswith("test_") and callable(fn)
    and not name.startswith("test_trace_")
    and "check(" in inspect.getsource(fn))


def test_every_reference_fixture_is_held():
    """The split below covers every fixture of the reference file: the
    per-rule ones here, the trace ones as capture pairs, the project ones
    as trees; the rest test the reference's shims, its own tree and its
    own vocabulary copy, which ``tests/test_torch_lint.py`` holds for the
    port."""
    trace = {n for n in vars(ref) if n.startswith("test_trace_")}
    assert trace == {f"test_{k}" for k in TRACE_PAIRS}
    assert len(_PER_RULE) >= 40
    assert set(_TREES) <= set(vars(ref))


@pytest.mark.parametrize("name", _PER_RULE)
def test_reference_fixture_gives_the_same_findings(name, monkeypatch):
    monkeypatch.setattr(ref, "check", _check_both)
    getattr(ref, name)()


class _BothEnginesOnTrees:
    """Stands in for the reference test's ``engine``: ``run`` lints the
    tree as written with the JAX engine and a copy mapped to the port's
    names with the port's engine, and asserts they agree."""

    def __init__(self, tmp):
        self.tmp = tmp

    def run(self, root, rule_ids=None):
        mapped = os.path.join(self.tmp, "mapped")
        shutil.rmtree(mapped, ignore_errors=True)
        for dirpath, _, filenames in os.walk(root):
            for name in filenames:
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                dst = os.path.join(mapped, port_path(rel))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                with open(dst, "w") as f:
                    f.write(port_source(text) if name.endswith(".py")
                            else text)
        want = j_engine.run(root, rule_ids=rule_ids)
        got = t_engine.run(mapped, rule_ids=rule_ids)

        def keyed(report):
            return ([(f.path, f.line, f.rule) for f in report.findings],
                    [(f.path, f.line, f.rule, reason)
                     for f, reason in report.suppressed])

        (wf, ws), (gf, gs) = keyed(want), keyed(got)
        assert gf == [(port_path(p), line, r) for p, line, r in wf]
        assert gs == [(port_path(p), line, r, why) for p, line, r, why in ws]
        return want


_TREES = ("test_metric_catalog_drift_both_directions",
          "test_metric_catalog_clean_when_in_sync",
          "test_fault_site_coverage_rule", "test_json_report_golden")


@pytest.mark.parametrize("name", _TREES)
def test_reference_tree_gives_the_same_findings(name, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(ref, "engine", _BothEnginesOnTrees(str(tmp_path)))
    tree = tmp_path / "tree"
    tree.mkdir()
    getattr(ref, name)(tree)


_RETAINED = sorted(n for n in vars(ref_lint)
                   if n.startswith("test_retained_vocab"))


class _BothEnginesOnSources:
    @staticmethod
    def check_source(source, rel, rule_ids):
        return both_engines(source, rel, rule_ids)


@pytest.mark.parametrize("name", _RETAINED)
def test_retained_vocab_fixture_gives_the_same_findings(name, monkeypatch):
    assert len(_RETAINED) == 5
    monkeypatch.setattr(ref_lint, "engine", _BothEnginesOnSources)
    getattr(ref_lint, name)()


# --- trace-*: each jit fixture against its capture form

#: reference fixture (without its ``test_`` prefix) → the same bodies on
#: the port's boundary, each offending line where the reference has it
TRACE_PAIRS = {
    "trace_decorated_jit_function_flags_side_effects": """
    import time
    import random
    import numpy as np
    import torch

    class Engine:
        def bad(self, x):
            print("tracing")
            t = time.time()
            r = random.random()
            h = np.asarray(x)
            return x + t + r

        def capture(self, g, x):
            with torch.cuda.graph(g):
                self.out = self.bad(x)
    """,
    "trace_partial_jit_decorator_and_item_and_float_param": """
    import torch

    class Engine:

        def bad(self, x, n):
            v = x.mean().item()
            f = float(x)
            return v + f

        def capture(self, g, x):
            with torch.cuda.graph(g):
                self.out = self.bad(x, 3)
    """,
    "trace_callsite_registration_and_reachability": """
    import numpy as np
    import torch

    def helper(x):
        return np.asarray(x)

    class Engine:
        def entry(self, x):
            return helper(x) + 1

        def capture(self, g, x):
            with torch.cuda.graph(g):
                self.out = self.entry(x)

    def never_captured(x):
        return np.asarray(x)  # fine: not reachable from a capture
    """,
    "trace_jit_vmap_nesting_and_lambda": """
    import time
    import torch

    def solve_one(w):
        time.monotonic()
        return w

    ws = torch.cuda.make_graphed_callables(solve_one, (torch.zeros(2),))
    f = torch.cuda.make_graphed_callables(lambda x: time.time() + x, ())
    """,
    "trace_profile_jit_and_pallas_call": """
    import numpy as np
    import torch
    from torch.cuda import graph as cuda_graph

    def train(x):
        print("side effect")
        return x

    train_fn = torch.cuda.make_graphed_callables((train,), ((x,),))

    def kernel(x_ref, o_ref):
        np.random.rand()
        o_ref[...] = x_ref[...]

    def launch(g, x, o):
        with cuda_graph(g):
            kernel(x, o)
    """,
    "trace_mutable_global_capture_and_global_stmt": """
    import torch

    _CACHE = {}
    _LIMITS = (1, 2)  # immutable: fine to close over

    class Engine:
        def bad(self, x):
            global _TOTAL
            _TOTAL = x
            return x + _CACHE.get("k", 0) + _LIMITS[0]

        def capture(self, g, x):
            with torch.cuda.graph(g):
                self.out = self.bad(x)
    """,
    "trace_method_name_collision_is_not_dragged_in": """
    import numpy as np
    import torch

    def make(g, x):
        def train(x):
            return x

        with torch.cuda.graph(g):
            return train(x)

    class Coordinate:
        def train(self, offsets):
            return np.asarray(offsets)  # host code, not captured
    """,
}


def _reference_snippet(name):
    """The source the reference fixture checks (its ``check`` argument)."""
    seen = []

    def record(source, rules, rel=ref.PKG):
        seen.append(textwrap.dedent(source))
        return j_engine.check_source(textwrap.dedent(source), rel, rules)

    saved = ref.check
    ref.check = record
    try:
        getattr(ref, f"test_{name}")()
    finally:
        ref.check = saved
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name", sorted(TRACE_PAIRS))
def test_trace_fixture_gives_the_same_findings_as_a_capture(name):
    want = j_engine.check_source(_reference_snippet(name), ref.PKG,
                                 ref.TRACE_RULES)
    got = t_engine.check_source(textwrap.dedent(TRACE_PAIRS[name]),
                                port_path(ref.PKG), ref.TRACE_RULES)
    assert [(f.rule, f.line) for f in got] == \
        [(f.rule, f.line) for f in want]
    # the JAX snippet registers nothing on the port's boundary
    assert t_engine.check_source(_reference_snippet(name),
                                 port_path(ref.PKG), ref.TRACE_RULES) == []


def _trace(source):
    return [(f.rule, f.line) for f in t_engine.check_source(
        textwrap.dedent(source), port_path(ref.PKG), ref.TRACE_RULES)]


def test_capture_reaches_methods_through_self():
    # capture → self.step → self._inner (print) and → module helper
    # (clock); another class's _inner of the same name is not reached
    src = """
    import time
    import torch

    def helper(x):
        return time.perf_counter() + x

    class Engine:
        def _inner(self, x):
            print("captured")
            return x

        def step(self, x):
            return self._inner(x) + helper(x)

        def capture(self, g, x):
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                self.out = self.step(x)

    class Other:
        def _inner(self, x):
            print("host code")
            return x
    """
    assert _trace(src) == [("trace-clock", 6), ("trace-print", 10)]


def test_capture_does_not_reach_across_modules():
    # calls into other modules, an imported name and a method of an object
    # that is not self are out of static reach, as in the reference
    src = """
    import torch
    from photon_ml_tpu_torch.serving import store as _store
    from photon_ml_tpu_torch.serving.engine import sum_coordinate_margins

    class Engine:
        def capture(self, g, x, other):
            with torch.cuda.graph(g):
                rows = _store.gather_rows(self.params, x)
                total = sum_coordinate_margins(x, [rows])
                other.bad(total)

        def bad(self, x):
            print("not reached: other.bad is not self.bad")
    """
    assert _trace(src) == []


@pytest.mark.parametrize("spelling", [
    ("import torch", "torch.cuda.graph(g)"),
    ("import torch as t", "t.cuda.graph(g)"),
    ("import torch.cuda", "torch.cuda.graph(g)"),
    ("import torch.cuda as tc", "tc.graph(g)"),
    ("from torch import cuda", "cuda.graph(g)"),
    ("from torch.cuda import graph", "graph(g)"),
])
def test_capture_block_under_every_alias_of_torch_cuda(spelling):
    imp, opener = spelling
    src = f"""
    {imp}

    def capture(g, x):
        with {opener}:
            print("once per capture")
            y = x * 2
    """
    assert _trace(src) == [("trace-print", 6)]


def test_other_with_blocks_are_not_captures():
    src = """
    import torch

    class Engine:
        def warm(self, s, x):
            with torch.cuda.stream(s):
                self.step(x)
            with torch.no_grad():
                self.step(x)

        def step(self, x):
            print("eager")
            return x
    """
    assert _trace(src) == []


def test_once_per_capture_effect_carries_its_suppression():
    src = """
    import torch

    class Engine:
        def body(self, x):
            print("captured")  # photon-lint: disable=trace-print -- counts captures: meant to run once per capture
            return x

        def capture(self, g, x):
            with torch.cuda.graph(g):
                self.out = self.body(x)
    """
    assert _trace(src) == []
