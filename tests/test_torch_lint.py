"""The port's lint over the port's tree, and its CLI (the counterpart of
``tests/test_photon_lint.py``): every pass runs over
``photon_ml_tpu_torch/`` and the root scripts with zero unsuppressed
findings, every suppression carries its reason, and ``python -m
photon_ml_tpu_torch.analysis`` keeps the reference CLI's exit codes (0
clean, 1 findings, 2 the lint failed) and rule catalog. The port-only
parts: the catalog rule's list of omitted families, and fault coverage
counted over the port's own tests."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from photon_ml_tpu.analysis import engine as j_engine
from photon_ml_tpu_torch.analysis import engine
from photon_ml_tpu_torch.analysis import rules_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("chip_smoke.py", "port_tree_report.py")
TRACE_AND_LOCK = ["trace-print", "trace-clock", "trace-random",
                  "trace-host-sync", "trace-mutable-global",
                  "lock-guarded-write", "lock-missing-guard"]


def run_cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


@pytest.fixture(scope="module")
def tree_report():
    return engine.run(REPO)


# --- the tree is clean

def test_every_pass_is_clean_over_the_port_and_its_scripts(tree_report):
    assert tree_report.findings == [], "\n".join(
        f.render() for f in tree_report.findings)
    scanned = set(engine.iter_python_files(REPO))
    assert set(SCRIPTS) <= scanned
    assert all(p.startswith("photon_ml_tpu_torch" + os.sep)
               for p in scanned - set(SCRIPTS))
    assert tree_report.n_files == len(scanned)


def test_every_suppression_in_the_tree_has_a_reason(tree_report):
    missing = []
    for rel in engine.iter_python_files(REPO):
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            ctx = engine.FileContext(rel, f.read())
        missing += [f"{rel}:{s.line}" for s in ctx.suppressions()
                    if not s.reason or len(s.reason.split()) < 3]
    assert missing == []
    assert tree_report.suppressed
    assert all(reason.strip() for _, reason in tree_report.suppressed)


def test_capture_bodies_of_the_engines_are_clean_and_reached():
    """The serving engines' captured bodies are in the trace pass's reach
    (through ``self.``) and hold no finding."""
    from photon_ml_tpu_torch.analysis.rules_trace import traced_functions

    for rel, body in (("serving/engine.py", "_score_padded"),
                      ("retrieval/engine.py", "_rank_padded")):
        path = os.path.join("photon_ml_tpu_torch", rel)
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            ctx = engine.FileContext(path, f.read())
        assert body in {getattr(fn, "name", "") for fn in
                        traced_functions(ctx)}
        assert engine.check_source(ctx.source, path, TRACE_AND_LOCK) == []


@pytest.mark.parametrize("script", SCRIPTS)
def test_trace_and_lock_passes_cover_the_root_scripts(script, tmp_path):
    """The scripts are clean under the ``"all"``-scope passes, and a
    violation added to one is reported there."""
    report = engine.run(REPO, rule_ids=TRACE_AND_LOCK, prefixes=(script,))
    assert report.n_files == 1 and report.findings == []
    with open(os.path.join(REPO, script), encoding="utf-8") as f:
        text = f.read()
    (tmp_path / script).write_text(text + textwrap.dedent("""

        class _Poller:
            def __init__(self):
                self.n = 0
                threading.Thread(target=self.tick).start()

            def tick(self):
                self.n += 1
        """))
    bad = engine.run(str(tmp_path), rule_ids=TRACE_AND_LOCK)
    assert [(f.path, f.rule) for f in bad.findings] == \
        [(script, "lock-missing-guard")]
    # the package-scope hygiene passes stay off the scripts
    assert engine.run(str(tmp_path), rule_ids=["tel-print",
                                                "tel-perf-counter"]) \
        .findings == []


def test_iter_python_files_takes_files_and_directories(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "a.py").write_text("")
    (tmp_path / "pkg" / "b.txt").write_text("")
    (tmp_path / "top.py").write_text("")
    (tmp_path / "notes.txt").write_text("")
    got = list(engine.iter_python_files(
        str(tmp_path), ("pkg", "top.py", "notes.txt", "missing.py")))
    assert got == [os.path.join("pkg", "a.py"), "top.py"]


# --- the catalog is the reference's

def test_rule_catalog_matches_the_reference():
    mine, theirs = engine.all_rules(), j_engine.all_rules()
    assert sorted(mine) == sorted(theirs)
    assert {r: mine[r].scope for r in mine} == \
        {r: theirs[r].scope for r in theirs}
    assert all(r.summary for r in mine.values())


def test_cli_list_rules_gives_the_reference_ids_one_for_one():
    proc = run_cli("--list-rules")
    assert proc.returncode == 0, proc.stderr
    listed = [line.split()[0] for line in proc.stdout.splitlines() if line]
    assert sorted(listed) == sorted(j_engine.all_rules())
    assert len(listed) == len(set(listed))


def test_saturation_vocabulary_copy_matches_the_port():
    from photon_ml_tpu_torch.analysis.rules_telemetry import (
        SATURATION_RESOURCES,
    )
    from photon_ml_tpu_torch.telemetry.saturation import RESOURCES

    assert SATURATION_RESOURCES == frozenset(RESOURCES)


def test_retained_name_pattern_matches_the_port():
    from photon_ml_tpu_torch.analysis.rules_telemetry import (
        RETAINED_NAME_RE,
    )
    from photon_ml_tpu_torch.telemetry.history import SERIES_NAME_RE

    assert RETAINED_NAME_RE.pattern == SERIES_NAME_RE.pattern


# --- the CLI

def _fixture_tree(tmp_path, clean):
    pkg = tmp_path / "photon_ml_tpu_torch"
    pkg.mkdir()
    body = "x = 1\n" if clean else textwrap.dedent("""
        import time
        time.sleep(1)
        try:
            pass
        except:
            pass
    """)
    (pkg / "mod.py").write_text(body)
    (tmp_path / "chip_smoke.py").write_text("print('scripts may print')\n")
    return str(tmp_path)


@pytest.mark.parametrize("case, args, rc", [
    ("clean", [], 0),
    ("findings", [], 1),
    ("findings", ["--rules", "res-bare-except"], 1),
    ("findings", ["--rules", "tel-print"], 0),
    ("clean", ["--rules", "no-such-rule"], 2),
])
def test_cli_exit_codes(tmp_path, case, args, rc):
    root = _fixture_tree(tmp_path, case == "clean")
    proc = run_cli(root, *args)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    if rc == 0:
        assert proc.stdout.strip() == ""
    elif rc == 1:
        assert "finding(s)" in proc.stdout
        assert "res-bare-except" in proc.stdout
        assert ("res-sleep" in proc.stdout) == ("--rules" not in args)
    else:
        assert "internal error" in proc.stderr


def test_cli_json_report(tmp_path):
    root = _fixture_tree(tmp_path, clean=False)
    proc = run_cli(root, "--rules", "res-sleep,res-bare-except", "--json")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc["version"] == 1
    assert doc["counts"] == {"files": 2, "findings": 2, "suppressed": 0}
    assert {f["rule"] for f in doc["findings"]} == {"res-sleep",
                                                    "res-bare-except"}
    assert all(f["path"] == os.path.join("photon_ml_tpu_torch", "mod.py")
               for f in doc["findings"])


def test_cli_clean_over_the_repo():
    proc = run_cli(REPO, "--json")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["counts"]["findings"] == 0
    assert doc["counts"]["suppressed"] > 0


# --- port-only parts of the project rules

def test_omitted_families_are_documented_and_registered_nowhere():
    """The omission list cannot go stale: each family is in the catalog,
    nothing in the port registers it or names it, and it is exactly the
    catalog's families the port does not register."""
    project = engine.Project(REPO, {
        rel: engine.FileContext(rel, open(os.path.join(REPO, rel),
                                          encoding="utf-8").read())
        for rel in engine.iter_python_files(REPO)})
    documented = rules_project._doc_catalog(project)
    registered = rules_project._registered_metrics(project)
    literals = rules_project._string_literals(project)
    omitted = set(rules_project.OMITTED_FAMILIES)
    assert omitted == {"photon_xla_compiles_total",
                       "photon_xla_compile_seconds_total"}
    assert omitted <= set(documented)
    assert not omitted & (set(registered) | literals)
    assert {n for n in documented
            if n not in registered and n not in literals} == omitted
    assert all(len(why.split()) >= 5
               for why in rules_project.OMITTED_FAMILIES.values())


def test_without_the_omissions_the_catalog_rule_reports_them(monkeypatch):
    monkeypatch.setattr(rules_project, "OMITTED_FAMILIES", {})
    report = engine.run(REPO, rule_ids=["obs-metric-catalog"])
    assert sorted(re.search(r"'(photon_[a-z0-9_]+)'", f.message).group(1)
                  for f in report.findings) == [
        "photon_xla_compile_seconds_total", "photon_xla_compiles_total"]
    assert {f.path for f in report.findings} == {"OBSERVABILITY.md"}


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(textwrap.dedent(text))


@pytest.mark.parametrize("tests, reported", [
    ({"test_chaos.py": "io.read"}, True),
    ({"test_chaos.py": "io.read", "test_torch_chaos.py": "other"}, True),
    ({"test_torch_chaos.py": "io.read"}, False),
])
def test_fault_coverage_counts_only_the_port_tests(tmp_path, tests,
                                                   reported):
    root = str(tmp_path)
    _write(root, "photon_ml_tpu_torch/resilience/faults.py", """
    SITES = ("io.read",)

    def fault_point(site, **kw):
        pass
    """)
    _write(root, "photon_ml_tpu_torch/io/reader.py", """
    from photon_ml_tpu_torch.resilience.faults import fault_point

    def read(path):
        fault_point("io.read", path=path)
    """)
    for name, site in tests.items():
        _write(root, f"tests/{name}", f"""
        def test_it():
            assert "{site}"
        """)
    report = engine.run(root, rule_ids=["res-fault-coverage"])
    msgs = [f.message for f in report.findings]
    assert bool(msgs) == reported
    assert all("io.read" in m and "test_torch_" in m for m in msgs)


def test_port_fault_sites_are_all_named_in_port_tests():
    from photon_ml_tpu_torch.resilience.faults import SITES

    texts = []
    tests_dir = os.path.join(REPO, "tests")
    for name in sorted(os.listdir(tests_dir)):
        if re.fullmatch(r"test_torch_.*\.py", name):
            with open(os.path.join(tests_dir, name), encoding="utf-8") as f:
                texts.append(f.read())
    assert [s for s in SITES if not any(s in t for t in texts)] == []
