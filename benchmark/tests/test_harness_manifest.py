"""The manifest and the files it names: the contract's keys, names, units
and limits, and that every cell resolves to its configuration, driver and
metric readers by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def text_ok(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    files = [w for w in cmd[1:] if "/" in w or w.endswith(".py")]
    for f in files:
        assert any(f.startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
        assert (ROOT / f).is_file()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert text_ok(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert text_ok(cfg["source"]) and text_ok(cfg["why"])
    path = ROOT / cfg["file"]
    assert cfg["file"].startswith("benchmark/") and path.is_file()
    data = json.loads(path.read_text())
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert len(cfg["reduced"]) <= 16
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert data["source"] == cfg["source"]
    assert (ROOT / "benchmark" / "drivers" / f"{data['driver']}.py").is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and text_ok(cell["why"])
    wl = json.loads((ROOT / "benchmark" / "workloads"
                     / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"] and wl["traffic"] == cell["traffic"]
    assert wl["chips"] == cell["chips"] and wl["why"] == cell["why"]
    # an exact comparison has the limit 0
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    assert (ROOT / "benchmark" / "configs"
            / f"{cell['config']}.json").is_file()
    from benchmark import harness

    e2e = harness.cell_metrics(BENCH, cell["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.cell_metrics(BENCH, cell["name"], trace=True)
    assert per_layer
    for m in e2e + per_layer:
        reader = harness.load_module("metrics", m["name"])
        assert callable(reader.read)
    for m in per_layer:
        assert m["moves"] in names


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert 1 <= len(BENCH["workloads"]) <= 24


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        # a per-layer metric lists the cells whose runs read it
        assert m.get("workloads") and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_spelled_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert text_ok(m["layer"])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_check_time_fits():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_per_layer_metrics_go_only_with_the_cells_they_list():
    from benchmark import harness

    bench = {"end_to_end": [{"name": "setup_s"},
                            {"name": "wall_s", "workloads": ["a", "b"]}],
             "per_layer": [{"name": "k_roofline", "moves": "wall_s",
                            "workloads": ["a"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "a", True)] == [
        "k_roofline"]
    assert harness.cell_metrics(bench, "b", True) == []
    assert [m["name"] for m in harness.cell_metrics(bench, "b", False)] == [
        "setup_s", "wall_s"]
