"""BENCHMARK.json against the contract's shape, and every piece it names
found by name."""
import json
import re
import shutil

import pytest

from eaglebench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_manifest_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["eaglebench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in bench["command"])
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in bench["configs"])) == \
        len(bench["configs"])
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                }) == len(bench["end_to_end"]) + len(bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_end_to_end(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_per_layer(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        for c in m.get("workloads", cells):
            assert c in cells
            moved = [e["name"] for e in spec.metrics_of(bench, "end_to_end",
                                                        c)]
            assert m["moves"] in moved, (m["name"], c)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_piece_loads_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"eaglebench/configs/{c['name']}.json"
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"] == w["config"] and w["config"] in configs
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"] and len(w["why"]) <= 200
        spec.mix(w["traffic"])
        assert callable(spec.driver(cell["driver"]).run)
        kinds = {k: spec.metrics_of(bench, k, w["name"])
                 for k in ("end_to_end", "per_layer")}
        assert {"setup_s"} < {m["name"] for m in kinds["end_to_end"]}
        assert kinds["per_layer"]
    for m in bench["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_a_new_cell_is_found_without_edits(tmp_path, monkeypatch):
    tree = tmp_path / "eaglebench"
    shutil.copytree(spec.HERE, tree, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    new = dict(spec.cell("paper-route-open"), why="a later cell")
    (tree / "workloads" / "later-cell.json").write_text(json.dumps(new))
    monkeypatch.setattr(spec, "HERE", tree)
    assert spec.cell("later-cell")["why"] == "a later cell"
    assert spec.mix(new["traffic"]) == json.loads(
        (tree / "traffic" / "mixes" / f"{new['traffic']}.json").read_text())
