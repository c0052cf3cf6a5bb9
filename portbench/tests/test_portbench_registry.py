"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and metric is found by its name, and the file keeps to the contract's
shape."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in bench["workloads"] + bench["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    assert {(w["config"], w["traffic"]) for w in bench["workloads"]} \
        .__len__() == len(bench["workloads"])


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["moves"] for m in bench["per_layer"]}
    assert moves <= set(e2e)


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()[
    "workloads"]])
def test_cell_parts_found_by_name(cell, bench):
    c = harness.Cell(cell, bench)
    assert c.chips == 1
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(c.kind, fn))
    assert callable(c.flops.step_flops) and callable(c.flops.graphs)
    assert callable(c.reference.init_spec) and c.reference.Reference
    assert c.limits
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_module(m["name"]).read)


def test_configs_files(bench):
    for cfg in bench["configs"]:
        assert cfg["file"].startswith("portbench/configs/")
        y = harness.load_yaml(os.path.join(harness.ROOT, cfg["file"]))
        assert y["reduced"] == cfg["reduced"]
        assert any(w["config"] == cfg["name"] for w in bench["workloads"])


def test_command_names_no_outside_file(bench):
    cmd = bench["command"]
    assert len(cmd) <= 32
    assert not any(a.startswith("/") or ".." in a for a in cmd)
    json.dumps(bench)
