"""BENCHMARK.json's rules: names, units, metrics reported where they
are listed, the files the harness finds by name, the time budget."""

import os
import re

import pytest

from qrwbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = harness.ROOT


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(ROOT, "BENCHMARK.json")


def reports(metric, cell):
    return harness.listed(metric, cell)


def test_keys_command_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_one_line_texts(bench):
    items = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [it["name"] for it in bench[group]]
        assert len(names) == len(set(names)), group
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for it in bench["configs"] + bench["workloads"] + bench["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in it:
                assert 1 <= len(it[key]) <= 200 and "\n" not in it[key] \
                    and "\t" not in it[key]


def test_configurations(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)


def test_cells(bench):
    pairs = set()
    configs = {c["name"] for c in bench["configs"]}
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(harness.PKG, "traffic",
                                           w["traffic"] + ".json"))
    assert 1 <= len(bench["workloads"]) <= 24
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert os.path.isfile(os.path.join(harness.PKG, "e2e",
                                           m["name"] + ".py"))
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.isfile(os.path.join(harness.PKG, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        # every cell in the list reports the metric it moves
        for cell in m.get("workloads", [w["name"]
                                        for w in bench["workloads"]]):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    # one spelling a layer
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, w["name"]) for m in bench["per_layer"])


def test_time_budget(bench):
    rs = bench["run_seconds"]
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
