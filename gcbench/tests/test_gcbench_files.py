"""BENCHMARK.json and the benchmark's data files: every cell, configuration,
traffic mix and metric is found by name, and every name and unit keeps to
the characters the benchmark's contract allows."""
from __future__ import annotations

import json
import os
import re

import pytest

GCBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(GCBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind, name):
    with open(os.path.join(GCBENCH, kind, name + ".json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "gcbench/run.py"]
    assert b["paths"] == ["gcbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_allowed_and_unique(section):
    entries = bench()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for e in entries:
        if "unit" in e:
            assert UNIT.match(e["unit"]), e
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], e


def test_configs_found_by_name():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"gcbench/configs/{c['name']}.json"
        data = load("configs", c["name"])
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


def test_cells_found_by_name():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        data = load("workloads", w["name"])
        for k in ("name", "config", "traffic", "chips", "why"):
            assert data[k] == w[k], (w["name"], k)
        assert w["config"] in configs
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
        mix = load("traffic", w["traffic"])
        assert mix["name"] == w["traffic"]
        assert set(data["limits"]) <= {"bad_lines", "unaligned_share",
                                       "excess_ed"}
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])


def test_metrics_found_by_name():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert os.path.exists(os.path.join(GCBENCH, "metrics",
                                           m["name"] + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(GCBENCH, "metrics",
                                           m["name"] + ".py"))
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_has_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])


def test_roofline_counts_state_their_intensity():
    """The byte counts' arithmetic intensity at the main path's shapes, as
    PERF.md states it: the fragment DP ~55 integer operations a byte
    (F=10248, B=8, S=2, max_in=4), one polish of a 3 kbp read ~360."""
    from gcbench import rooflines as r
    frag = (r.frag_core_ops(10248, 8, 2, 4)
            / r.frag_core_bytes(10248, 8, 2, 4, carried=False))
    pol = r.polish_ops(3000, 3000, 8) / r.polish_bytes(3000, 3000, 3300)
    assert 50 < frag < 60
    assert 330 < pol < 390
    assert r.frag_core_bytes(64, 16, 2, 4, carried=True, want_state=True,
                             want_xcells=True) \
        > r.frag_core_bytes(64, 16, 2, 4, carried=False)
