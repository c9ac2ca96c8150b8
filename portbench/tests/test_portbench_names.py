"""BENCHMARK.json against the contract's shape rules, and every name it
gives against the files the harness finds by that name."""

import json
import os
import re

import pytest

from portbench.run import HERE, ROOT, load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in b["workloads"]] + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"]) + len(b["per_layer"])


def test_entries_have_only_the_contracts_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in b["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in b["end_to_end"])
    pl = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == pl for m in b["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files_and_reports_what_its_metrics_move(workload):
    cell = load_cell(workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        reader = metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    assert os.path.exists(os.path.join(HERE, "limits", f"{workload}.json"))
    assert os.path.exists(os.path.join(HERE, "drivers", f"{cell['traffic']['driver']}.py"))
    assert cell["config"]["reduced"] == []


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in bench()["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
