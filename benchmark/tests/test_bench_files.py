"""The benchmark's files: BENCHMARK.json against the contract's shapes, and
every cell resolving its configuration, driver and metrics by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark.common import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.config_name == entry["config"] and c.chips == entry["chips"]
    assert c.traffic == entry["traffic"]
    assert (BENCH / "configs" / f"{c.config_name}.json").exists()
    driver = harness.load_module("traffic", c.traffic)
    assert callable(driver.run) and callable(driver.control)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name, unit in c.end_to_end.items():
        assert e2e[name]["unit"] == unit
        assert cell in e2e[name].get("workloads", CELLS)
    layer = {m["name"]: m for m in SPEC["per_layer"]}
    for name in c.per_layer:
        mod = harness.load_module("metrics", name)
        m = layer[name]
        assert (mod.UNIT, mod.SOURCE, mod.MOVES) == (m["unit"], m["source"], m["moves"])
        assert cell in m["workloads"] and m["moves"] in c.end_to_end
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer


def test_every_metric_and_config_is_used():
    used = {n for cell in CELLS for n in harness.load_cell(cell).per_layer}
    assert used == {m["name"] for m in SPEC["per_layer"]}
    assert {harness.load_cell(c).config_name for c in CELLS} == \
        {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"] == []
