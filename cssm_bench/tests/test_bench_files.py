"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from cssm_bench import cell

BENCH = cell.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cssm_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in cell.metrics_of(BENCH, w, per_layer=False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics_of(BENCH, w, per_layer=True)


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        for name in m["workloads"]:
            e2e = [x["name"] for x in
                   cell.metrics_of(BENCH, cells[name], per_layer=False)]
            assert m["moves"] in e2e, (m["name"], name)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    data = cell.load_json("configs", cfg["name"])
    assert cfg["file"] == f"cssm_bench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] == []
    assert data["assumed"] and data["chips"] == 1


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_traffic_driver_and_metrics_found_by_name(w):
    traffic = cell.load_json("traffic", w["traffic"])
    drv = cell.driver(traffic["driver"])
    for fn in ("setup", "unit", "work", "steps_per_unit", "release", "check",
               "control"):
        assert callable(getattr(drv, fn))
    assert set(traffic["limits"]) and w["chips"] == 1
    for m in (cell.metrics_of(BENCH, w, per_layer=False)
              + cell.metrics_of(BENCH, w, per_layer=True)):
        assert callable(cell.metric(m["name"]).read)


def test_fold_is_deterministic_and_takes_large_seeds():
    big = 2 ** 31 + 12345
    assert cell.fold(big, 1, 2) == cell.fold(big, 1, 2)
    assert cell.fold(big, 1, 2) != cell.fold(big, 1, 3)
    assert 0 <= cell.fold(2 ** 40, 0) < 2 ** 64
