"""The harness finds every configuration, traffic mix, driver and per-layer
metric by its name, and BENCHMARK.json keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from portbench import run, trace

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_traffic_config_and_driver(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl, cfg = run.workload_files(entry["traffic"])
    assert wl["config"] == entry["config"] == cfg["name"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert (run.ROOT / conf["file"]).resolve() == (run.HERE / "configs" / f"{cfg['name']}.json")
    assert hasattr(importlib.import_module(f"portbench.drivers.{wl['driver']}"), "run")
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    _, e2e, layer = run.cell_entries(cell)
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(run.load_metric(metric))


def test_the_front_end_kernel_names_are_data():
    names = trace.kernel_names("frontend")
    assert {"product", "spectrum_rows", "overlap_add"} <= names


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
