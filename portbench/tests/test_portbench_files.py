"""Every configuration, traffic mix and metric that BENCHMARK.json names
is found by its name, and the file keeps to its format: its keys, names,
units, bounds and lengths."""
import importlib
import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("portbench/configs/")
    assert cfg["reduced"] == c["reduced"]
    importlib.import_module(f"portbench.apps.{cfg['kind']}")
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_traffic_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert w["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    reader = importlib.import_module(f"portbench.metrics.{m['name']}")
    assert callable(reader.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"rounds_per_s", "query_p95_ms", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_needs():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer and all(m["moves"] in e2e for m in layer)
