"""Every cell, configuration, traffic mix and metric of ``BENCHMARK.json``
is found by name, and the file keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from perfbench.core import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_text(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end":
                assert _text(e[k]), (e["name"], k)


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        cfg = harness.config(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert harness.driver(cfg["model"]).run
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry = harness.benchmark_cell(cell)
    w = harness.workload(cell)
    assert w["config"] == entry["config"] and w["traffic"] == entry["traffic"]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] == 1
    assert harness.traffic(w["traffic"])["dtype"] in harness.DTYPES
    assert set(w["limits"]) and all(v >= 0 for v in w["limits"].values())
    reported = [m["name"] for s in ("end_to_end", "per_layer")
                for m in harness.metrics_for(BENCH, cell, s)]
    assert {"setup_s", "step_s", "peak_mem_gib"} <= set(reported)
    assert harness.metrics_for(BENCH, cell, "per_layer")


def test_metrics_found_by_name():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert callable(harness.reader(m["name"]).read)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(harness.reader(m["name"]).read)


def test_paths_hold_only_names():
    for p in (ROOT / "perfbench").rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or "/_cache" in rel:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
