"""BENCHMARK.json against the contract's limits, and every file it names
found where the harness looks for it."""

import json
import re
from pathlib import Path

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k], (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_and_metrics_fit_the_contract():
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"])
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}
        if m["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_and_reports_enough():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
        assert set(cell.config["check"]["limits"])
        harness.dq_file(cell.config)      # present, with its digest


def test_configs_hold_their_reduced_keys_and_sources():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("gpubench/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert k in cfg and k in cfg["reduced_from"]
        assert cfg["assumed"]


def test_metric_files_are_named_from_metric_names():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "gpubench" / "metrics").glob(
        "*.py")}
    assert named == files
