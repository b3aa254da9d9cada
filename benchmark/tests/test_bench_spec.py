"""BENCHMARK.json against the contract's shape, and every cell, configuration,
traffic mix and per-layer reader found by its name."""

import json
import re

import pytest

from benchmark import cell

ROOT = cell.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == KEYS
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = len(SPEC["workloads"])
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24 and 1 <= len(SPEC["configs"]) <= 24


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_loads_by_name(workload):
    cell_, config, traffic = cell.load_cell(SPEC, workload)
    assert cell_["config"] == config["name"]
    assert traffic["shard_kb"] > 0 and traffic["contig_kb"] > traffic["shard_kb"]
    for key in ("reads", "samples", "germline", "limits"):
        assert key in config
    warm, measured = cell.shards_of(traffic, traffic["contig_kb"] * 1000)
    assert warm not in measured and len(measured) >= 1
    for m in cell.metrics_of(SPEC, "per_layer", workload):
        assert callable(cell.load_reader(m["name"]))
    assert cell.metrics_of(SPEC, "end_to_end", workload)


def test_every_reader_and_config_file_is_named():
    readers = {p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]}
    files = {c["file"] for c in SPEC["configs"]}
    assert len(files) == len(SPEC["configs"])
    for f in files:
        assert (ROOT / f).exists()


def test_rehearsal_size_comes_from_the_traffic(monkeypatch):
    """A traffic's `rehearsal` sets the size the tests rehearse its cells
    at; without one, `cell.REHEARSAL`, as both traffics of today have."""
    workload = SPEC["workloads"][0]["name"]
    for w in SPEC["workloads"]:
        assert "rehearsal" not in cell.load_cell(SPEC, w["name"])[2]
        assert cell.rehearsal_size(SPEC, w["name"]) == cell.REHEARSAL
    load = cell.load_cell

    def with_rehearsal(spec, name, root=ROOT):
        c, config, traffic = load(spec, name, root)
        return c, config, {**traffic, "rehearsal": {"contig_kb": 12, "shard_kb": 3}}

    monkeypatch.setattr(cell, "load_cell", with_rehearsal)
    assert cell.rehearsal_size(SPEC, workload) == {"contig_kb": 12, "shard_kb": 3}
