"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, cell and metric by its file name."""

import json
import re
import shutil

import pytest

from armour_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_limits(man):
    assert set(man) == TOP_KEYS
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16 and man["paths"] == ["armour_bench"]
    assert 1 <= len(man["command"]) <= 32 and all(_one_line(w) for w in man["command"])
    for word in man["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert word.startswith("armour_bench/") and (harness.ROOT / word).is_file()
    s = man["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs of s + 60 s, 2 x 90 s a cell, 1200 spare
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(man):
    names = [m["name"] for m in man["configs"] + man["workloads"] + man["end_to_end"] + man["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({m["name"] for m in man[group]}) == len(man[group])
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"])
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("armour_bench/") and (harness.ROOT / c["file"]).is_file()
    assert len({c["file"] for c in man["configs"]}) == len(man["configs"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])


def test_every_cell_reports_what_its_metrics_move(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in man["end_to_end"]}
    assert e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]]
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_configuration_has_a_cell(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_the_harness_finds_every_file_by_name(man):
    for w in man["workloads"]:
        cell = harness.load_cell(w["name"], man)
        assert cell.config["name"] == w["config"]
        assert set(cell.workload["check"]["limits"]) >= {"t_rad_gap", "cost_gap", "unsafe", "missed"}
        assert cell.workload["entry"] in harness.ENTRIES
        for m in cell.end_to_end:
            assert callable(harness.load_reader("end_to_end", m["name"]))
        for m in cell.per_layer:
            assert callable(harness.load_reader("metrics", m["name"]))
    for c in man["configs"]:
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_a_new_cell_config_and_metric_are_files_alone(man, tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and manifest entries: the harness finds
    them with no edit to a file that is there."""
    bench = tmp_path / "armour_bench"
    for kind in ("configs", "workloads", "traffic", "metrics", "end_to_end"):
        shutil.copytree(harness.BENCH / kind, bench / kind)
    cfg = json.loads((bench / "configs" / "gen3_batch128.json").read_text())
    cfg.update(name="gen3_batch128_s12", planner={**cfg["planner"], "nlp_num_starts": 12})
    (bench / "configs" / "gen3_batch128_s12.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "battery_12obs.json").write_text(json.dumps(
        {"live_obstacles": 12, "pool_batches": 4, "loop": "closed", "clients": 1, "why": "x"}))
    cell = json.loads((bench / "workloads" / "batch128_8obs.json").read_text())
    cell.update(config="gen3_batch128_s12", traffic="battery_12obs")
    (bench / "workloads" / "batch128_12starts.json").write_text(json.dumps(cell))
    (bench / "metrics" / "starts_per_plan.batch.py").write_text("def read(record):\n    return 12.0\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "gen3_batch128_s12", "source": "x", "reduced": [], "why": "x",
                           "file": "armour_bench/configs/gen3_batch128_s12.json"})
    new["workloads"].append({"name": "batch128_12starts", "config": "gen3_batch128_s12",
                             "traffic": "battery_12obs", "chips": 1, "why": "x"})
    for m in new["end_to_end"]:
        if "workloads" in m and "batch128_8obs" in m["workloads"]:
            m["workloads"].append("batch128_12starts")
    new["per_layer"].append({"name": "starts_per_plan.batch", "unit": "starts", "better": "higher",
                             "source": "program_counter", "layer": "solve", "moves": "safe_plans_per_s",
                             "workloads": ["batch128_12starts"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.load_cell("batch128_12starts", harness.manifest(tmp_path))
    assert cell.config["planner"]["nlp_num_starts"] == 12
    assert cell.traffic["live_obstacles"] == 12
    assert [m["name"] for m in cell.end_to_end] == ["safe_plans_per_s", "setup_s"]
    assert "starts_per_plan.batch" in [m["name"] for m in cell.per_layer]
    assert harness.load_reader("metrics", "starts_per_plan.batch")({}) == 12.0
    with pytest.raises(FileNotFoundError):
        harness.load_reader("metrics", "no_such_metric")
