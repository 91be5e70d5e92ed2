"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import math
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"})])
def test_entries_have_only_their_keys(section, keys):
    for entry in BENCH[section]:
        assert set(entry) <= keys, entry
        assert set(entry) >= keys - {"workloads"}, entry


def test_names_and_units_use_the_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[section]}) == len(BENCH[section])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_bounds_sources_and_what_each_cell_reports():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    for w in cells:
        plan = harness.cell_plan(BENCH, w)
        reported = {m["name"] for m in plan["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and plan["per_layer"], w
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_a_full_check_fits_its_time():
    cells = 24     # later PRs may add cells up to the contract's most
    per_run = BENCH["run_seconds"] + 60
    total = (2 + 14 * cells) * per_run + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cells_files_are_found_by_name(workload):
    plan = harness.cell_plan(BENCH, workload)
    drivers = ROOT / "portbench" / "drivers"
    assert (drivers / f"{plan['mix']['driver']}.py").is_file()
    for m in plan["per_layer"]:
        reader = harness.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py", "r")
        assert callable(reader.read)
    assert plan["limits"], f"portbench/limits/{workload}.json is missing"
    assert plan["config"]["name"] == plan["cell"]["config"]


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and os.path.isfile(ROOT / f)


def test_stored_flop_counts_match_the_shapes():
    from portbench.reference import deploy as R
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["deploy_flops_per_image"] == 2 * R.count_macs(cfg, cfg["img_size"])
        assert math.isclose(cfg["deploy_flops_per_image"] / 1e9,
                            cfg["published"]["gflops_640"], rel_tol=0.01)
