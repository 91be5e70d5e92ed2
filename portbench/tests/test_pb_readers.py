"""Each per-layer metric's reader on traced records kept from card runs
(portbench/tests/data/record_<workload>.json: the record with its kernel
table cut to the kernels the readers read and the longest others): it gives
back the number the run printed, and nothing for a record it has nothing to
read in."""
import json
from pathlib import Path

import pytest

from portbench import harness

DATA = Path(__file__).parent / "data"
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
RECORDS = sorted(DATA.glob("record_*.json"))


def load(path):
    workload = path.stem[len("record_"):]
    plan = harness.cell_plan(BENCH, workload)
    kept = json.loads(path.read_text())
    return plan, dict(kept["record"], config=plan["config"]), kept["metrics"]


def reader(name):
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py", "r")


@pytest.mark.parametrize("path", RECORDS, ids=lambda p: p.stem)
def test_readers_give_back_the_recorded_numbers(path):
    plan, record, printed = load(path)
    assert plan["per_layer"]
    for m in plan["per_layer"]:
        assert reader(m["name"]).read(record) == pytest.approx(printed[m["name"]]["value"],
                                                               rel=1e-9), m["name"]


@pytest.mark.parametrize("path", RECORDS, ids=lambda p: p.stem)
def test_readers_of_other_cells_read_nothing(path):
    plan, record, _ = load(path)
    own = {m["name"] for m in plan["per_layer"]}
    for m in BENCH["per_layer"]:
        if m["name"] not in own and not set(m["workloads"]) & {plan["cell"]["name"]}:
            value = reader(m["name"]).read(record)
            assert value is None, m["name"]


def test_shares_stay_under_100():
    for path in RECORDS:
        _, record, printed = load(path)
        for name, v in printed.items():
            if name.endswith("roofline") or "mfu" in name:
                assert 0 < v["value"] <= 100, name


def test_a_record_without_a_trace_reads_nothing():
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace":
            assert reader(m["name"]).read({"steps": 1, "batches": 1}) is None, m["name"]
