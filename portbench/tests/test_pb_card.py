"""On the card, at each cell's own size: its control (the reference one
precision below the configuration's, in the program's place) comes out
not correct on three seeds, and so does each fault planted in the program.
Marked `gpu`: it skips without a card."""
import argparse
import json
import time

import pytest

from portbench import faults, harness
from portbench.tests.test_pb_faults import CAUGHT

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SEEDS = (3000000901, 3000000902, 3000000903)
# a seed whose last head level serves detections on the card, so that a
# fault confined to that level changes what is served
FAULT_SEED = 3000002202


def fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(card, workload):
    plan = harness.cell_plan(BENCH, workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{plan['mix']['driver']}.py", "d")
    for seed in SEEDS:
        ctx = harness.Context(plan, argparse.Namespace(seed=seed, seconds=1, trace=0),
                              time.perf_counter())
        assert fails(driver.control(ctx), plan["limits"]), seed


@pytest.mark.gpu
@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in CAUGHT.items() for f in fs])
def test_planted_fault_is_not_correct_at_size(card, workload, fault):
    plan = harness.cell_plan(BENCH, workload)
    with faults.plant(fault, plan["mix"]["driver"]):
        line = harness.run(["--workload", workload, "--seed", str(FAULT_SEED), "--seconds", "1"],
                           time.perf_counter())
    assert line["correct"] is False
