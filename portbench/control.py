"""Readings that a cell's limits are set from: for each seed, the program's
numbers from a short run of the cell (its own set-up, window and check),
the control's numbers on the same seed, and, with --fault, the program's
numbers with a fault of portbench/faults.py planted; one JSON line a seed.

    python3 portbench/control.py --workload <cell> --seconds 2 --seeds 11 12 13 \
        [--fault half_batch]

The control is the reference one precision below the mix's, put in the
program's place (drivers/<driver>.py:control); it has to come out as not
correct. Run on the card; the benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, harness  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, default=3,
                   help="plant the faults on the first this many seeds")
    p.add_argument("--fault", action="append", default=[],
                   help="also run the program with this fault (portbench/faults.py) planted")
    a = p.parse_args()
    plan = harness.cell_plan(json.loads((harness.ROOT / "BENCHMARK.json").read_text()),
                             a.workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{plan['mix']['driver']}.py",
                                 "pb_driver")
    for seed in a.seeds:
        args = argparse.Namespace(seed=seed, seconds=a.seconds, trace=0)
        out = {"workload": a.workload, "seed": seed}
        numbers: dict = {}
        line = harness.run(["--workload", a.workload, "--seed", str(seed),
                            "--seconds", str(a.seconds)], time.perf_counter(), numbers=numbers)
        out["program"], out["correct"] = numbers, line["correct"]
        out["metrics"] = {k: v["value"] for k, v in line["metrics"].items()}
        for fault in a.fault if seed in a.seeds[:a.fault_seeds] else []:
            numbers = {}
            with faults.plant(fault, plan["mix"]["driver"]):
                line = harness.run(["--workload", a.workload, "--seed", str(seed),
                                    "--seconds", str(a.seconds)], time.perf_counter(),
                                   numbers=numbers)
            out[fault] = dict(numbers, correct=line["correct"])
        ctx = harness.Context(plan, args, time.perf_counter())
        out["control"] = driver.control(ctx)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
