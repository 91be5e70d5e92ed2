"""A run driven whole but for the look for a card, with the timed path
broken underneath (portbench/faults.py), comes out not correct: on the CPU
at a size a test run holds. The controls at the cells' own size need the
card (test_pb_card.py)."""
import time

import pytest

from portbench import faults, harness

# 256 px, with (anchor, class) pairs over conf dense enough that the last
# head level serves detections
SMALL = {"serve": dict(img=256, batch=4, distinct_batches=2, checked_batches=2,
                       pairs_per_image=80)}
# every cell: half of each batch left out, every answer altered; bf16 also
# one image's answers, and one head level's (int8's own box gaps of one
# image or class reach as far as those faults move them)
CAUGHT = {"n-serve-bf16": ("half_batch", "altered_answer", "one_image", "last_level_stride"),
          "n-serve-int8": ("half_batch", "altered_answer")}
CASES = [(w, "serve", f) for w, fs in CAUGHT.items() for f in fs]


@pytest.mark.parametrize("workload,driver,fault", CASES)
def test_a_planted_fault_is_not_correct(workload, driver, fault):
    with faults.plant(fault, driver):
        line = harness.run(["--workload", workload, "--seed", "3000000001", "--seconds", "0.2"],
                           time.perf_counter(), device="cpu", overrides=SMALL[driver],
                           check=False)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    assert list(line)[-1] == "checks"
