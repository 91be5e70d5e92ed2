"""The port's benchmark: one run of one cell, driven by BENCHMARK.json.

A cell (a `workloads` entry) names a configuration and a traffic mix. The
harness reads the configuration's file, the mix's file
portbench/traffic/<traffic>.json, and runs the mix's driver,
portbench/drivers/<driver>.py, whose run(ctx) sets up the program, measures
the window and checks what the window produced against the plain reference.
With --trace 1 the window runs under torch.profiler and each per-layer
metric of the cell is read from the traced run's record by its own reader,
portbench/metrics/<metric>.py. Nothing here is specific to one cell: a new
cell, configuration, mix or metric is a new file and a new entry.

The last line of standard output is the result (correct, attempted, failed,
metrics, device, breakdown with --trace 1, and the numbers compared with
their limits under `checks`); the last lines of standard error give each
number compared beside its limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "mafyolo_tpu")
# every build and kernel cache of a run, at fixed paths inside the checkout;
# the port's kernel libraries go to build/kernels/ (its own fixed path)
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
             "TRITON_CACHE_DIR": "build/triton", "CUDA_CACHE_PATH": "build/cuda_cache",
             "TORCHINDUCTOR_CACHE_DIR": "build/inductor"}


class Refused(Exception):
    """A run that cannot give a result: exit non-zero, print none."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Refused(f"missing file {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix, end-to-end and per-layer
    metrics, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    mix_path = HERE / "traffic" / f"{cell['traffic']}.json"
    if not mix_path.is_file():
        raise Refused(f"missing traffic mix {mix_path.relative_to(ROOT)}")
    mix = json.loads(mix_path.read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    return dict(cell=cell, config=config, mix=mix, end_to_end=e2e, per_layer=per_layer,
                limits=limits)


class Context:
    """What a driver gets: the cell's plan, the run's arguments, the
    process's start time, and, from a test, overrides of the mix."""

    def __init__(self, plan, args, t_start, device="cuda", overrides=None):
        self.__dict__.update(plan)
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.t_start, self.device = t_start, device
        self.mix = {**self.mix, **(overrides or {})}

    def sub_seed(self, k: int) -> int:
        """The k-th seed derived from --seed (any whole number)."""
        return (self.seed * 16 + k) % (2 ** 63)


def check_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card and has no CPU path")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(result, chips, device):
    import torch
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": chips,
           "memory_peak_bytes": int(result["memory_peak_bytes"])}
    if "busy_s" in result:
        dev["busy_s"], dev["window_s"] = result["busy_s"], result["window_s"]
    return dev


def read_per_layer(plan, record):
    out = {}
    for m in plan["per_layer"]:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"pb_metric_{len(out)}")
        value = reader.read(record)
        if value is None:
            print(f"portbench: {m['name']} found nothing to read in this run", file=sys.stderr)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(argv, t_start, device="cuda", overrides=None, check=True, numbers=None):
    """One run -> its result line. check=False skips the look for a card
    (the tests' CPU runs); a dict given as `numbers` gets every number the
    check computed, held or not (control.py)."""
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.is_file():
        raise Refused("no BENCHMARK.json at the checkout's root")
    plan = cell_plan(json.loads(bench_path.read_text()), args.workload)
    for key, rel in CACHE_ENV.items():
        os.environ[key] = str(ROOT / rel)
    import torch  # noqa: F401
    marks = {"torch": time.perf_counter() - t_start}
    try:
        import mafyolo_tpu_torch  # noqa: F401
    except ImportError as e:
        raise Refused(f"the program (mafyolo_tpu_torch) is not in this checkout: {e}")
    marks["port"] = time.perf_counter() - t_start
    if check:
        check_card(plan["cell"]["chips"])
    driver = load_module(HERE / "drivers" / f"{plan['mix']['driver']}.py", "pb_driver")
    ctx = Context(plan, args, t_start, device, overrides)
    ctx.marks = marks
    result = driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise Refused(f"the run loaded {', '.join(found)}")
    if ctx.trace:
        metrics = read_per_layer(plan, result["record"])
    else:
        metrics = {m["name"]: {"value": float(result["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in plan["end_to_end"]}
    checks = result["checks"]
    if numbers is not None:
        numbers.update(result["numbers"])
    line = {"correct": all(c["limit"] is not None and c["value"] <= c["limit"]
                               for c in checks.values()),
            "attempted": int(result["attempted"]), "failed": int(result["failed"]),
            "metrics": metrics, "device": device_info(result, plan["cell"]["chips"], device)}
    if ctx.trace and "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    if "setup_phases" in result:
        line["setup_phases"] = result["setup_phases"]
    line["checks"] = checks
    return line


def main(argv, t_start):
    try:
        line = run(argv, t_start)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if "setup_phases" in line:
        print("setup phases (s from the process's start): " + ", ".join(
            f"{k} {v:.3f}" for k, v in line["setup_phases"].items()), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
