"""A run without a card exits non-zero and prints no result: the benchmark
has no CPU path."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run(args, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_without_a_result():
    p = run(["--workload", "n-serve-bf16", "--seed", "3000000001", "--seconds", "1",
             "--trace", "0"])
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_workload_exits_nonzero():
    p = run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(["--workload", "n-serve-bf16", "--seed", "1", "--seconds", "1"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "not in this checkout" in p.stderr
