"""The port imports no JAX, and chip_smoke.py refuses to run without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "mafyolo_tpu_torch").rglob("*.py"))
    assert "mafyolo_tpu_torch.ops.frontend" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mafyolo_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT,
                   timeout=300)


def test_port_does_not_import_the_smoke_script():
    """chip_smoke.py drives the package, never the other way round: what the
    two share lives in the package (utils/sample.py, utils/nms_cases.py)."""
    for path in (ROOT / "mafyolo_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not (line.lstrip().startswith(("import ", "from "))
                        and "chip_smoke" in line), f"{path}: {line}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Here (no CUDA device) it exits non-zero with a clear message and no
    result line, from the checkout and from a directory holding only it."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_evaler_defaults_to_the_card():
    """The serving entry point asks for the card unless the caller names
    another device; the CPU tests pass device="cpu"."""
    import torch

    from mafyolo_tpu_torch.core.evaler import Evaler
    assert Evaler().device == torch.device("cuda")
    assert Evaler(device="cpu").device == torch.device("cpu")
