"""The port imports no JAX, its eval path runs without the decoders and
plotters that the card's machine lacks, and chip_smoke.py refuses to run
without a card."""
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


# cv2, PIL, PyYAML and matplotlib are absent on the card's machine: with
# them blocked, `import x` raises ImportError
BLOCK_DECODERS = ("import sys\n"
                  "for m in ('cv2', 'PIL', 'yaml', 'matplotlib'): sys.modules[m] = None\n")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "mafyolo_tpu_torch").rglob("*.py"))


def test_port_imports_without_decoders():
    """Every module of the port imports with cv2, PIL, yaml and matplotlib
    blocked: none of them is imported at module level."""
    mods = _port_modules()
    assert "mafyolo_tpu_torch.tools.infer" in mods
    code = BLOCK_DECODERS + ("import importlib\n"
                             f"for m in {mods!r}: importlib.import_module(m)\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT,
                   timeout=300)


def test_eval_path_runs_without_decoders():
    """ArrayDataset -> DataLoader -> Evaler(device="cpu").predict_model ->
    eval_model on 4 tiny images, twice (the second time against the first
    run's own detections, so that AP is high and ap_per_class runs), with
    cv2, PIL, yaml and matplotlib blocked (the PR curves are asked for and
    skipped without matplotlib)."""
    code = BLOCK_DECODERS + """
import numpy as np
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.data.loader import DataLoader
from mafyolo_tpu_torch.utils.bridge import random_folded_variables
from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, labels_from_detections
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
src = eval_set(0, [(64, 64), (48, 64), (64, 48), (64, 36)], nc=3, max_boxes=4)
ev = Evaler({"names": ["a", "b", "c"]}, img_size=64, half=False, do_pr_metric=True,
            plot_curve=True, device="cpu")
folded = random_folded_variables(parse_graph(MODEL_ZOO["maf-yolo-n"], nc=3)[0], seed=0)
ev.init_model("maf-yolo-n", folded, 3, folded=True)
for _ in range(2):
    ev.dataset = ArrayDataset(src, img_size=64, batch_size=2, pad=0.5,
                              class_names=["a", "b", "c"])
    preds = ev.predict_model(DataLoader(ev.dataset, 2, False, workers=2))
    metrics = ev.eval_model(preds)
    # the second pass is scored against the first's own detections
    src = {"images": src["images"],
           "labels": labels_from_detections(preds, ev.dataset, min_score=0.05)}
assert len(preds) > 0 and ev.speed_result[0] == 4, ev.speed_result
assert all(np.isfinite(v) for v in metrics.values()), metrics
# at 64 px many random boxes clip to the whole image, which the one-to-one
# matching of the P/R metric scores low; COCO's matching scores them 1
assert metrics["AP50"] > 0.9 and metrics["P"] > 0 and metrics["mAP50"] > 0, metrics
"""
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT,
                   timeout=300)


def test_unported_inputs_raise(tmp_path):
    """A reference .pt checkpoint and a train-time (augment=True) sample
    raise NotImplementedError, naming the trainer's slice."""
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        load_checkpoint(str(tmp_path / "yolov6n.pt"))
    ds = ArrayDataset(eval_set(0, [(64, 64)], nc=3), img_size=64, augment=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ds.get_sample(0, None)


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
