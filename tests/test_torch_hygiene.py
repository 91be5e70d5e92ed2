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


def test_device_aug_trainer_runs_without_decoders(tmp_path):
    """The card's train path: Trainer(device="cpu", dataset_cls=ArrayDataset)
    with --device-aug on 6 images of 64 px (MAF-YOLO-N, bs 4: a full and a
    short batch) -> one epoch (device mosaic, dy_mixup, HSV, flips) ->
    eval_and_save (run_eval on the EMA, last_ckpt.npck) -> strip, with cv2,
    PIL, yaml, matplotlib and tensorboard blocked (an import of any of them
    raises)."""
    code = BLOCK_DECODERS + "sys.modules['tensorboard'] = None\n" + f"""
import os
from types import SimpleNamespace
from mafyolo_tpu_torch.core.engine import Trainer
from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, train_set
args = SimpleNamespace(img_size=64, batch_size=4, epochs=1, workers=2, seed=0,
                       save_dir={str(tmp_path)!r}, device_aug=True, bf16=0,
                       tensorboard=False, stop_aug_last_n_epoch=0)
data = {{"train": train_set(0, 6, size=64, nc=3), "val": eval_set(1, [(64, 64), (48, 64)], nc=3),
         "nc": 3, "names": ["a", "b", "c"]}}
tr = Trainer(args, Config.fromfile("configs/maf_yolo_n.py"), data, device="cpu",
             dataset_cls=ArrayDataset)
assert tr.device_aug["mosaic"] == 1.0 and tr.max_stepnum == 2
tr.train_one_epoch(0)
metrics = tr.eval_and_save(0)
tr.strip_models()
assert tr.state.rng_step == 2 and "AP50" in metrics, metrics
ck = load_checkpoint(os.path.join({str(tmp_path)!r}, "last_ckpt.npck"))
assert ck["ema"] is None and "opt" not in ck
"""
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), cwd=ROOT,
                   timeout=300)


def test_unported_inputs_raise(tmp_path):
    """The train CLI's unported options raise (the Trainer's are in
    tests/test_torch_trainer.py): --quant or --calib without the other
    (QAT through the Trainer, no feature of the JAX CLI either) raises, and
    --quant --calib without --pretrained exits with a message
    (tests/test_torch_quantize_cli.py drives the route itself). A reference
    .pt and --device-count are read and run (tests/test_torch_torch_bridge.py,
    tests/test_torch_ddp.py)."""
    from mafyolo_tpu_torch.tools import train as train_cli
    for argv, match in ((["--quant"], "QAT through the Trainer"),
                        (["--calib"], "QAT through the Trainer")):
        args = train_cli.get_args_parser().parse_args(
            argv + ["--output-dir", str(tmp_path / "runs")])
        with pytest.raises(NotImplementedError, match=match):
            train_cli.main(args)
    args = train_cli.get_args_parser().parse_args(
        ["--quant", "--calib", "--output-dir", str(tmp_path / "runs")])
    with pytest.raises(SystemExit, match="requires --pretrained"):
        train_cli.main(args)


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


def test_trainer_and_train_cli_default_to_the_card():
    """Trainer(args, cfg, data_dict) and tools/train.py train on the card
    unless told device="cpu" / --device cpu."""
    import inspect

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.tools import train as train_cli
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert train_cli.get_args_parser().parse_args([]).device == "cuda"
    assert train_cli.get_args_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_quantize_cli_defaults_to_the_card():
    """tools/quantize.py and the quant entry points run on the card unless
    told --device cpu / device="cpu"."""
    import inspect

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.tools import quantize as quantize_cli
    argv = ["--weights", "w.npck", "--data", "d.yaml"]
    assert quantize_cli.get_args_parser().parse_args(argv).device == "cuda"
    assert quantize_cli.get_args_parser().parse_args(argv + ["--device", "cpu"]).device == "cpu"
    for fn in (Q.ptq_calibrate, Q.qat_finetune, Q.quantized_predict_fn, Q.int8_predict_fn,
               Q.quant_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


@pytest.mark.parametrize("kind", ["dense", "dw"])
def test_int8_wrappers_raise_without_their_library(kind, monkeypatch, tmp_path):
    """Given a tensor off the CPU, an int8 conv wrapper builds and launches
    its kernel or raises: with no nvcc to build it, it raises, and never
    computes the plain version. (A meta tensor stands in for a CUDA one
    here, the device checks waived; the card's tests launch the kernels.)"""
    import torch

    from mafyolo_tpu_torch.ops import _build
    from mafyolo_tpu_torch.ops import quant_conv as Q
    w = torch.randn(8, 1, 3, 3) if kind == "dw" else torch.randn(8, 8, 1, 1)
    p = Q.pack(w, torch.zeros(8), torch.tensor(1.0), 1, 1 if kind == "dw" else 0,
               8 if kind == "dw" else 1)
    assert p.kind == kind

    def plain(*a):
        raise AssertionError("the plain version ran for a tensor off the CPU")
    monkeypatch.setattr(Q, "int8_conv_plain", plain)
    monkeypatch.setattr(Q, "_launch_checks", lambda *a: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    x = torch.empty((2, 8, 6, 6), device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Q.int8_conv(x, p)
