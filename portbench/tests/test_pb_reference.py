"""The plain reference against the port's CPU path at small sizes: one
predict (f32 forward, decode, NMS; the int8 reference's calibration)."""
import json

import pytest
import torch

from portbench import harness
from portbench.reference import deploy as R

CFG = {n: json.loads((harness.ROOT / "portbench" / "configs" / f"{n}.json").read_text())
       for n in ("maf-yolo-n",)}


def images(seed, b, img):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, img, img, 3), generator=g, dtype=torch.uint8)


@pytest.fixture(scope="module")
def served():
    """The reference model of N at 128 px with conditioned heads, and the
    port's f32 Evaler on the same weights."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    cfg = CFG["maf-yolo-n"]
    model = R.Model(cfg, None)
    model.sd = R.random_weights(model.layers, 7, "cpu")
    R.condition_heads(model, images(1, 2, 128), 6)
    tree = state_dict_to_train_variables({f"net.{k}": v for k, v in model.sd.items()})
    ev = Evaler(half=False, device="cpu")
    ev.init_model(cfg["graph"], {"params": tree["params"]}, nc=80, folded=True)
    return model, ev


def test_deploy_forward_equals_the_ports(served):
    model, ev = served
    x = images(2, 2, 128)
    for (_, cls, reg), (cl, rg) in zip(ev.forward(x), model.levels(x)):
        assert torch.allclose(cls, torch.sigmoid(cl).permute(0, 2, 3, 1), atol=1e-5)
        assert torch.allclose(reg, rg.permute(0, 2, 3, 1), atol=1e-4)


def test_predict_equals_the_ports(served):
    model, ev = served
    x = images(3, 2, 128)
    got = ev.predict(x)
    scores, boxes = model.decoded(x)
    ref = R.nms(scores, boxes, 0.03, 0.65, 300)
    assert any(len(d["scores"]) for d in ref)
    for i, d in enumerate(ref):
        k = int(got["valid"][i].sum())
        assert k == len(d["scores"])
        assert torch.allclose(got["boxes"][i, :k], d["boxes"], atol=1e-3)
        assert torch.allclose(got["scores"][i, :k], d["scores"], atol=1e-5)
        assert torch.equal(got["classes"][i, :k], d["classes"])


def test_int8_reference_calibrates_as_the_port(served):
    from mafyolo_tpu_torch.core.quant import ptq_calibrate
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    model, _ = served
    batches = [images(4, 2, 128), images(5, 2, 128)]
    tree = state_dict_to_train_variables({f"net.{k}": v for k, v in model.sd.items()})
    port = ptq_calibrate(CFG["maf-yolo-n"]["graph"], 80, {"params": tree["params"]}, batches,
                         max_batches=2, device="cpu")
    quant = model.calibrate(8, batches)

    def leaf(path):
        node = port
        for k in path.split("."):
            node = node[k]
        return float(node["act_amax"])
    for site, amax in quant.amax.items():
        key = "net." + (site[:-len(".conv")] + ".conv" if site.endswith(".conv") else site)
        assert leaf(key) == pytest.approx(float(amax), rel=1e-5), site


def test_detection_gaps_of_identical_sets_are_zero(served):
    from portbench import compare
    model, ev = served
    x = images(6, 2, 128)
    gaps = compare.detections(model, [(x, ev.predict(x))], dict(
        conf_thres=0.03, iou_thres=0.65, max_det=300))
    assert gaps["box_gap_px_max"] < 1e-3 and gaps["score_gap_max"] < 1e-5
    assert gaps["count_gap_max"] == 0
