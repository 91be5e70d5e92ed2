"""The port's loader and metrics against the JAX package's, on the CPU:
letterbox, val samples and collated batches (thread and process pools),
the shared label cache, coco_gt/image_id, COCOEvaluator, ap_per_class,
process_batch and ConfusionMatrix. Both packages decode with the same cv2,
so images are compared bit for bit and every metric exactly."""
import numpy as np
import pytest

from mafyolo_tpu.data import augment as jax_augment
from mafyolo_tpu.data import datasets as jax_datasets
from mafyolo_tpu.data.loader import create_dataloader as jax_create_dataloader
from mafyolo_tpu.utils import coco_eval as jax_coco
from mafyolo_tpu.utils import metrics as jax_metrics
from mafyolo_tpu_torch.data import augment, datasets
from mafyolo_tpu_torch.data.loader import create_dataloader
from mafyolo_tpu_torch.utils import coco_eval, metrics
from tests.helpers import make_synth_dataset


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """12 images of 72-119 px (so the loader resizes both ways), with
    textured noise."""
    root = tmp_path_factory.mktemp("synth")
    make_synth_dataset(root, n_images=12, img_size=96, nc=3, seed=3,
                       splits=("val",), noise=6)
    return str(root / "images" / "val")


@pytest.mark.parametrize("hw,new_shape,auto,scaleup,return_int", [
    ((64, 64), 64, False, False, False),          # no resize, no pad
    ((47, 64), 64, False, False, False),          # odd pad: top 8, bottom 9
    ((47, 64), 64, False, False, True),
    ((64, 37), (64, 96), False, False, True),     # odd pads on both sides
    ((50, 80), 64, False, False, False),          # resize down
    ((30, 40), 64, False, False, False),          # no scale-up: pad only
    ((30, 40), 64, False, True, False),           # scale-up: resize
    ((47, 64), (96, 96), True, False, False),     # auto: pad to the stride
    ((61, 90), (64, 96), True, True, True),
])
def test_letterbox_bit_equal(hw, new_shape, auto, scaleup, return_int):
    """Pixels, ratio and pad equal to the JAX letterbox (cv2.copyMakeBorder)."""
    im = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    kw = dict(new_shape=new_shape, auto=auto, scaleup=scaleup, return_int=return_int)
    got, r, pad = augment.letterbox(im, **kw)
    want, r_j, pad_j = jax_augment.letterbox(im, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (r, pad) == (r_j, pad_j)


def _batches(loader):
    return [(imgs.copy(), labels.copy(), shapes) for imgs, labels, shapes in loader]


@pytest.mark.parametrize("rect,rect_bucket,hyp,use_processes", [
    (False, 0, None, False),
    (True, 0, None, False),
    (True, 64, None, False),
    (False, 0, {"test_load_size": 90, "letterbox_return_int": True}, False),
    (True, 0, {"test_load_size": 90, "letterbox_return_int": True}, True),
])
def test_val_batches_equal_jax(synth_dir, rect, rect_bucket, hyp, use_processes):
    """Every collated batch of the val loader (bs 5: a short last batch)
    equal to the JAX loader's: images bit for bit, padded targets and
    shapes exactly; so are the datasets' coco_gt and image ids."""
    kw = dict(img_size=96, batch_size=5, stride=32, hyp=hyp, augment=False,
              rect=rect, pad=0.5, workers=2, shuffle=False, class_names=["a", "b", "c"],
              task="val", use_processes=use_processes, rect_bucket=rect_bucket)
    loader, ds = create_dataloader(synth_dir, **kw)
    jloader, jds = jax_create_dataloader(synth_dir, **kw)
    got, want = _batches(loader), _batches(jloader)
    assert len(got) == len(want) == 3
    for (im, lb, sh), (im_j, lb_j, sh_j) in zip(got, want):
        np.testing.assert_array_equal(im, im_j)
        np.testing.assert_array_equal(lb, lb_j)
        assert repr(sh) == repr(sh_j)
    if rect:
        np.testing.assert_array_equal(ds.batch_shapes, jds.batch_shapes)
    assert ds.img_paths == jds.img_paths
    assert [ds.image_id(i) for i in range(len(ds))] == \
        [jds.image_id(i) for i in range(len(jds))]
    assert ds.coco_gt() == jds.coco_gt()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_label_cache_shared(tmp_path, monkeypatch, writer):
    """One package writes .labels_cache.npz; the other reads it without
    opening an image header (check_image made to raise) and gets the same
    labels and shapes."""
    make_synth_dataset(tmp_path, n_images=4, img_size=64, nc=3, seed=5, splits=("val",))
    img_dir = str(tmp_path / "images" / "val")
    first, second = ((jax_datasets, datasets) if writer == "jax"
                     else (datasets, jax_datasets))
    ds_first = first.DetectionDataset(img_dir, img_size=64)
    assert (tmp_path / "images" / "val" / ".labels_cache.npz").exists()

    def no_scan(path):
        raise AssertionError("scanned an image instead of reading the cache")
    monkeypatch.setattr(second, "check_image", no_scan)
    ds_second = second.DetectionDataset(img_dir, img_size=64)
    assert ds_second.img_paths == ds_first.img_paths
    np.testing.assert_array_equal(ds_second.shapes, ds_first.shapes)
    for a, b in zip(ds_second.labels, ds_first.labels):
        np.testing.assert_array_equal(a, b)


def _coco_case(seed):
    """GT over 6 images and 3 classes with boxes in every area range, crowd
    and ignore flags; detections near the GT and at random, scores from
    four values so that ties are common."""
    rng = np.random.default_rng(seed)
    images = [dict(id=i, width=640, height=480) for i in range(6)]
    anns, dets = [], []
    for i in range(6):
        for _ in range(int(rng.integers(3, 9))):
            side = float(rng.choice([12.0, 20.0, 50.0, 80.0, 150.0]))
            x, y = rng.uniform(0, 400, 2)
            box = [float(x), float(y), side * rng.uniform(0.7, 1.3), side * rng.uniform(0.7, 1.3)]
            cat = int(rng.integers(0, 3))
            ann = dict(id=len(anns), image_id=i, category_id=cat, bbox=box,
                       area=box[2] * box[3], iscrowd=int(rng.random() < 0.1))
            if rng.random() < 0.05:
                ann["ignore"] = 1
            anns.append(ann)
            for _ in range(int(rng.integers(0, 3))):
                jit = rng.normal(0, 0.1 * side, 4)
                dets.append(dict(image_id=i, category_id=cat,
                                 bbox=[box[0] + jit[0], box[1] + jit[1],
                                       max(box[2] + jit[2], 1.0), max(box[3] + jit[3], 1.0)],
                                 score=float(rng.choice([0.9, 0.6, 0.6, 0.3]))))
        for _ in range(int(rng.integers(0, 5))):
            x, y, w, h = rng.uniform(0, 400), rng.uniform(0, 300), *rng.uniform(5, 120, 2)
            dets.append(dict(image_id=i, category_id=int(rng.integers(0, 3)),
                             bbox=[x, y, w, h], score=float(rng.choice([0.6, 0.3, 0.1]))))
    cats = [dict(id=c, name=str(c)) for c in range(3)]
    return dict(images=images, annotations=anns, categories=cats), dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_equal_jax(seed):
    """All 12 summary numbers, and the precision/recall arrays behind them,
    equal to the JAX evaluator's: every area range, maxDets 1/10/100,
    crowd and ignored GT, tied scores (whose order decides matches)."""
    gt, dets = _coco_case(seed)
    ev = coco_eval.COCOEvaluator(gt, dets)
    got = ev.summarize()
    jev = jax_coco.COCOEvaluator(gt, dets)
    assert got == jev.summarize()
    assert all(v > -1 for v in got.values()), got
    np.testing.assert_array_equal(ev.eval["precision"], jev.eval["precision"])
    np.testing.assert_array_equal(ev.eval["recall"], jev.eval["recall"])
    assert coco_eval.evaluate_coco(gt, dets) == got


def _pr_case(seed, n=300, m=80, nc=5):
    """Detections [n,6] with confidences on a coarse grid (ties) and labels
    [m,5] in a 100x100 image."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (n, 2))
    det = np.concatenate([xy, xy + rng.uniform(4, 20, (n, 2)),
                          rng.integers(1, 20, (n, 1)) / 20.0,
                          rng.integers(0, nc, (n, 1)).astype(float)], -1)
    lxy = rng.uniform(0, 80, (m, 2))
    labels = np.concatenate([rng.integers(0, nc, (m, 1)).astype(float), lxy,
                             lxy + rng.uniform(4, 20, (m, 2))], -1)
    return det, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_pr_metrics_equal_jax(seed):
    """process_batch, ap_per_class (every curve) and ConfusionMatrix.matrix
    equal to the JAX ones on detections with tied confidences."""
    det, labels = _pr_case(seed)
    iouv = np.linspace(0.5, 0.95, 10)
    correct = metrics.process_batch(det, labels, iouv)
    np.testing.assert_array_equal(correct, jax_metrics.process_batch(det, labels, iouv))
    assert correct.any() and not correct.all()
    args = (correct, det[:, 4], det[:, 5], labels[:, 0])
    for got, want in zip(metrics.ap_per_class(*args), jax_metrics.ap_per_class(*args)):
        np.testing.assert_array_equal(got, want)
    cm, jcm = metrics.ConfusionMatrix(nc=5), jax_metrics.ConfusionMatrix(nc=5)
    for lo in range(0, len(det), 60):
        cm.process_batch(det[lo:lo + 60], labels[lo // 4:lo // 4 + 20])
        jcm.process_batch(det[lo:lo + 60], labels[lo // 4:lo // 4 + 20])
    np.testing.assert_array_equal(cm.matrix, jcm.matrix)
    assert cm.matrix.sum() > 0
