"""The port's host-side train augmentations, train sample and train loader
against the JAX package's, on the CPU.

Both packages call the same cv2 and numpy with draws from the same numpy
Generator, so every image, label and segment is held bit for bit. The set:
`make_synth_dataset` (10 images of 72-119 px, 3 classes, textured) whose
label rows are rewritten as 6-point polygons inside their boxes, so that
mosaic carries segments into copy-paste and the mask_refine affine; the
train size is 64 px."""
import pickle
from pathlib import Path

import numpy as np
import pytest

from mafyolo_tpu.data import augment as JA
from mafyolo_tpu.data.datasets import DetectionDataset as JaxDataset
from mafyolo_tpu.data.loader import create_dataloader as jax_create_dataloader
from mafyolo_tpu_torch.data import augment as A
from mafyolo_tpu_torch.data.datasets import DetectionDataset
from mafyolo_tpu_torch.data.loader import create_dataloader
from mafyolo_tpu_torch.utils.config import Config
from mafyolo_tpu_torch.utils.events import load_yaml
from tests.helpers import make_synth_dataset

IMG = 64
HYP = dict(Config.fromfile("configs/maf_yolo_n.py").data_aug)
VARIANTS = {
    "config": {},                                        # mosaic 1, dy_mixup 0.2, copy_paste 0.05
    "mixup": {"mixup": 1.0},                             # every mosaic blends a cached mosaic
    "copy_paste": {"copy_paste": 0.9, "degrees": 10.0, "shear": 5.0},
    "affine": {"mosaic": 0.0, "degrees": 10.0, "shear": 5.0, "flipud": 0.5},
}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synth set with every label row a polygon; -> the train dir."""
    root = tmp_path_factory.mktemp("augment")
    data = load_yaml(make_synth_dataset(root, n_images=10, img_size=96, seed=2,
                                        splits=("train",), noise=6))
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    for lb in sorted((root / "labels" / "train").glob("*.txt")):
        rows = []
        for ln in lb.read_text().split("\n"):
            if ln.strip():
                c, cx, cy, w, h = map(float, ln.split())
                pts = np.stack([cx + 0.45 * w * np.cos(ang), cy + 0.45 * h * np.sin(ang)], 1)
                rows.append(f"{int(c)} " + " ".join(f"{v:.6f}" for v in pts.ravel()))
        lb.write_text("\n".join(rows) + "\n")
    return data["train"]


def _images(seed, n=4, hw=(80, 72)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _labels(seed, n, w, h):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.5, (n, 2))
    wh = rng.uniform(0.1, 0.5, (n, 2))
    return np.concatenate([rng.integers(0, 3, (n, 1)), xy + wh / 2, wh], 1).astype(np.float32)


def test_augment_hsv_mixup_and_albumentations_match_jax():
    for gains in ((0.015, 0.7, 0.4), (0.5, 0.5, 0.5), (0.0, 0.0, 0.0)):
        im, jim = _images(1, 1)[0], _images(1, 1)[0]
        A.augment_hsv(im, _rng(3), *gains)
        JA.augment_hsv(jim, _rng(3), *gains)
        np.testing.assert_array_equal(im, jim)
    ims, lbs = _images(2, 2), [_labels(4, 3, 72, 80), _labels(5, 2, 72, 80)]
    _same(A.mixup(ims[0], lbs[0], ims[1], lbs[1], _rng(6)),
          JA.mixup(ims[0], lbs[0], ims[1], lbs[1], _rng(6)))
    lb = _labels(7, 3, 64, 64)
    _same(A.albumentations_transform(ims[0], lb, 64, _rng(8)),
          JA.albumentations_transform(ims[0], lb, 64, _rng(8)))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(9)
    b1, b2 = rng.uniform(0, 60, (4, 12)), rng.uniform(0, 60, (4, 12))
    b1[2:] += b1[:2]
    b2[2:] += b2[:2]
    np.testing.assert_array_equal(A.box_candidates(b1, b2), JA.box_candidates(b1, b2))
    np.testing.assert_array_equal(A.bbox_ioa(b1.T, b2.T), JA.bbox_ioa(b1.T, b2.T))
    for args in (((80, 72), (64, 64), 10.0, 0.5, 5.0, 0.1), ((128, 128), (64, 64), 0, 0.5, 0, 0.1)):
        _same(A.get_transform_matrix(*args, _rng(10)), JA.get_transform_matrix(*args, _rng(10)))
    segs = [rng.uniform(0, 64, (k, 2)) for k in (3, 7, 12)]
    _same(A.resample_segments(segs, 50), JA.resample_segments(segs, 50))
    for s in segs + [np.full((4, 2), -5.0)]:
        _same(A.segment2box(s, 40, 50), JA.segment2box(s, 40, 50))


@pytest.mark.parametrize("mask_refine", [False, True])
def test_random_affine_and_copy_paste_match_jax(mask_refine):
    im = _images(11, 1, (128, 128))[0]
    lb = _labels(12, 5, 128, 128)
    lb[:, 1:] = np.concatenate([lb[:, 1:3] - lb[:, 3:] / 2, lb[:, 1:3] + lb[:, 3:] / 2], 1) * 128
    segs = [np.stack([np.linspace(r[1], r[3], 5), np.linspace(r[2], r[4], 5)], 1) for r in lb]
    for kw in (dict(degrees=10, translate=.1, scale=.5, shear=5), dict(degrees=0, translate=.1,
                                                                       scale=.5, shear=0)):
        _same(A.random_affine(im.copy(), lb.copy(), [s.copy() for s in segs], _rng(13),
                              new_shape=(64, 64), mask_refine=mask_refine, **kw),
              JA.random_affine(im.copy(), lb.copy(), [s.copy() for s in segs], _rng(13),
                               new_shape=(64, 64), mask_refine=mask_refine, **kw))
    got = A.copy_paste(im.copy(), lb.copy(), [s.copy() for s in segs], 0.9, _rng(14))
    want = JA.copy_paste(im.copy(), lb.copy(), [s.copy() for s in segs], 0.9, _rng(14))
    _same(got, want)
    assert len(got[1]) > len(lb)       # something was pasted


@pytest.mark.parametrize("copy_paste", [0.0, 0.9])
def test_mosaic_augmentation_matches_jax(copy_paste):
    ims = _images(15, 4, (64, 56))
    labels = [_labels(16 + i, 3, 56, 64) for i in range(4)]
    segs = [[np.stack([lb[j, 1] + lb[j, 3] * np.array([-.4, .4, .4, -.4]),
                       lb[j, 2] + lb[j, 4] * np.array([-.4, -.4, .4, .4])], 1)
             for j in range(3)] for lb in labels]
    hyp = dict(HYP, copy_paste=copy_paste)
    args = (IMG, ims, [64] * 4, [56] * 4, labels, hyp)
    got = A.mosaic_augmentation(*args, _rng(20), segments=pickle.loads(pickle.dumps(segs)))
    want = JA.mosaic_augmentation(*args, _rng(20), segments=pickle.loads(pickle.dumps(segs)))
    _same(got, want)
    assert got[0].shape == (IMG, IMG, 3) and len(got[1])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_get_sample_augment_matches_jax(synth, variant):
    """Every sample of two epochs of get_sample(augment=True), in order (the
    cached mosaic of mixup is filled by the calls before it)."""
    hyp = dict(HYP, **VARIANTS[variant])
    ds = DetectionDataset(synth, img_size=IMG, augment=True, hyp=hyp)
    jds = JaxDataset(synth, img_size=IMG, augment=True, hyp=hyp)
    assert all(len(s) for s in ds.segments)
    n_boxes = 0
    for epoch in range(2):
        for i in range(len(ds)):
            key = (0, epoch, i, 0x9E3779B9)
            got = ds.get_sample(i, np.random.default_rng(key))
            want = jds.get_sample(i, np.random.default_rng(key))
            _same(got, want)
            assert got[0].shape == (IMG, IMG, 3)
            n_boxes += len(got[1])
    assert n_boxes > 20
    assert len(ds._mosaic_cache) == len(jds._mosaic_cache)


def test_train_loader_matches_jax(synth):
    """Two epochs of the train loader (augment: shuffled by (seed, epoch),
    drop_last, labels padded to max_labels) equal to the JAX loader's."""
    kw = dict(stride=32, hyp=HYP, augment=True, workers=1, shuffle=True, seed=3, max_labels=12)
    loader, _ = create_dataloader(synth, IMG, 4, **kw)
    jloader, _ = jax_create_dataloader(synth, IMG, 4, **kw)
    assert len(loader) == len(jloader) == 2
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        np.testing.assert_array_equal(loader.shard_order(), jloader.shard_order())
        batches = list(loader)
        assert len(batches) == 2
        for (imgs, lb, shapes), (jimgs, jlb, jshapes) in zip(batches, jloader):
            assert imgs.shape == (4, IMG, IMG, 3) and lb.shape == (4, 12, 5)
            np.testing.assert_array_equal(imgs, jimgs)
            np.testing.assert_array_equal(lb, jlb)
            assert shapes == jshapes == [None] * 4


def test_process_loader_matches_thread_loader(synth):
    """Two spawned workers (the dataset pickled without its lock, each with
    its own mosaic cache) give the thread loader's batches when no sample
    reads the cache (mixup and dy_mixup off)."""
    hyp = dict(HYP, dy_mixup=0.0)
    kw = dict(stride=32, hyp=hyp, augment=True, workers=2, shuffle=True, seed=1)
    got = [b[:2] for b in create_dataloader(synth, IMG, 4, use_processes=True, **kw)[0]]
    want = [b[:2] for b in create_dataloader(synth, IMG, 4, **kw)[0]]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_plot_train_batch_matches_jax():
    """The TensorBoard train-batch grid, bit for bit (cv2 drawing on both)."""
    from mafyolo_tpu.utils.plots import plot_train_batch as jax_plot
    from mafyolo_tpu_torch.utils.plots import plot_train_batch
    imgs = np.stack(_images(30, 5, (64, 64)))
    targets = np.full((5, 6, 5), -1, np.float32)
    for i in range(5):
        targets[i, :3] = _labels(31 + i, 3, 64, 64)
    for kw in ({}, {"names": ["a", "b", "c"], "paths": [f"im{i}.jpg" for i in range(5)]},
               {"max_size": 100}):
        np.testing.assert_array_equal(plot_train_batch(imgs, targets, **kw),
                                      jax_plot(imgs, targets, **kw))
