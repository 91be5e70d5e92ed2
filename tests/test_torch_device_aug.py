"""The port's device augmentation (data/device_aug.py) against the JAX
package's, f32 on the CPU.

The random streams differ (jax.random against a torch.Generator), so the
port's apply half is held against JAX on the parameters that JAX itself
draws: `torch_common.jax_aug_params` replays device_augment's key splits
(one key per sample, split in 9) and hands the matrices, donors,
centres, gates, partners, beta draws, HSV gains and flips to `apply`.
Tolerances: the affine's inverse and source coordinates bit for bit, a
direct warp 1e-5 against JAX's own warp run alone; apply() against
device_augment 1e-4 (f32; inside device_augment XLA fuses the warp's
arithmetic otherwise than the same warp run alone, 7e-6 apart, and HSV
divides by small channel spreads), labels 1e-5 and in the same row order; against
the JAX default forms for axis-aligned affines (separable matmuls, the
mosaic on a bf16 canvas) the JAX tests' own 1e-4 and 2e-2 / 1e-2
(tests/test_device_aug.py). The rest holds the properties that
tests/test_device_aug.py pins, on the port's own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.data import device_aug as J
from mafyolo_tpu_torch.data import device_aug as D
from torch_common import jax_aug_params

SHIPPED = dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0, hsv_h=0.015, hsv_s=0.7,
               hsv_v=0.4, fliplr=0.5, flipud=0.0, mosaic=1.0, mixup=0.0, dy_label=5,
               dy_mixup=0.2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed, b=4, h=64, n=8):
    """Textured uint8 images with a few solid boxes and their labels."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, h, h, 3), dtype=np.uint8)
    labels = np.full((b, n, 5), -1, np.float32)
    labels[..., 1:] = 0
    for i in range(b):
        for j in range(int(rng.integers(1, 5))):
            wh = rng.uniform(0.1, 0.4, 2)
            c = rng.uniform(wh / 2, 1 - wh / 2)
            x1, y1 = ((c - wh / 2) * h).astype(int)
            x2, y2 = ((c + wh / 2) * h).astype(int)
            imgs[i, y1:y2, x1:x2] = rng.integers(0, 256, 3)
            labels[i, j] = [j % 3, *c, *wh]
    return imgs, labels


def _jax_hsv(img, gains):
    """JAX's HSV jitter of one image by `gains`, op by op (unfused)."""
    hsv = J._rgb_to_hsv(img)
    h = (hsv[..., 0] * gains[0]) % 1.0
    s = jnp.clip(hsv[..., 1] * gains[1], 0, 1)
    v = jnp.clip(hsv[..., 2] * gains[2], 0, 1)
    return J._hsv_to_rgb(jnp.stack([h, s, v], -1))


@pytest.mark.parametrize("cfg,img_tol", [
    # gather warps on both sides (degrees, shear != 0); mosaic, mixup, dynamic
    # mixup, HSV and both flips
    (dict(degrees=5.0, translate=0.1, scale=0.5, shear=3.0, mosaic=0.8, mixup=0.5,
          dy_mixup=0.5, fliplr=0.5, flipud=0.5), 1e-4),
    # the plain affine path (no mosaic)
    (dict(degrees=8.0, translate=0.2, scale=0.3, shear=2.0), 1e-4),
    # the shipped hyps, where JAX takes its separable forms and the bf16
    # canvas; HSV off (it would scale the canvas's rounding by its gain)
    (dict(SHIPPED, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, mixup=0.5), 2e-2),
])
def test_apply_matches_jax_device_augment(cfg, img_tol):
    """JAX's device_augment is run without HSV and its HSV applied after,
    op by op, with the gains it draws: inside device_augment XLA fuses the
    warp into `_rgb_to_hsv`, and the fused `mx == r` misses on about 0.1% of
    pixels (the recomputed channel differs in the last bit), which sends them
    to another hue branch (0.33 off at 64 px); unfused, the same pixel
    takes the port's branch."""
    imgs, labels = _batch(3)
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        want_img, want_lbl = J.device_augment(
            jnp.asarray(imgs), jnp.asarray(labels), key,
            **dict(cfg, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0))
        p = jax_aug_params(key, *imgs.shape[:3], **cfg)
        if "gains" in p:
            want_img = jnp.stack([_jax_hsv(want_img[i], jnp.asarray(p["gains"][i].numpy()))
                                  for i in range(len(imgs))])
        got_img, got_lbl = D.apply(_t(imgs), _t(labels), p)
        np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=img_tol,
                                   rtol=img_tol)
        np.testing.assert_array_equal(got_lbl[..., 0].numpy(), np.asarray(want_lbl)[..., 0])
        np.testing.assert_allclose(got_lbl.numpy(), np.asarray(want_lbl), atol=1e-5, rtol=0)
        if cfg.get("mosaic"):
            assert p["do_mo"].any()


def test_affine_matrix_matches_jax():
    """The matrix from the uniforms `_affine_matrix` draws, for the mosaic
    canvas (input 2s, output s) and the plain path."""
    for seed, (h, w, oh, ow) in enumerate(((128, 128, 64, 64), (64, 96, 64, 96))):
        key = jax.random.PRNGKey(seed)
        want, s_want = J._affine_matrix(key, h, w, 7.0, 0.1, 0.5, 4.0, out_h=oh, out_w=ow)
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        u = [float(jax.random.uniform(k, (), minval=lo, maxval=hi)) for k, (lo, hi) in zip(
            (k1, k2, k3, k4, k5, k6),
            ((-7, 7), (0.5, 1.5), (-4, 4), (-4, 4), (0.4, 0.6), (0.4, 0.6)))]
        got = D.affine_matrix(*(torch.tensor([v]) for v in
                                (u[0], u[1], u[2], u[3], u[4] * ow, u[5] * oh)), h, w)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
        assert abs(u[1] - float(s_want)) < 1e-7


def _m_invs():
    out = []
    for a, sx, sy, sh, tx, ty in ((0.0, 1.1, 0.9, 0.0, -3.0, 5.0), (12.0, 0.6, 0.7, 0.1, 10.0, -8.0),
                                  (-30.0, 1.4, 1.4, -0.2, -20.0, 30.0)):
        c, s = np.cos(np.radians(a)), np.sin(np.radians(a))
        out.append(np.array([[sx * c, -s + sh, tx], [s, sy * c, ty], [0, 0, 1]], np.float32))
    return out


def _drawn_matrices(seed, n, mosaic):
    """n affine matrices as device_augment draws them: the plain affine of
    a 64 px image, or the mosaic's of its 128 px canvas onto 64 px."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    size = 128 if mosaic else 64
    return np.asarray(jax.vmap(lambda k: J._affine_matrix(
        k, size, size, 10.0, 0.2, 0.5, 3.0, out_h=64, out_w=64)[0])(keys))


@pytest.mark.parametrize("mosaic", [False, True])
def test_affine_inverse_and_direct_warp_match_jax(rng, mosaic):
    """The affine in JAX's order: inv3 equals jnp.linalg.inv (jitted, as
    device_augment runs it) bit for bit on 2000 drawn matrices, where
    torch.linalg.inv does not; the source coordinates equal JAX's
    einsum("ij,jhw->ihw") bit for bit; and the image each package warps
    from the same drawn matrix, inverting it itself, within 1e-5 (the
    blend rounds alike to an ulp). Inside device_augment XLA fuses the same
    warp otherwise (7e-6 from JAX's own warp run alone, measured on the
    CPU), so apply() is held to device_augment more loosely above."""
    ms = _drawn_matrices(7 + mosaic, 2000, mosaic)
    want = np.asarray(jax.jit(jax.vmap(jnp.linalg.inv))(ms))
    got = D.inv3(_t(ms)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(torch.linalg.inv(_t(ms)).numpy(), want)

    def coords(m_inv):
        gy, gx = jnp.meshgrid(jnp.arange(64, dtype=jnp.float32),
                              jnp.arange(64, dtype=jnp.float32), indexing="ij")
        return jnp.einsum("ij,jhw->ihw", m_inv, jnp.stack([gx, gy, jnp.ones_like(gx)]))
    src = np.asarray(jax.jit(jax.vmap(coords))(jnp.asarray(want[:64])))
    sx, sy = D._source_coords(_t(want[:64]), 64, 64)
    np.testing.assert_array_equal(sx.numpy(), src[:, 0])
    np.testing.assert_array_equal(sy.numpy(), src[:, 1])

    m = ms[:4]
    if mosaic:
        quad = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
        sources = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 0], [2, 3, 0, 1], [3, 0, 1, 2]])
        xc, yc = rng.integers(32, 96, 4), rng.integers(32, 96, 4)
        got = D.warp_mosaic_bilinear(_t(quad), sources, D.inv3(_t(m)), _t(xc).float(),
                                     _t(yc).float(), 64, 64)
        warp = jax.jit(jax.vmap(lambda q, mm, x, y: J._warp_mosaic_bilinear(
            q, jnp.linalg.inv(mm), x, y, 64, 64, 114.0 / 255.0)))
        want = warp(jnp.asarray(quad[sources.numpy()]), jnp.asarray(m),
                    jnp.asarray(xc, jnp.float32), jnp.asarray(yc, jnp.float32))
    else:
        img = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
        got = D.warp_bilinear(_t(img), D.inv3(_t(m)), 64, 64)
        warp = jax.jit(jax.vmap(lambda im, mm: J._warp_bilinear(
            im, jnp.linalg.inv(mm), 64, 64, 114.0 / 255.0)))
        want = warp(jnp.asarray(img), jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_warps_match_jax_gather_and_default_forms(rng):
    """warp_bilinear and warp_mosaic_bilinear against JAX's gather forms
    (1e-5), and, on axis-aligned maps, against its separable form (1e-4) and
    its bf16 mosaic canvas (2e-2 / 1e-2)."""
    h = w = 48
    img = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    for m_inv in _m_invs():
        got = D.warp_bilinear(_t(img), _t(np.stack([m_inv, m_inv])), h, w, 0.447)
        want = J._warp_bilinear(jnp.asarray(img[1]), jnp.asarray(m_inv), h, w, 0.447)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        if m_inv[0, 1] == m_inv[1, 0] == 0:
            sep = J._warp_axis_aligned(jnp.asarray(img[1]), jnp.asarray(m_inv), h, w, 0.447)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(sep), atol=1e-4, rtol=1e-4)
    s = 32
    quad = rng.uniform(0, 1, (4, s, s, 3)).astype(np.float32)
    sources = torch.tensor([[0, 1, 2, 3], [2, 0, 3, 1]])
    for xc, yc, m_inv in zip((20, 48, 16), (40, 17, 48), _m_invs()):
        m_inv = m_inv.copy()
        got = D.warp_mosaic_bilinear(_t(quad), sources, _t(np.stack([m_inv, m_inv])),
                                     torch.tensor([xc, xc]).float(),
                                     torch.tensor([yc, yc]).float(), s, s, 0.447)
        for i in range(2):
            q = jnp.asarray(quad[sources[i].numpy()])
            want = J._warp_mosaic_bilinear(q, jnp.asarray(m_inv), jnp.float32(xc),
                                           jnp.float32(yc), s, s, 0.447)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
            if m_inv[0, 1] == m_inv[1, 0] == 0:
                canvas = J._mosaic_canvas_axis_aligned(q, jnp.float32(xc), jnp.float32(yc),
                                                       jnp.asarray(m_inv), s, s, 0.447)
                np.testing.assert_allclose(got[i].numpy(), np.asarray(canvas), rtol=2e-2,
                                           atol=1e-2)


def test_hsv_and_label_helpers_match_jax(rng):
    img = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    img[0, :4] = 0.5                                    # gray: zero channel spread
    gains = rng.uniform(0.3, 1.7, (3, 3)).astype(np.float32)
    got = D.hsv_jitter(_t(img), _t(gains))
    for i in range(3):
        hsv = J._rgb_to_hsv(jnp.asarray(img[i]))
        h = (hsv[..., 0] * gains[i, 0]) % 1.0
        s = jnp.clip(hsv[..., 1] * gains[i, 1], 0, 1)
        v = jnp.clip(hsv[..., 2] * gains[i, 2], 0, 1)
        want = J._hsv_to_rgb(jnp.stack([h, s, v], -1))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-5, rtol=0)

    _, labels = _batch(5, b=2, h=64, n=8)
    m = np.array([[0.9, 0.1, 5.0], [-0.05, 1.2, -3.0], [0, 0, 1]], np.float32)
    s_gain = np.float32(1.1)
    got = D.transform_labels(_t(labels), _t(np.stack([m, m])), torch.tensor([s_gain] * 2),
                             64, 64)
    for i in range(2):
        want = J._transform_labels(jnp.asarray(labels[i]), jnp.asarray(m), s_gain, 64, 64)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-5)
    sources = torch.tensor([[0, 1, 1, 0], [1, 1, 0, 0]])
    xc, yc = torch.tensor([40.0, 70.0]), torch.tensor([80.0, 50.0])
    cls, xyxy = D.mosaic_labels_canvas(_t(labels), sources, xc, yc, 64)
    for i in range(2):
        jc, jx = J._mosaic_labels_canvas(jnp.asarray(labels[sources[i].numpy()]),
                                         jnp.float32(xc[i]), jnp.float32(yc[i]), 64)
        np.testing.assert_array_equal(cls[i].numpy(), np.asarray(jc))
        np.testing.assert_allclose(xyxy[i].numpy(), np.asarray(jx), atol=1e-5)
    lbl = np.asarray(rng.uniform(0, 1, (2, 12, 5)), np.float32)
    lbl[..., 0] = np.where(rng.uniform(size=(2, 12)) < 0.5, -1, 2)
    got = D.compact_labels(_t(lbl), 7)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(J._compact_labels(jnp.asarray(lbl[i]), 7)))


# ---------- properties (tests/test_device_aug.py) on the port's own draws ----


def _aug(imgs, labels, seed, **cfg):
    gen = torch.Generator().manual_seed(seed)
    return D.device_augment(_t(imgs), _t(labels), gen, **cfg)


def _plain(**kw):
    return dict(dict(degrees=0.0, translate=0.0, scale=0.0, shear=0.0, hsv_h=0.0, hsv_s=0.0,
                     hsv_v=0.0, fliplr=0.0, flipud=0.0), **kw)


def test_identity_and_fliplr():
    imgs, labels = _batch(7)
    ref = imgs[..., ::-1].astype(np.float32) / 255.0
    out_imgs, out_labels = _aug(imgs, labels, 0, **_plain())
    np.testing.assert_allclose(out_imgs.numpy(), ref, atol=1e-6)
    np.testing.assert_array_equal(out_labels.numpy(), labels)
    out_imgs, out_labels = _aug(imgs, labels, 0, **_plain(fliplr=1.0))
    np.testing.assert_allclose(out_imgs.numpy(), ref[:, :, ::-1], atol=1e-6)
    live = labels[..., 0] >= 0
    np.testing.assert_allclose(out_labels.numpy()[..., 1][live], 1 - labels[..., 1][live],
                               atol=1e-6)
    np.testing.assert_array_equal(out_labels.numpy()[~live], labels[~live])


def test_draw_apply_split_and_reproducibility():
    """device_augment is apply(draw(...)) on the generator's stream; the same
    seed reproduces it bit for bit, and the train step's seeds differ by
    step."""
    imgs, labels = _batch(8)
    cfg = dict(SHIPPED, mixup=0.5, degrees=3.0)
    a = _aug(imgs, labels, 5, **cfg)
    b = _aug(imgs, labels, 5, **cfg)
    p = D.draw(*imgs.shape[:3], torch.Generator().manual_seed(5), **cfg)
    c = D.apply(_t(imgs), _t(labels), p)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert set(p) == {"dy_label", "m", "s", "donors", "xc", "yc", "do_mo", "partner",
                      "u_mix", "u_dy", "r", "gains", "do_lr", "do_ud"}
    assert len({D.aug_seed(0, k) for k in range(50)} | {D.aug_seed(1, 0)}) == 51
    assert not torch.equal(a[0], _aug(imgs, labels, 6, **cfg)[0])
    out_img, out_lbl = a
    live = out_lbl[out_lbl[..., 0] >= 0]
    assert out_img.min() >= 0 and out_img.max() <= 1 + 1e-6
    assert len(live) and live[:, 1:].min() >= 0 and live[:, 1:].max() <= 1


def test_beta_draw_matches_beta_32_32():
    """r is the 32nd smallest of 63 uniforms: mean 1/2, variance 1/260."""
    p = D.draw(20000, 8, 8, torch.Generator().manual_seed(0), mosaic=1.0, mixup=1.0)
    r = p["r"].double()
    assert abs(r.mean().item() - 0.5) < 3e-3 and abs(r.var().item() - 1 / 260) < 3e-4


def test_mosaic_off_keeps_the_unwarped_image_and_p_zero_is_plain():
    imgs, labels = _batch(9)
    cfg = _plain(scale=0.5, translate=0.1)
    a = _aug(imgs, labels, 5, **cfg)
    b = _aug(imgs, labels, 5, **cfg, mosaic=0.0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    p = D.draw(*imgs.shape[:3], torch.Generator().manual_seed(1), **_plain(mosaic=1.0))
    p["do_mo"][:] = False
    img, lbl = D.apply(_t(imgs), _t(labels), p)
    np.testing.assert_allclose(img.numpy(), imgs[..., ::-1] / np.float32(255.0), atol=1e-6)
    np.testing.assert_array_equal(lbl.numpy(), labels)


def test_mosaic_tiles_and_labels():
    b, h = 4, 64
    imgs = np.zeros((b, h, h, 3), np.uint8)
    labels = np.full((b, 8, 5), -1, np.float32)
    labels[..., 1:] = 0
    for i in range(b):
        imgs[i] = (i + 1) * 50
        labels[i, 0] = [i, 0.5, 0.5, 0.5, 0.5]
    oi, ol = _aug(imgs, labels, 3, **_plain(translate=0.1, scale=0.5, mosaic=1.0))
    oi, ol = oi.numpy(), ol.numpy()
    assert oi.shape == (b, h, h, 3) and ol.shape == (b, 8, 5)
    src = np.array([(i + 1) * 50 / 255.0 for i in range(b)])
    assert sum(sum(bool((np.abs(np.unique(oi[i]) - v) < 1e-5).any()) for v in src) >= 2
               for i in range(b)) >= 1
    for i in range(b):
        valid = ol[i][:, 0] >= 0
        v = ol[i][valid]
        assert (v[:, 1:3] >= 0).all() and (v[:, 1:3] <= 1).all() and (v[:, 3:5] > 0).all()
        assert not valid[valid.argmin():].any() or valid.all()       # valid rows first


def test_mixup_blends_and_unions_labels():
    b, h = 4, 64
    imgs = np.zeros((b, h, h, 3), np.uint8)
    labels = np.full((b, 16, 5), -1, np.float32)
    labels[..., 1:] = 0
    for i in range(b):
        imgs[i] = (i + 1) * 50
        labels[i, 0] = [i, 0.5, 0.5, 0.5, 0.5]
    kw = _plain(mosaic=1.0)
    bi, bl = _aug(imgs, labels, 5, **kw)
    mi, ml = _aug(imgs, labels, 5, **kw, mixup=1.0)
    assert (mi - bi).abs().max() > 1e-3 and mi.min() >= 0 and mi.max() <= 1
    nb, nm = (bl[..., 0] >= 0).sum(1), (ml[..., 0] >= 0).sum(1)
    assert (nm >= nb).all() and (nm > nb).any()


def test_dy_mixup_gates_on_box_count():
    """dy_mixup blends only samples with <= dy_label boxes after the mosaic
    (each sample's partner set to another sample, so that a blend shows)."""
    b, h, n = 2, 64, 128

    def run(n_boxes, dy_mixup):
        imgs = np.zeros((b, h, h, 3), np.uint8)
        imgs[0], imgs[1] = 60, 200
        labels = np.full((b, n, 5), -1, np.float32)
        for i in range(b):
            for j in range(n_boxes):
                labels[i, j] = [i, (j % 5) * 0.19 + 0.06, (j // 5 % 5) * 0.19 + 0.06, 0.05, 0.05]
        p = D.draw(b, h, h, torch.Generator().manual_seed(9),
                   **_plain(mosaic=1.0, dy_label=5, dy_mixup=max(dy_mixup, 1e-9)))
        p["u_dy"][:] = dy_mixup > 0
        p["partner"] = torch.tensor([1, 0])
        return D.apply(_t(imgs), _t(labels), p)

    base_i, base_l = run(25, 0.0)
    dyn_i, dyn_l = run(25, 1.0)
    assert (base_l[..., 0] >= 0).sum() > 2 * 5
    assert torch.equal(base_i, dyn_i) and torch.equal(base_l, dyn_l)
    sparse_i, sparse_l = run(1, 0.0)
    sparse_dyn_i, sparse_dyn_l = run(1, 1.0)
    assert (sparse_dyn_i - sparse_i).abs().max() > 1e-3
    assert ((sparse_dyn_l[..., 0] >= 0).sum(1) > (sparse_l[..., 0] >= 0).sum(1)).all()
