"""Device-side augmentation of a train batch (counterpart of
mafyolo_tpu/data/device_aug.py:30-453), plain tensor code on the batch's
device.

In device-aug mode the host loader only letterboxes; the train step then
applies, per sample: an in-batch mosaic (three donors of the same batch on
a virtual 2s x 2s canvas) with a random affine, or a random affine alone;
cached-mosaic mixup and dynamic mixup (a beta(32, 32) blend with another
sample's mosaic, labels concatenated); HSV jitter on RGB floats; flips. The
labels follow the same affine with box_candidates' filter and stay a
fixed-shape [B, N, 5] pad (cls -1), valid rows first.

It comes in two halves. `draw` takes every random number from an explicit
torch.Generator (the train step seeds one on the batch's device from
(seed, rng_step)); `apply` takes the drawn parameters and is deterministic,
so the card's result can be held against the CPU's on the same draw, and
the JAX package's private functions against this on the same parameters.
The JAX package's random streams (jax.random) are not reproduced.

Warps are the gather forms of the JAX module (`_warp_bilinear`,
`_warp_mosaic_bilinear`) in f32; its separable-matmul forms for
axis-aligned affines and the bf16 mosaic canvas compute the same warps
for the TPU's matrix unit and have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

FILL = 114.0 / 255.0


def aug_seed(seed: int, rng_step: int) -> int:
    """The generator seed of train step rng_step of a run seeded `seed`."""
    return int(np.random.SeedSequence([seed ^ 0x5DEECE66D, rng_step])
               .generate_state(1, np.uint64)[0])


def affine_matrix(a, s, shx, shy, tx, ty, h: int, w: int):
    """[B,3,3] T @ SH @ R @ C from per-sample angle a (degrees), scale s,
    shear angles shx, shy (degrees) and translation tx, ty (pixels): the
    centering C uses the INPUT dims (h, w: the 2s canvas in the mosaic
    path), as the JAX `_affine_matrix` does."""
    b = a.shape[0]
    rad = a * math.pi / 180.0
    cos, sin = torch.cos(rad) * s, torch.sin(rad) * s
    eye = torch.eye(3, dtype=torch.float32, device=a.device).expand(b, 3, 3)
    c = eye.clone()
    c[:, 0, 2], c[:, 1, 2] = -w / 2, -h / 2
    r = eye.clone()
    r[:, 0, 0], r[:, 0, 1], r[:, 1, 0], r[:, 1, 1] = cos, -sin, sin, cos
    sh = eye.clone()
    sh[:, 0, 1] = torch.tan(shx * math.pi / 180.0)
    sh[:, 1, 0] = torch.tan(shy * math.pi / 180.0)
    t = eye.clone()
    t[:, 0, 2], t[:, 1, 2] = tx, ty
    return t @ sh @ r @ c


def _uniform(gen, shape, lo, hi):
    dev = gen.device
    return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo


def draw(b: int, h: int, w: int, gen: torch.Generator, *, degrees=0.0, translate=0.1,
         scale=0.5, shear=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, fliplr=0.5,
         flipud=0.0, mosaic=0.0, mixup=0.0, dy_label=5, dy_mixup=0.0) -> Dict:
    """Every random parameter of one batch's augmentation, on gen's device.

    Keys, per sample: `m` [B,3,3] affine and `s` [B] its scale (mosaic on,
    or any geometric hyp nonzero); with mosaic, `donors` [B,3], `xc`, `yc`
    [B] (floored centres in U(s/2, 3s/2)) and `do_mo` [B]; with mosaic and
    mixup or dy_mixup, `partner` [B], `u_mix`, `u_dy` [B] and `r` [B]
    ~ beta(32, 32); with any HSV gain, `gains` [B,3]; `do_lr`, `do_ud` [B].
    `dy_label` (an int) rides along for `apply`'s dynamic-mixup gate."""
    p: Dict = {"dy_label": int(dy_label)}
    f32 = torch.float32
    if mosaic or degrees or translate or scale or shear:
        ih, iw = (2 * h, 2 * w) if mosaic else (h, w)
        a = _uniform(gen, (b,), -degrees, degrees)
        s = _uniform(gen, (b,), 1 - scale, 1 + scale)
        shx = _uniform(gen, (b,), -shear, shear)
        shy = _uniform(gen, (b,), -shear, shear)
        tx = _uniform(gen, (b,), 0.5 - translate, 0.5 + translate) * w
        ty = _uniform(gen, (b,), 0.5 - translate, 0.5 + translate) * h
        p["m"] = affine_matrix(a, s, shx, shy, tx, ty, ih, iw)
        p["s"] = s
    if mosaic:
        p["donors"] = torch.randint(0, b, (b, 3), generator=gen, device=gen.device)
        cxy = _uniform(gen, (b, 2), 0.5 * h, 1.5 * h).floor()
        p["xc"], p["yc"] = cxy[:, 0], cxy[:, 1]
        p["do_mo"] = torch.rand(b, generator=gen, device=gen.device) < mosaic
        if mixup or dy_mixup:
            p["partner"] = torch.randint(0, b, (b,), generator=gen, device=gen.device)
            p["u_mix"] = torch.rand(b, generator=gen, device=gen.device) < mixup
            p["u_dy"] = torch.rand(b, generator=gen, device=gen.device) < dy_mixup
            # beta(32, 32) is the 32nd smallest of 63 uniforms
            u = torch.rand((b, 63), generator=gen, device=gen.device)
            p["r"] = u.sort(1).values[:, 31].to(f32)
    if hsv_h or hsv_s or hsv_v:
        g = _uniform(gen, (b, 3), -1.0, 1.0)
        p["gains"] = g * torch.tensor([hsv_h, hsv_s, hsv_v], dtype=f32, device=g.device) + 1.0
    p["do_lr"] = torch.rand(b, generator=gen, device=gen.device) < fliplr
    p["do_ud"] = torch.rand(b, generator=gen, device=gen.device) < flipud
    return p


def params_to(p: Dict, device) -> Dict:
    """The drawn parameters on another device."""
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in p.items()}


def take_rows(p: Dict, rows) -> Dict:
    """The drawn parameters of samples `rows` alone."""
    return {k: v[rows] if torch.is_tensor(v) else v for k, v in p.items()}


def _source_coords(m_inv, out_h: int, out_w: int):
    """[B,H',W'] source x and y of every output pixel through m_inv [B,3,3]."""
    dev = m_inv.device
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    sx = (m_inv[:, 0, 0, None, None] * gx + m_inv[:, 0, 1, None, None] * gy
          + m_inv[:, 0, 2, None, None])
    sy = (m_inv[:, 1, 0, None, None] * gx + m_inv[:, 1, 1, None, None] * gy
          + m_inv[:, 1, 2, None, None])
    return sx, sy


def _bilinear(tap, sx, sy):
    """Blend the four taps around (sx, sy); tap(yi, xi) -> [B,H',W',C]."""
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def warp_bilinear(imgs, m_inv, out_h: int, out_w: int, fill: float = FILL):
    """Inverse-warp bilinear sampling of each image: imgs [B,H,W,C] f32,
    m_inv [B,3,3] maps output pixels to input pixels; taps outside the
    image read `fill` (the JAX `_warp_bilinear`, batched)."""
    b, h, w, c = imgs.shape
    flat = imgs.reshape(b * h * w, c)
    base = (torch.arange(b, device=imgs.device) * (h * w))[:, None, None]
    sx, sy = _source_coords(m_inv, out_h, out_w)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, fill)
    return _bilinear(tap, sx, sy)


def warp_mosaic_bilinear(imgs, sources, m_inv, xc, yc, out_h: int, out_w: int,
                         fill: float = FILL):
    """Inverse-warp each sample's VIRTUAL 2s x 2s mosaic canvas without
    building it (the JAX `_warp_mosaic_bilinear`, batched). imgs [B,s,s,C]
    f32; sources [S,4] the index in imgs of each sample's top-left,
    top-right, bottom-left and bottom-right tile, whose inner corner meets
    the centre (xc, yc) [S]; m_inv [S,3,3] maps output pixels to canvas
    pixels."""
    n, s, _, c = imgs.shape
    b = sources.shape[0]
    flat = imgs.reshape(n * s * s, c)
    sx, sy = _source_coords(m_inv, out_h, out_w)
    xc = xc.long()[:, None, None]
    yc = yc.long()[:, None, None]

    def tap(syi, sxi):
        qx, qy = (sxi >= xc).long(), (syi >= yc).long()
        ix = sxi - torch.where(qx == 0, xc - s, xc)
        iy = syi - torch.where(qy == 0, yc - s, yc)
        inside = ((ix >= 0) & (ix < s) & (iy >= 0) & (iy < s)
                  & (sxi >= 0) & (sxi < 2 * s) & (syi >= 0) & (syi < 2 * s))
        src = torch.gather(sources, 1, (qy * 2 + qx).reshape(b, -1)).reshape(qx.shape)
        v = flat[(src * s + iy.clamp(0, s - 1)) * s + ix.clamp(0, s - 1)]
        return torch.where(inside[..., None], v, fill)
    return _bilinear(tap, sx, sy)


def rgb_to_hsv(rgb):
    """[..., 3] RGB floats in [0, 1] -> HSV, each in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0))
    return torch.stack([h / 6.0, d / (mx + 1e-12), mx], -1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)
    sel = torch.stack([i == k for k in range(6)])

    def pick(*xs):
        out = xs[-1]
        for k in range(4, -1, -1):
            out = torch.where(sel[k], xs[k], out)
        return out
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def hsv_jitter(imgs, gains):
    """HSV gain jitter of RGB floats [B,H,W,3] in [0, 1] by gains [B,3]."""
    hsv = rgb_to_hsv(imgs)
    g = gains[:, None, None, :]
    h = torch.remainder(hsv[..., 0] * g[..., 0], 1.0)
    s = (hsv[..., 1] * g[..., 1]).clamp(0, 1)
    v = (hsv[..., 2] * g[..., 2]).clamp(0, 1)
    return hsv_to_rgb(torch.stack([h, s, v], -1))


def affine_label_corners(cls, xyxy, m, s_gain, out_h: int, out_w: int):
    """Pixel xyxy boxes [B,N,4] with cls [B,N,1] through the affine m
    [B,3,3], then box_candidates' filter (s_gain [B] the affine's scale)
    -> [B,N,5] normalized xywh; filtered and padded rows get cls -1 and
    zero boxes."""
    valid_in = cls[..., 0] >= 0
    x1, y1, x2, y2 = xyxy.unbind(-1)
    bw, bh = x2 - x1, y2 - y1
    corners = torch.stack([torch.stack([x1, y1], -1), torch.stack([x2, y2], -1),
                           torch.stack([x1, y2], -1), torch.stack([x2, y1], -1)], 2)
    pts = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)   # [B,N,4,3]
    pts = torch.einsum("bnkj,bij->bnki", pts, m)
    xs, ys = pts[..., 0], pts[..., 1]
    nx1 = xs.amin(2).clamp(0, out_w)
    ny1 = ys.amin(2).clamp(0, out_h)
    nx2 = xs.amax(2).clamp(0, out_w)
    ny2 = ys.amax(2).clamp(0, out_h)
    w2, h2 = nx2 - nx1, ny2 - ny1
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    sg = s_gain[:, None]
    keep = ((w2 > 2) & (h2 > 2) & (w2 * h2 / (bw * sg * bh * sg + 1e-16) > 0.1)
            & (ar < 20) & valid_in)[..., None]
    out = torch.stack([(nx1 + nx2) / 2 / out_w, (ny1 + ny2) / 2 / out_h,
                       w2 / out_w, h2 / out_h], -1)
    return torch.cat([torch.where(keep, cls, -1.0), torch.where(keep, out, 0.0)], -1)


def transform_labels(labels, m, s_gain, out_h: int, out_w: int):
    """Normalized-xywh labels [B,N,5] through the affine m of the plain
    (non-mosaic) path, with box_candidates' filter."""
    cx, cy = labels[..., 1] * out_w, labels[..., 2] * out_h
    bw, bh = labels[..., 3] * out_w, labels[..., 4] * out_h
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return affine_label_corners(labels[..., :1], xyxy, m, s_gain, out_h, out_w)


def mosaic_labels_canvas(labels, sources, xc, yc, s: int):
    """The labels of each sample's four tiles ([B,N,5] of the batch; tile
    q of sample i is labels[sources[i, q]], sources [S,4]) in canvas pixels
    -> (cls [S,4N,1], xyxy [S,4N,4]), tile by tile."""
    b, n = sources.shape[0], labels.shape[1]
    lbl4 = labels[sources]                                     # [B,4,N,5]
    offs = torch.stack([torch.stack([xc - s, yc - s], -1), torch.stack([xc, yc - s], -1),
                        torch.stack([xc - s, yc], -1), torch.stack([xc, yc], -1)], 1)
    cx = lbl4[..., 1] * s + offs[:, :, None, 0]
    cy = lbl4[..., 2] * s + offs[:, :, None, 1]
    bw, bh = lbl4[..., 3] * s, lbl4[..., 4] * s
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return lbl4[..., :1].reshape(b, 4 * n, 1), xyxy.reshape(b, 4 * n, 4)


def compact_labels(lbl, n_out: int):
    """Valid rows (cls >= 0) first, in their order, then truncate or pad to
    n_out rows: [B,M,5] -> [B,n_out,5]."""
    valid = lbl[..., 0] >= 0
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices[:, :n_out]
    out = torch.gather(lbl, 1, order[..., None].expand(-1, -1, lbl.shape[-1]))
    return torch.cat([torch.where(out[..., :1] >= 0, out[..., :1], -1.0), out[..., 1:]], -1)


def _mosaic(imgs, labels, p: Dict, sel, n: int):
    """The mosaic images and labels of samples `sel` of the batch."""
    s = imgs.shape[1]
    sources = torch.cat([sel[:, None], p["donors"][sel]], 1)
    m, xc, yc = p["m"][sel], p["xc"][sel], p["yc"][sel]
    img = warp_mosaic_bilinear(imgs, sources, torch.linalg.inv(m), xc, yc, s, s)
    cls4, xyxy4 = mosaic_labels_canvas(labels, sources, xc, yc, s)
    return img, compact_labels(affine_label_corners(cls4, xyxy4, m, p["s"][sel], s, s), n)


def apply(imgs_u8, labels, p: Dict, rows=None):
    """[B,H,W,3] uint8 BGR + [B,N,5] labels + draw()'s parameters ->
    (RGB float32 images in [0, 1], [B,N,5] labels), as the JAX
    device_augment computes them for the same parameters: mosaic (selected
    by do_mo; samples without it keep their image unwarped) or affine;
    then mixup with the partner's mosaic; then HSV and flips.

    rows, if given, are the samples to augment (a data-parallel rank's
    share of the global batch, parallel/ddp.py): the output has a row for
    each, the mosaic and mixup read any row of the batch, and only these
    samples and their mixup partners are warped."""
    b, h, w, _ = imgs_u8.shape
    n = labels.shape[1]
    batch_lbl = labels.float()
    batch_img = imgs_u8.flip(-1).float() / 255.0                 # BGR -> RGB
    whole = rows is None
    if whole:
        rows, q, imgs, labels = torch.arange(b, device=batch_img.device), p, batch_img, batch_lbl
    else:
        q, imgs, labels = take_rows(p, rows), batch_img[rows], batch_lbl[rows]
    if "donors" in p:
        if h != w:
            raise ValueError(f"the device mosaic takes square images, not {h}x{w}")
        mixing = "partner" in p
        # the whole batch's mosaics include every partner's; a share warps
        # its partners' after its own
        warp = torch.cat([rows, q["partner"]]) if mixing and not whole else rows
        mo_img, mo_lbl = _mosaic(batch_img, batch_lbl, p, warp, n)
        own = rows.shape[0]
        do_mo = q["do_mo"]
        imgs = torch.where(do_mo[:, None, None, None], mo_img[:own], imgs)
        labels = torch.where(do_mo[:, None, None], mo_lbl[:own], labels)
        if mixing:
            n_valid = (labels[..., 0] >= 0).sum(1)
            do = do_mo & (q["u_mix"] | ((n_valid <= p["dy_label"]) & q["u_dy"]))
            r = q["r"][:, None, None, None]
            part = q["partner"] if whole else torch.arange(own, 2 * own, device=rows.device)
            imgs = torch.where(do[:, None, None, None], imgs * r + mo_img[part] * (1.0 - r),
                               imgs)
            both = compact_labels(torch.cat([labels, mo_lbl[part]], 1), n)
            labels = torch.where(do[:, None, None], both, labels)
    elif "m" in q:
        imgs = warp_bilinear(imgs, torch.linalg.inv(q["m"]), h, w)
        labels = transform_labels(labels, q["m"], q["s"], h, w)
    if "gains" in q:
        imgs = hsv_jitter(imgs, q["gains"])
    live = labels[..., 0] >= 0
    do_lr, do_ud = q["do_lr"], q["do_ud"]
    imgs = torch.where(do_lr[:, None, None, None], imgs.flip(2), imgs)
    x = torch.where(live & do_lr[:, None], 1.0 - labels[..., 1], labels[..., 1])
    imgs = torch.where(do_ud[:, None, None, None], imgs.flip(1), imgs)
    y = torch.where(live & do_ud[:, None], 1.0 - labels[..., 2], labels[..., 2])
    labels = torch.stack([labels[..., 0], x, y, labels[..., 3], labels[..., 4]], -1)
    return imgs, labels


def device_augment(imgs_u8, labels, gen: torch.Generator, **cfg):
    """apply(imgs_u8, labels, draw(...)): one batch's augmentation, every
    random number from gen (on the batch's device)."""
    b, h, w, _ = imgs_u8.shape
    return apply(imgs_u8, labels, draw(b, h, w, gen, **cfg))
