"""INT8 post-training quantization and QAT (counterpart of
mafyolo_tpu/core/quant.py:27-344).

Quantization is a mode of the deploy model (build_model(..., quant=True),
models/blocks.py): every folded conv quantizes per-output-channel weights
and per-tensor activations with calibrated amax values, held as the
`act_amax` buffers of the model and, outside it, as the JAX package's
'quant' tree of numpy scalars (utils/bridge.py maps one onto the other;
the tree is the checkpointable artifact). Calibration runs the graph in
"calib" mode, fake-quant predict and QAT in "fake" mode (straight-through
estimator), real-int8 predict in "int8" mode through the int8 conv kernels
(ops/quant_conv.py) and the fused decode + greedy-NMS kernel.

dtypes as in JAX: ptq_calibrate and quantized_predict_fn run in f32,
int8_predict_fn in bf16; each quantizer casts to f32 first. Every entry
point runs on the card unless the caller names another device.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.blocks import pack_int8, set_quant_mode
from mafyolo_tpu_torch.utils.bridge import (quant_variables_to_state_dict, state_dict_to_quant,
                                            state_dict_to_train_variables)
from mafyolo_tpu_torch.utils.events import LOGGER


def divisor_255(dtype, device) -> torch.Tensor:
    """255 as a 0-d tensor of dtype on device: normalize's divisor. A
    tensor, not a Python number: torch multiplies by the reciprocal of a
    scalar divisor, and the JAX package divides."""
    return torch.tensor(255.0, dtype=dtype, device=device)


def normalize(imgs_u8, dtype, device, divisor=None) -> torch.Tensor:
    """uint8 BGR NHWC -> RGB in [0, 1] in dtype on device, a true division
    by divisor_255(dtype, device), made here unless given (a CUDA graph
    cannot capture the copy that makes it)."""
    x = torch.as_tensor(imgs_u8).to(device)
    if divisor is None:
        divisor = divisor_255(dtype, x.device)
    return x.flip(-1).to(dtype) / divisor


def quant_model(graph, nc: int, folded_params: Dict, quant_tree: Optional[Dict] = None,
                mode: str = "fake", device="cuda", dtype=torch.float32):
    """The quant deploy model on the folded params and amax tree (zeros
    without one) in `mode`, its parameters in dtype, on device (buffers stay
    f32). In "int8" mode the weights are packed first, from the f32 host
    copy (models/blocks.py:pack_int8)."""
    model = build_model(graph, nc=nc, deploy=True, quant=True)
    if quant_tree is None:
        sd = quant_variables_to_state_dict(folded_params, {})
        missing, unexpected = model.load_state_dict(sd, strict=False)
        if unexpected or any(not k.endswith("act_amax") for k in missing):
            raise KeyError(f"folded params do not fit {graph}: {missing} {unexpected}")
    else:
        model.load_state_dict(quant_variables_to_state_dict(folded_params, quant_tree))
    model.eval()
    if mode == "int8":
        pack_int8(model, torch.device(device))
    set_quant_mode(model, mode)
    model = model.to(device, memory_format=torch.channels_last)
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def init_quant_tree(graph, nc: int, folded_params: Dict, img_size: int = 64) -> Dict:
    """Zero-initialized amax tree matching the deploy graph."""
    del folded_params, img_size   # the tree's shape is the graph's alone
    return state_dict_to_quant(build_model(graph, nc=nc, deploy=True, quant=True,
                                           calibrate=True).state_dict())


def _iter_batches(batches, max_batches):
    n = 0
    for batch in batches:
        yield batch[0] if isinstance(batch, tuple) else batch
        n += 1
        if n >= max_batches:
            return


def amax_from_hist(hist, amax: float, method: str,
                   percentile: float = 99.99) -> float:
    """Reduce an |x| histogram over [0, amax] to a calibrated amax.

    A copy of mafyolo_tpu/core/quant.py:amax_from_hist (pytorch_quantization's
    HistogramCalibrator reductions): 'percentile' picks the edge covering
    that mass fraction; 'mse' minimizes int8 reconstruction error; 'entropy'
    is the TensorRT KL-divergence sweep.
    """
    hist = np.asarray(hist, np.float64)
    nbins = hist.size
    edges = np.linspace(0.0, amax, nbins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    total = hist.sum()
    if total == 0 or amax == 0:
        return float(amax)
    if method == "percentile":
        cdf = np.cumsum(hist) / total
        idx = int(np.searchsorted(cdf, percentile / 100.0))
        return float(edges[min(idx + 1, nbins)])
    if method == "mse":
        best, best_err = amax, np.inf
        for i in range(nbins // 16, nbins + 1, max(1, nbins // 256)):
            cand = edges[i]
            scale = cand / 127.0
            q = np.clip(np.round(centers / scale), -128, 127) * scale
            err = float((hist * (centers - q) ** 2).sum())
            if err < best_err:
                best, best_err = cand, err
        return float(best)
    if method == "entropy":
        # TensorRT KL calibration: for each truncation point i, compare the
        # clamped reference distribution against its 128-level quantization
        nlevels = 128
        best, best_kl = amax, np.inf
        start = max(nlevels, nbins // 16)
        for i in range(start, nbins + 1, max(1, nbins // 256)):
            p = hist[:i].copy()
            p[-1] += hist[i:].sum()
            ref = p / p.sum()
            # quantize: merge i bins into nlevels groups, spread back uniformly
            # over the nonzero source bins
            idx = (np.arange(i) * nlevels // i)
            q = np.zeros(i)
            nz = p > 0
            sums = np.bincount(idx, weights=p, minlength=nlevels)
            cnts = np.bincount(idx[nz], minlength=nlevels)
            expand = np.where(cnts[idx] > 0, sums[idx] / np.maximum(cnts[idx], 1), 0)
            q[nz] = expand[nz]
            qs = q.sum()
            if qs == 0:
                continue
            q /= qs
            m = ref > 0
            kl = float((ref[m] * np.log(ref[m] / np.maximum(q[m], 1e-12))).sum())
            if kl < best_kl:
                best, best_kl = edges[i], kl
        return float(best)
    raise ValueError(f"unknown amax method {method!r}")


@torch.no_grad()
def ptq_calibrate(graph, nc: int, folded_params: Dict, batches: Iterable,
                  max_batches: int = 32, dtype=torch.float32,
                  method: str = "max", percentile: float = 99.99,
                  num_bins: int = 2048,
                  skip_layers: Optional[Iterable[str]] = None,
                  device="cuda") -> Dict:
    """Activation calibration over `batches` of uint8 NHWC images -> amax tree.

    method='max' keeps the running |x| max (MaxCalibrator); 'percentile',
    'mse' and 'entropy' run a second pass that histograms |x| over [0, the
    pass-1 max] and reduce it with amax_from_hist (HistogramCalibrator).
    `batches` must be re-iterable for histogram methods. skip_layers zeroes
    the amax of matching layer paths (sensitive-layer skip)."""
    model = quant_model(graph, nc, folded_params, mode="calib", device=device, dtype=dtype)
    n = 0
    for imgs in _iter_batches(batches, max_batches):
        model(normalize(imgs, dtype, device))
        n += 1
    LOGGER.info(f"PTQ max pass done over {n} batches")
    quant = state_dict_to_quant(model.state_dict())
    if method != "max":
        set_quant_mode(model, "calib", num_bins)
        m = 0
        for imgs in _iter_batches(batches, max_batches):
            model(normalize(imgs, dtype, device))
            m += 1
        if m == 0:
            raise ValueError("histogram calibration needs re-iterable "
                             "batches (got an exhausted iterator)")
        LOGGER.info(f"PTQ histogram pass done over {m} batches (method={method})")
        quant = _reduce_hist_tree(state_dict_to_quant(model.state_dict()), method,
                                  percentile)
    if skip_layers:
        quant = skip_sensitive_layers(quant, skip_layers)
    return quant


def _map_paths(fn, tree, prefix=()):
    """fn('a/b/leaf', leaf) over the leaves of a nested dict."""
    return {k: _map_paths(fn, v, prefix + (k,)) if isinstance(v, dict)
            else fn("/".join(prefix + (k,)), v) for k, v in tree.items()}


def _reduce_hist_tree(hq: Dict, method: str, percentile: float) -> Dict:
    """{... act_amax, act_hist} -> {... act_amax} with histogram-reduced amax."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        if "act_amax" in node and "act_hist" in node:
            amax = float(np.asarray(node["act_amax"]))
            new = amax_from_hist(node["act_hist"], amax, method, percentile)
            return {"act_amax": np.float32(new)}
        return {k: walk(v) for k, v in node.items()}
    return walk(hq)


def skip_sensitive_layers(quant_tree: Dict, names: Iterable[str]) -> Dict:
    """Disable quantization for layers whose path contains any of `names`
    (amax 0 passes activations through, models/blocks.fake_quant_sym)."""
    names = list(names)
    skipped = []

    def mk(key, leaf):
        if any(n in key for n in names):
            skipped.append(key)
            return np.zeros_like(np.asarray(leaf))
        return leaf

    out = _map_paths(mk, quant_tree)
    LOGGER.info(f"sensitive-layer skip: {len(skipped)} quant vars disabled")
    return out


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def quant_layer_names(quant_tree: Dict) -> list:
    """Unique quantized-layer paths (amax parents), for sensitivity sweeps."""
    return sorted({key[: -len("/act_amax")] for key, _ in _paths(quant_tree)
                   if key.endswith("/act_amax")})


def only_layer_quant(quant_tree: Dict, layer: str) -> Dict:
    """amax tree with quantization enabled ONLY for `layer` (zero elsewhere),
    one step of the partial-quantization sensitivity sweep."""
    return _map_paths(lambda key, leaf: leaf if key.startswith(layer + "/")
                      else np.zeros_like(np.asarray(leaf)), quant_tree)


def qat_finetune(graph, nc: int, folded_params: Dict, quant_tree: Dict,
                 loader, *, img_size: int, epochs: int = 3, lr: float = 1e-4,
                 momentum: float = 0.9, iou_type: str = "giou",
                 dtype=torch.float32, device="cuda",
                 losses: Optional[list] = None) -> Dict:
    """Quantization-aware finetuning of the folded model: fake-quant convs
    with a straight-through estimator, the TAL detection loss (use_atss
    False), and the JAX loop's update on every parameter,
    m' = momentum * m + g; p' = p - lr * (g + momentum * m'). Each step's
    loss is appended to `losses` when one is given."""
    from mafyolo_tpu_torch.models.losses.loss import detection_loss

    model = quant_model(graph, nc, folded_params, quant_tree, mode="fake", device=device,
                        dtype=dtype)
    params = list(model.parameters())
    mom = [torch.zeros_like(p) for p in params]
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for imgs, targets, _ in loader:
            outs = model(normalize(imgs, dtype, device))
            loss, _ = detection_loss(outs, torch.as_tensor(targets).to(device),
                                     use_atss=False, num_classes=nc, img_size=img_size,
                                     iou_type=iou_type)
            grads = torch.autograd.grad(loss, params)
            if losses is not None:
                losses.append(float(loss.detach()))
            with torch.no_grad():
                for p, m, g in zip(params, mom, grads):
                    m.mul_(momentum).add_(g)
                    p.sub_(lr * (g + momentum * m))
        LOGGER.info(f"QAT epoch {epoch}: loss {float(loss.detach()):.4f}")
    sd = {name: p for name, p in model.named_parameters()}
    return {"params": state_dict_to_train_variables(sd)["params"]}


def quantized_predict_fn(graph, nc: int, folded_params: Dict, quant_tree: Dict,
                         strides=None, reg_max: Optional[int] = None,
                         conf_thres: float = 0.03, iou_thres: float = 0.65,
                         max_det: int = 300, dtype=torch.float32, device="cuda"):
    """int8-simulated (fake-quant) forward + decode + batched NMS: a
    function of uint8 BGR NHWC images -> the detections dict. strides and
    reg_max default to the graph's own (the model's)."""
    from mafyolo_tpu_torch.models.detect import decode_eval
    from mafyolo_tpu_torch.ops.nms import batched_nms

    model = quant_model(graph, nc, folded_params, quant_tree, mode="fake", device=device,
                        dtype=dtype)

    strides = model.strides if strides is None else strides
    reg_max = model.reg_max if reg_max is None else reg_max

    @torch.no_grad()
    def predict(imgs_u8):
        pred = decode_eval(model(normalize(imgs_u8, dtype, device)), strides=strides,
                           reg_max=reg_max)
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                           max_det=max_det)
    predict.model = model
    return predict


def int8_predict_fn(graph, nc: int, folded_params: Dict, quant_tree: Dict,
                    strides=None, reg_max: Optional[int] = None,
                    conf_thres: float = 0.03, iou_thres: float = 0.65,
                    max_det: int = 300, dtype=torch.bfloat16, device="cuda"):
    """REAL-int8 forward (the int8 conv kernels, int32 accumulation) + fused
    decode + greedy NMS: a function of uint8 BGR NHWC images -> the
    detections dict. Needs a fully calibrated tree (every act_amax > 0):
    sensitive-layer skipping is a fake-quant concept. strides and reg_max
    default to the graph's own (the model's).

    On the card each call is one replay of the CUDA graphs of its input
    shape and thresholds (core/graphs.py: captured at the first call of a
    key, as jax.jit traces it); on the CPU it runs eagerly. A call may name
    conf_thres, iou_thres, max_det or multi_label to replace the defaults
    given here. The function's `eager` attribute runs the same predict as
    eager launches on any device, `graphs` holds the captured keys (None on
    the CPU) and `model` the quant model."""
    for _, leaf in _paths(quant_tree):
        if float(np.asarray(leaf).min()) <= 0:
            raise ValueError("int8 deploy needs every act_amax > 0 "
                             "(run calibration without skip_layers)")
    from mafyolo_tpu_torch.core.graphs import PredictGraphs
    from mafyolo_tpu_torch.ops.nms import decode_nms_stages, fused_decode_nms

    model = quant_model(graph, nc, folded_params, quant_tree, mode="int8", device=device,
                        dtype=dtype)
    strides = model.strides if strides is None else strides
    reg_max = model.reg_max if reg_max is None else reg_max
    divisor = divisor_255(dtype, device)
    thresholds = dict(conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
                      multi_label=True)

    @torch.no_grad()
    def eager(imgs_u8, **static):
        outs = model(normalize(imgs_u8, dtype, device, divisor))
        return fused_decode_nms(outs, strides=strides, reg_max=reg_max,
                                **{**thresholds, **static})

    def stages(x, **static):
        return decode_nms_stages(model(normalize(x, dtype, device, divisor)), strides=strides,
                                 reg_max=reg_max, **static)

    graphs = PredictGraphs(stages, device) if torch.device(device).type == "cuda" else None

    def predict(imgs_u8, **static):
        if graphs is None:
            return eager(imgs_u8, **static)
        return graphs(imgs_u8, **{**thresholds, **static})
    predict.model, predict.eager, predict.graphs = model, eager, graphs
    return predict
