"""Re-parameterization as numpy folds: train-form variables -> deploy tree.

A copy of the framework-free folds of mafyolo_tpu/models/reparam.py:26-262
for the block kinds of the MAF graphs, the reference-format yaml rows
Conv, SimConv and Head_simota and the office graphs (RepBlock, BepC3 of
either basic block with its `alpha` carried, SimSPPF, Transpose,
Head_Effide), plain (repopt) RepVGG blocks included, and fold_replk of
ReparamLargeKernelConv (fold_stem_s2d is left out: the port has no s2d
stem). The input is the JAX tree layout, {'params', 'batch_stats'}
of numpy arrays with HWIO kernels (utils/bridge.py:state_dict_to_train_variables
makes it from a train-form state_dict); the output is the folded deploy tree
that utils/bridge.py:folded_to_state_dict loads. tests/test_torch_train_model.py
pins it leaf for leaf to the JAX fold.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from mafyolo_tpu_torch.models.blocks import DILATED_BRANCHES, bepc3_chain_len

BN_EPS = 1e-3


def _np(x):
    return np.asarray(x, dtype=np.float32)


def fuse_conv_bn(conv_p, bn_p, bn_s, eps: float = BN_EPS):
    """Fold BN(conv(x)) -> conv'(x): k' = k * g/s, b' = beta - mean * g/s."""
    k = _np(conv_p["kernel"])
    t = _np(bn_p["scale"]) / np.sqrt(_np(bn_s["var"]) + eps)
    return k * t, _np(bn_p["bias"]) - _np(bn_s["mean"]) * t


def _fold_cbn(p, s):
    """ConvBN subtree -> ConvAct subtree."""
    k, b = fuse_conv_bn(p["conv"], p["bn"], s["bn"])
    return {"conv": {"kernel": k, "bias": b}}


def _identity_kernel(cin: int, cout: int, groups: int, k: int) -> np.ndarray:
    """HWIO identity kernel for the RepVGG identity-BN branch."""
    input_dim = cin // groups
    kernel = np.zeros((k, k, input_dim, cout), dtype=np.float32)
    c = k // 2
    for o in range(cout):
        kernel[c, c, o % input_dim, o] = 1.0
    return kernel


def _fuse_bn_only(bn_p, bn_s, cin: int, cout: int, groups: int, k: int):
    """Fold a bare BatchNorm branch into an equivalent kxk identity conv."""
    t = _np(bn_p["scale"]) / np.sqrt(_np(bn_s["var"]) + BN_EPS)
    kernel = _identity_kernel(cin, cout, groups, k) * t
    bias = _np(bn_p["bias"]) - _np(bn_s["mean"]) * t
    return kernel, bias


def _pad_kernel_center(kernel: np.ndarray, k: int) -> np.ndarray:
    """Zero-pad a smaller HWIO kernel into the center of a kxk one."""
    p = (k - kernel.shape[0]) // 2
    return np.pad(kernel, [(p, p), (p, p), (0, 0), (0, 0)])


def _dilated_to_dense(kernel: np.ndarray, r: int) -> np.ndarray:
    """Insert r-1 zeros between taps (convert_dilated_to_nondilated)."""
    if r == 1:
        return kernel
    kh, kw, i, o = kernel.shape
    dense = np.zeros((r * (kh - 1) + 1, r * (kw - 1) + 1, i, o), dtype=kernel.dtype)
    dense[::r, ::r] = kernel
    return dense


def fold_repvgg(p, s, cin: int, cout: int, stride: int, groups: int = 1):
    """RepVGGBlock: dense + pw (+ identity BN) -> one 3x3 conv. A plain
    (RealVGG, repopt) block has the dense branch only: its conv + BN fuse."""
    k3, b3 = fuse_conv_bn(p["dense"]["conv"], p["dense"]["bn"], s["dense"]["bn"])
    if "pw" not in p:
        return {"fused": {"conv": {"kernel": k3, "bias": b3}}}
    k1, b1 = fuse_conv_bn(p["pw"]["conv"], p["pw"]["bn"], s["pw"]["bn"])
    k = k3 + _pad_kernel_center(k1, 3)
    b = b3 + b1
    if "idbn" in p:
        ki, bi = _fuse_bn_only(p["idbn"], s["idbn"], cin, cout, groups, 3)
        k = k + ki
        b = b + bi
    return {"fused": {"conv": {"kernel": k, "bias": b}}}


def fold_dilated_reparam(p, s, k: int):
    """DilatedReparamBlock: origin + dilated branches -> one kxk DW conv."""
    kern, bias = fuse_conv_bn(p["origin"]["conv"], p["origin"]["bn"], s["origin"]["bn"])
    for ks, r in DILATED_BRANCHES[k]:
        name = f"dil_k{ks}_r{r}"
        bk, bb = fuse_conv_bn(p[name]["conv"], p[name]["bn"], s[name]["bn"])
        kern = kern + _pad_kernel_center(_dilated_to_dense(bk, r), k)
        bias = bias + bb
    return kern, bias


def fold_unireplk(p, s, k: int):
    """UniRepLKNetBlock: DRB merge + trailing-BN absorb."""
    kern, bias = fold_dilated_reparam(p["drb"], s["drb"], k)
    bn_p, bn_s = p["post_bn"], s["post_bn"]
    t = _np(bn_p["scale"]) / np.sqrt(_np(bn_s["var"]) + BN_EPS)
    kern = kern * t
    bias = _np(bn_p["bias"]) + (bias - _np(bn_s["mean"])) * t
    return {"fused": {"conv": {"kernel": kern, "bias": bias}}}


def fold_replk(p, s, k: int, small_k: int):
    """ReparamLargeKernelConv: lk + small branch (centre-padded) -> one DW conv."""
    kern, bias = fuse_conv_bn(p["lk"]["conv"], p["lk"]["bn"], s["lk"]["bn"])
    sk, sb = fuse_conv_bn(p["small"]["conv"], p["small"]["bn"], s["small"]["bn"])
    return {"fused": {"conv": {"kernel": kern + _pad_kernel_center(sk, k),
                               "bias": bias + sb}}}


def _fold_dbu(p, s, kw):
    return {
        "expand": _fold_cbn(p["expand"], s["expand"]),
        "dw": fold_unireplk(p["dw"], s["dw"], kw["kersize"]),
        "project": _fold_cbn(p["project"], s["project"]),
    }


def _fold_block(kind: str, kw: Dict, p, s):
    if kind in ("Conv", "ConvWrapper", "SimConv"):
        return {"block": _fold_cbn(p["block"], s["block"])}
    if kind == "RepVGGBlock":
        return fold_repvgg(p, s, kw["cin"], kw["cout"], kw["stride"])
    if kind == "SPPF":
        return {"cv1": _fold_cbn(p["cv1"], s["cv1"]), "cv2": _fold_cbn(p["cv2"], s["cv2"])}
    if kind == "MPRep":
        return {
            "pool_proj": _fold_cbn(p["pool_proj"], s["pool_proj"]),
            "rep_down": fold_repvgg(p["rep_down"], s["rep_down"], kw["cin"],
                                    kw["cout"] // 2, stride=2),
        }
    if kind == "RepHDW":
        out = {"cv_in": _fold_cbn(p["cv_in"], s["cv_in"]),
               "cv_out": _fold_cbn(p["cv_out"], s["cv_out"])}
        for i in range(kw["depth"]):
            out[f"m{i}"] = _fold_dbu(p[f"m{i}"], s[f"m{i}"], kw)
        return out
    if kind == "Head_simota":
        out = {name: _fold_cbn(p[name], s[name]) for name in ("stem", "cls_conv", "reg_conv")}
        for pred in ("cls_pred", "reg_pred", "obj_pred"):
            out[pred] = {"kernel": _np(p[pred]["kernel"]), "bias": _np(p[pred]["bias"])}
        return out
    if kind == "RepBlock":
        out = {"conv1": fold_repvgg(p["conv1"], s["conv1"], kw["cin"], kw["cout"], 1)}
        for i in range(kw["n"] - 1):
            out[f"block{i}"] = fold_repvgg(p[f"block{i}"], s[f"block{i}"], kw["cout"],
                                           kw["cout"], 1)
        return out
    if kind == "BepC3":
        c_ = int(kw["cout"] * kw["e"])

        def fold_bottlerep(bp, bs):
            o = {}
            for name in ("conv1", "conv2"):
                if kw["basic"] == "repvgg":
                    o[name] = fold_repvgg(bp[name], bs[name], c_, c_, 1)
                else:   # ConvWrapper: conv-BN-SiLU, the BN fold only
                    o[name] = {"block": _fold_cbn(bp[name]["block"], bs[name]["block"])}
            if "alpha" in bp:
                o["alpha"] = _np(bp["alpha"])
            return o

        out = {name: _fold_cbn(p[name], s[name]) for name in ("cv1", "cv2", "cv3")}
        out["m_conv1"] = fold_bottlerep(p["m_conv1"], s["m_conv1"])
        for i in range(bepc3_chain_len(kw["n"]) - 1):
            out[f"m_block{i}"] = fold_bottlerep(p[f"m_block{i}"], s[f"m_block{i}"])
        return out
    if kind == "SimSPPF":
        return {"cv1": _fold_cbn(p["cv1"], s["cv1"]), "cv2": _fold_cbn(p["cv2"], s["cv2"])}
    if kind == "Transpose":
        return {"kernel": _np(p["kernel"]), "bias": _np(p["bias"])}   # nothing to fold
    if kind == "Head_Effide":
        out = {name: _fold_cbn(p[name], s[name]) for name in ("stem", "cls_conv", "reg_conv")}
        for pred in ("cls_pred", "reg_pred"):
            out[pred] = {"kernel": _np(p[pred]["kernel"]), "bias": _np(p[pred]["bias"])}
        return out
    if kind == "Head_DepthUni":
        out = {"stem": _fold_cbn(p["stem"], s["stem"])}
        for branch in ("cls", "reg"):
            out[f"{branch}_dw"] = fold_unireplk(p[f"{branch}_dw"], s[f"{branch}_dw"],
                                                kw["kersize"])
            out[f"{branch}_proj"] = _fold_cbn(p[f"{branch}_proj"], s[f"{branch}_proj"])
            pred = p[f"{branch}_pred"]
            out[f"{branch}_pred"] = {"kernel": _np(pred["kernel"]),
                                     "bias": _np(pred["bias"])}
        return out
    raise NotImplementedError(f"no fold rule for {kind}")


def fold_variables(specs, variables) -> Dict:
    """Train-form {'params','batch_stats'} -> deploy-form {'params'} for the same graph."""
    net_p = variables["params"]["net"]
    net_s = variables["batch_stats"]["net"]
    out = {}
    for spec in specs:
        if spec.kind in ("Upsample", "Concat", "Out"):
            continue
        name = f"layer{spec.idx}"
        out[name] = _fold_block(spec.kind, spec.kw, net_p[name], net_s.get(name, {}))
    return {"params": {"net": out}}
