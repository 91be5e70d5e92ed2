"""Read a reference PyTorch MAF-YOLO checkpoint (`.pt`) into the JAX
package's checkpoint layout (counterpart of mafyolo_tpu/utils/torch_bridge.py).

The reference ships MAFYOLO{n,s,m}.pt whose 'model'/'ema' entries are
pickled nn.Modules; a `.pt` whose entry is a plain state_dict is read too.
A state_dict of the yaml-built train graph (keys 'backbone.{i}.<module
path>', OIHW) becomes {'params', 'batch_stats'} with numpy f32 leaves and
HWIO kernels, the tree that utils/bridge.py:train_variables_to_state_dict
carries into the port's modules.

Name correspondence per block (ours <- reference):
  RepVGGBlock:         dense <- rbr_dense, pw <- rbr_1x1, idbn <- rbr_identity
  Conv/ConvWrapper:    block.{conv,bn} <- block.{conv,bn} (ConvWrapper) or
                       {conv,bn} at the Conv's own level
  MPRep:               pool_proj <- conv1, rep_down <- conv2
  SPPF:                cv1, cv2 <- cv1, cv2
  RepHDW:              cv_in <- conv1, m{i} <- m.{i}, cv_out <- conv2
  DepthBottleneckUni:  expand <- conv1, dw <- conv2, project <- one_conv
  UniRepLKNetBlock:    drb <- dwconv, post_bn <- norm
  DilatedReparamBlock: origin.{conv,bn} <- lk_origin/origin_bn,
                       dil_k{k}_r{r}.{conv,bn} <- dil_conv_k{k}_{r}/dil_bn_k{k}_{r}
  Head_DepthUni:       stem<-stem, cls_dw<-cls_conv, cls_proj<-cls_conv_s,
                       cls_pred<-cls_pred, reg_dw<-reg_conv, reg_proj<-reg_conv_s,
                       reg_pred<-reg_pred

  RepBlock:            conv1 <- conv1, block{i} <- block.{i}
  BepC3:               cv1..cv3 <- cv1..cv3, m_conv1 <- m.conv1,
                       m_block{i} <- m.block.{i}; a BottleRep's conv1/conv2
                       are RepVGG blocks or ConvWrappers, alpha <- alpha
  SimSPPF:             cv1, cv2 <- cv1, cv2
  Transpose:           kernel [kH,kW,I,O] <- upsample_transpose.weight
                       [I,O,kH,kW], bias <- upsample_transpose.bias
  Head_Effide:         the level-j entries of the head's per-role
                       ModuleLists (prefix "detect:{j}"): stem <- stems.{j},
                       cls_conv <- cls_convs.{j}, reg_conv <- reg_convs.{j},
                       cls_pred <- cls_preds.{j}, reg_pred <- reg_preds.{j}

A YOLOv6 office checkpoint's keys are not 'backbone.{i}': pass
models/office.py:OFFICE_TORCH_PREFIXES to state_dict_to_variables.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mafyolo_tpu_torch.models.blocks import DILATED_BRANCHES, bepc3_chain_len

# Head stem width of layer 31 -> graph (torch_bridge.py:232-234 of the JAX package)
GRAPH_BY_WIDTH = {128: "maf-yolo-n", 192: "maf-yolo-s", 256: "maf-yolo-m"}


def _conv_kernel(w) -> np.ndarray:
    """OIHW -> HWIO (grouped and depthwise too)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0)))


def _take_bn(sd: Dict, prefix: str):
    p = {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
         "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    s = {"mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
         "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)}
    return p, s


def _take_convbn(sd: Dict, prefix: str):
    """A Conv module or conv_bn cell at `prefix` -> (params, stats)."""
    bp, bs = _take_bn(sd, f"{prefix}.bn")
    return ({"conv": {"kernel": _conv_kernel(sd[f"{prefix}.conv.weight"])}, "bn": bp},
            {"bn": bs})


def _take_conv_raw(sd: Dict, prefix: str):
    return {"kernel": _conv_kernel(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _repvgg(sd, pfx, has_identity: bool):
    p, s = {}, {}
    p["dense"], s["dense"] = _take_convbn(sd, f"{pfx}.rbr_dense")
    p["pw"], s["pw"] = _take_convbn(sd, f"{pfx}.rbr_1x1")
    if has_identity and f"{pfx}.rbr_identity.weight" in sd:
        p["idbn"], s["idbn"] = _take_bn(sd, f"{pfx}.rbr_identity")
    return p, s


def _drb(sd, pfx, k: int):
    bp, bs = _take_bn(sd, f"{pfx}.origin_bn")
    p = {"origin": {"conv": {"kernel": _conv_kernel(sd[f"{pfx}.lk_origin.weight"])},
                    "bn": bp}}
    s = {"origin": {"bn": bs}}
    for ks, r in DILATED_BRANCHES[k]:
        ours = f"dil_k{ks}_r{r}"
        bp, bs = _take_bn(sd, f"{pfx}.dil_bn_k{ks}_{r}")
        p[ours] = {"conv": {"kernel": _conv_kernel(sd[f"{pfx}.dil_conv_k{ks}_{r}.weight"])},
                   "bn": bp}
        s[ours] = {"bn": bs}
    return p, s


def _unireplk(sd, pfx, k: int):
    p, s = {}, {}
    p["drb"], s["drb"] = _drb(sd, f"{pfx}.dwconv", k)
    p["post_bn"], s["post_bn"] = _take_bn(sd, f"{pfx}.norm")
    return p, s


def _dbu(sd, pfx, kersize: int):
    p, s = {}, {}
    p["expand"], s["expand"] = _take_convbn(sd, f"{pfx}.conv1")
    p["dw"], s["dw"] = _unireplk(sd, f"{pfx}.conv2", kersize)
    p["project"], s["project"] = _take_convbn(sd, f"{pfx}.one_conv")
    return p, s


def convert_layer(sd: Dict, spec, torch_prefix: str) -> Tuple[Dict, Dict]:
    """One graph layer: the reference state_dict's subtree -> (params,
    batch_stats)."""
    kind, kw = spec.kind, spec.kw
    if kind in ("Conv", "SimConv"):
        p, s = _take_convbn(sd, torch_prefix)
        return {"block": p}, {"block": s}
    if kind == "ConvWrapper":
        p, s = _take_convbn(sd, f"{torch_prefix}.block")
        return {"block": p}, {"block": s}
    if kind == "RepVGGBlock":
        return _repvgg(sd, torch_prefix, kw["cin"] == kw["cout"] and kw["stride"] == 1)
    if kind == "SPPF":
        p1, s1 = _take_convbn(sd, f"{torch_prefix}.cv1")
        p2, s2 = _take_convbn(sd, f"{torch_prefix}.cv2")
        return {"cv1": p1, "cv2": p2}, {"cv1": s1, "cv2": s2}
    if kind == "MPRep":
        p1, s1 = _take_convbn(sd, f"{torch_prefix}.conv1")
        p2, s2 = _repvgg(sd, f"{torch_prefix}.conv2", False)
        return {"pool_proj": p1, "rep_down": p2}, {"pool_proj": s1, "rep_down": s2}
    if kind == "RepHDW":
        p, s = {}, {}
        p["cv_in"], s["cv_in"] = _take_convbn(sd, f"{torch_prefix}.conv1")
        p["cv_out"], s["cv_out"] = _take_convbn(sd, f"{torch_prefix}.conv2")
        for i in range(kw["depth"]):
            p[f"m{i}"], s[f"m{i}"] = _dbu(sd, f"{torch_prefix}.m.{i}", kw["kersize"])
        return p, s
    if kind == "Head_DepthUni":
        p, s = {}, {}
        p["stem"], s["stem"] = _take_convbn(sd, f"{torch_prefix}.stem")
        for role in ("cls", "reg"):
            p[f"{role}_dw"], s[f"{role}_dw"] = _unireplk(sd, f"{torch_prefix}.{role}_conv",
                                                         kw["kersize"])
            p[f"{role}_proj"], s[f"{role}_proj"] = _take_convbn(
                sd, f"{torch_prefix}.{role}_conv_s")
            p[f"{role}_pred"] = _take_conv_raw(sd, f"{torch_prefix}.{role}_pred")
        return p, s
    if kind == "RepBlock":
        p, s = {}, {}
        p["conv1"], s["conv1"] = _repvgg(sd, f"{torch_prefix}.conv1", kw["cin"] == kw["cout"])
        for i in range(kw["n"] - 1):
            p[f"block{i}"], s[f"block{i}"] = _repvgg(sd, f"{torch_prefix}.block.{i}", True)
        return p, s
    if kind == "BepC3":
        p, s = {}, {}
        for cv in ("cv1", "cv2", "cv3"):
            p[cv], s[cv] = _take_convbn(sd, f"{torch_prefix}.{cv}")
        p["m_conv1"], s["m_conv1"] = _bottlerep(sd, f"{torch_prefix}.m.conv1", kw["basic"])
        for i in range(bepc3_chain_len(kw["n"]) - 1):
            p[f"m_block{i}"], s[f"m_block{i}"] = _bottlerep(
                sd, f"{torch_prefix}.m.block.{i}", kw["basic"])
        return p, s
    if kind == "SimSPPF":
        p1, s1 = _take_convbn(sd, f"{torch_prefix}.cv1")
        p2, s2 = _take_convbn(sd, f"{torch_prefix}.cv2")
        return {"cv1": p1, "cv2": p2}, {"cv1": s1, "cv2": s2}
    if kind == "Transpose":
        w = np.asarray(sd[f"{torch_prefix}.upsample_transpose.weight"], np.float32)
        return {"kernel": np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))),
                "bias": np.asarray(sd[f"{torch_prefix}.upsample_transpose.bias"],
                                   np.float32)}, {}
    if kind == "Head_Effide":
        det, j = torch_prefix.split(":")
        p, s = {}, {}
        p["stem"], s["stem"] = _take_convbn(sd, f"{det}.stems.{j}")
        for role in ("cls", "reg"):
            p[f"{role}_conv"], s[f"{role}_conv"] = _take_convbn(sd, f"{det}.{role}_convs.{j}")
            p[f"{role}_pred"] = _take_conv_raw(sd, f"{det}.{role}_preds.{j}")
        return p, s
    raise NotImplementedError(kind)


def _bottlerep(sd, pfx, basic: str):
    """A BottleRep: two RepVGG blocks (identity where the file has one) or
    two ConvWrappers, and its alpha where the file has one."""
    p, s = {}, {}
    for name in ("conv1", "conv2"):
        if basic == "repvgg":
            p[name], s[name] = _repvgg(sd, f"{pfx}.{name}", True)
        else:
            cp, cs = _take_convbn(sd, f"{pfx}.{name}.block")
            p[name], s[name] = {"block": cp}, {"block": cs}
    if f"{pfx}.alpha" in sd:
        p["alpha"] = np.asarray(sd[f"{pfx}.alpha"], np.float32)
    return p, s


def state_dict_to_variables(sd: Dict, specs, prefixes: Dict = None) -> Dict:
    """A reference state_dict -> {'params','batch_stats'}. The keys of layer
    i sit under 'backbone.{i}' (the yaml graphs) unless `prefixes` maps i to
    its prefix (models/office.py:OFFICE_TORCH_PREFIXES for a YOLOv6 office
    checkpoint)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}
    params, stats = {}, {}
    for spec in specs:
        if spec.kind in ("Upsample", "Concat", "Out"):
            continue
        name = f"layer{spec.idx}"
        p, s = convert_layer(sd, spec, prefixes[spec.idx] if prefixes
                             else f"backbone.{spec.idx}")
        params[name] = p
        if s:
            stats[name] = s
    return {"params": {"net": params}, "batch_stats": {"net": stats}}


def load_torch_checkpoint(path: str) -> Dict:
    """A reference `.pt` -> the checkpoint dict that utils/checkpoint.py's
    `.npck` files hold: {model: {params, batch_stats}, ema: None, opt:
    None, updates: 0, epoch: -1, meta: {graph, nc}}. Its `ema` entry if it
    is truthy, else `model`; a pickled module is state_dict()-ed (unpickling
    one needs the reference package importable: load only trusted files).
    The graph comes from the width of layer 31's head stem (any width other
    than S's and M's reads as N), nc from its cls_pred."""
    import torch

    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt.get("ema") or ckpt.get("model")
    sd = model.float().state_dict() if hasattr(model, "state_dict") else model
    key = "backbone.31.stem.conv.weight"
    width = sd[key].shape[0] if key in sd else 128
    graph = GRAPH_BY_WIDTH.get(int(width), "maf-yolo-n")
    nc = int(sd["backbone.31.cls_pred.weight"].shape[0])
    specs = parse_graph(MODEL_ZOO[graph], nc=nc)[0]
    return {"model": state_dict_to_variables(sd, specs), "ema": None, "opt": None,
            "updates": 0, "epoch": -1, "meta": {"graph": graph, "nc": nc}}
