"""The "office" build path: the YOLOv6 family (EfficientRep or CSPBep
backbone, RepPAN neck, EffiDeHead) as graph dicts.

A copy of mafyolo_tpu/models/office.py:1-166. A config's model section with
build_type other than 'yaml' names the YOLOv6 topology by its backbone and
neck types and their repeats and widths; `office_graph` scales them
(make_divisible(c * width_multiple, 8), max(round(n * depth_multiple), 1))
and writes the fixed topology as a graph dict in the zoo's row format, with
multiples of 1.0, so that the graph executor, the folds, the bridges, the
Evaler and the Trainer run it as they run a MAF graph.

OFFICE_CONFIGS holds three configurations at full width, each a model
section as the YOLOv6 repository's configs/yolov6{n,m,l}.py (v2.0) write
it, with the DFL EffiDeHead (reg_max 16): the Evalers decode DFL heads
only.
"""
from __future__ import annotations

import math
from typing import Dict


def make_divisible(x, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def office_graph(model_cfg: Dict, training_mode: str = "repvgg") -> Dict:
    """A config's model section (EfficientRep + RepPANNeck, or
    CSPBepBackbone + CSPRepPANNeck) -> a graph dict for build_model."""
    bb, nk = model_cfg["backbone"], model_cfg["neck"]
    bb_type = bb.get("type", "EfficientRep")
    nk_type = nk.get("type", "RepPANNeck")
    if bb_type == "CSPBepBackbone" and nk_type == "CSPRepPANNeck":
        return _cspbep_graph(model_cfg, training_mode)
    if bb_type != "EfficientRep" or nk_type != "RepPANNeck":
        raise NotImplementedError(
            f"office path supports EfficientRep+RepPANNeck and "
            f"CSPBepBackbone+CSPRepPANNeck; got {bb_type}+{nk_type}")
    nr, ch, reg_max = _scaled(model_cfg)
    backbone = [
        [-1, 1, "RepVGGBlock", [ch[0], 3, 2]],      # 0  stem
        [-1, 1, "RepVGGBlock", [ch[1], 3, 2]],      # 1  ERBlock_2.0
        [-1, nr[1], "RepBlock", [ch[1]]],           # 2  ERBlock_2.1
        [-1, 1, "RepVGGBlock", [ch[2], 3, 2]],      # 3  ERBlock_3.0
        [-1, nr[2], "RepBlock", [ch[2]]],           # 4  ERBlock_3.1 -> P3
        [-1, 1, "RepVGGBlock", [ch[3], 3, 2]],      # 5  ERBlock_4.0
        [-1, nr[3], "RepBlock", [ch[3]]],           # 6  ERBlock_4.1 -> P4
        [-1, 1, "RepVGGBlock", [ch[4], 3, 2]],      # 7  ERBlock_5.0
        [-1, nr[4], "RepBlock", [ch[4]]],           # 8  ERBlock_5.1
        [-1, 1, "SimSPPF", [ch[4], 5]],             # 9  ERBlock_5.2 -> P5
    ]
    neck = [
        [9, 1, "SimConv", [ch[5], 1, 1]],           # 10 reduce_layer0
        [-1, 1, "Transpose", [ch[5]]],              # 11 upsample0
        [[-1, 6], 1, "Concat", [1]],                # 12
        [-1, nr[5], "RepBlock", [ch[5]]],           # 13 Rep_p4
        [-1, 1, "SimConv", [ch[6], 1, 1]],          # 14 reduce_layer1
        [-1, 1, "Transpose", [ch[6]]],              # 15 upsample1
        [[-1, 4], 1, "Concat", [1]],                # 16
        [-1, nr[6], "RepBlock", [ch[6]]],           # 17 Rep_p3 -> pan_out2
        [-1, 1, "SimConv", [ch[7], 3, 2]],          # 18 downsample2
        [[-1, 14], 1, "Concat", [1]],               # 19
        [-1, nr[7], "RepBlock", [ch[8]]],           # 20 Rep_n3 -> pan_out1
        [-1, 1, "SimConv", [ch[9], 3, 2]],          # 21 downsample1
        [[-1, 10], 1, "Concat", [1]],               # 22
        [-1, nr[8], "RepBlock", [ch[10]]],          # 23 Rep_n4 -> pan_out0
    ]
    return dict(depth_multiple=1.0, width_multiple=1.0, backbone=backbone,
                neck=neck, effidehead=_effidehead(reg_max))


def _scaled(model_cfg: Dict):
    """(repeats, channels, reg_max) of a model section, scaled by its
    depth and width multiples."""
    bb, nk = model_cfg["backbone"], model_cfg["neck"]
    gd = float(model_cfg.get("depth_multiple", 1.0))
    gw = float(model_cfg.get("width_multiple", 1.0))
    reps = list(bb["num_repeats"]) + list(nk["num_repeats"])
    chs = list(bb["out_channels"]) + list(nk["out_channels"])
    nr = [max(round(i * gd), 1) if i > 1 else i for i in reps]
    ch = [make_divisible(i * gw, 8) for i in chs]
    return nr, ch, int(model_cfg["head"].get("reg_max", 16))


def _effidehead(reg_max: int):
    return [
        [17, 1, "Head_Effide", [reg_max]],          # 24
        [20, 1, "Head_Effide", [reg_max]],          # 25
        [23, 1, "Head_Effide", [reg_max]],          # 26
        [[24, 25, 26], 1, "Out", []],               # 27
    ]


def _cspbep_graph(model_cfg: Dict, training_mode: str) -> Dict:
    """CSPBepBackbone + CSPRepPANNeck (the yolov6-m/l family). training_mode
    picks the basic block: 'repvgg' -> RepVGGBlock (-m), 'conv_silu' ->
    ConvWrapper (-l), for the downsampling convs and the BottleReps alike;
    the channel merge layer is SPPF for ConvWrapper, SimSPPF otherwise."""
    bb, nk = model_cfg["backbone"], model_cfg["neck"]
    nr, ch, reg_max = _scaled(model_cfg)
    e_bb = float(bb.get("csp_e", 0.5))
    e_nk = float(nk.get("csp_e", 0.5))
    conv_silu = training_mode == "conv_silu"
    basic = "conv" if conv_silu else "repvgg"
    down_kind = "ConvWrapper" if conv_silu else "RepVGGBlock"

    def down(c):
        return [-1, 1, down_kind, [c, 3, 2]]

    backbone = [
        down(ch[0]),                                    # 0  stem
        down(ch[1]),                                    # 1  ERBlock_2.0
        [-1, nr[1], "BepC3", [ch[1], e_bb, basic]],     # 2  ERBlock_2.1
        down(ch[2]),                                    # 3  ERBlock_3.0
        [-1, nr[2], "BepC3", [ch[2], e_bb, basic]],     # 4  ERBlock_3.1 -> P3
        down(ch[3]),                                    # 5  ERBlock_4.0
        [-1, nr[3], "BepC3", [ch[3], e_bb, basic]],     # 6  ERBlock_4.1 -> P4
        down(ch[4]),                                    # 7  ERBlock_5.0
        [-1, nr[4], "BepC3", [ch[4], e_bb, basic]],     # 8  ERBlock_5.1
        [-1, 1, "SPPF" if conv_silu else "SimSPPF", [ch[4], 5]],   # 9  -> P5
    ]
    neck = [
        [9, 1, "SimConv", [ch[5], 1, 1]],               # 10 reduce_layer0
        [-1, 1, "Transpose", [ch[5]]],                  # 11 upsample0
        [[-1, 6], 1, "Concat", [1]],                    # 12
        [-1, nr[5], "BepC3", [ch[5], e_nk, basic]],     # 13 Rep_p4
        [-1, 1, "SimConv", [ch[6], 1, 1]],              # 14 reduce_layer1
        [-1, 1, "Transpose", [ch[6]]],                  # 15 upsample1
        [[-1, 4], 1, "Concat", [1]],                    # 16
        [-1, nr[6], "BepC3", [ch[6], e_nk, basic]],     # 17 Rep_p3 -> pan_out2
        [-1, 1, "SimConv", [ch[7], 3, 2]],              # 18 downsample2
        [[-1, 14], 1, "Concat", [1]],                   # 19
        [-1, nr[7], "BepC3", [ch[8], e_nk, basic]],     # 20 Rep_n3 -> pan_out1
        [-1, 1, "SimConv", [ch[9], 3, 2]],              # 21 downsample1
        [[-1, 10], 1, "Concat", [1]],                   # 22
        [-1, nr[8], "BepC3", [ch[10], e_nk, basic]],    # 23 Rep_n4 -> pan_out0
    ]
    return dict(depth_multiple=1.0, width_multiple=1.0, backbone=backbone,
                neck=neck, effidehead=_effidehead(reg_max))


# torch state_dict prefixes per graph layer index, for the .pt bridge
# (utils/torch_bridge.py:state_dict_to_variables(prefixes=...)); "detect:{j}"
# names level j of the head's per-role ModuleLists.
OFFICE_TORCH_PREFIXES = {
    0: "backbone.stem",
    1: "backbone.ERBlock_2.0", 2: "backbone.ERBlock_2.1",
    3: "backbone.ERBlock_3.0", 4: "backbone.ERBlock_3.1",
    5: "backbone.ERBlock_4.0", 6: "backbone.ERBlock_4.1",
    7: "backbone.ERBlock_5.0", 8: "backbone.ERBlock_5.1",
    9: "backbone.ERBlock_5.2",
    10: "neck.reduce_layer0", 11: "neck.upsample0", 13: "neck.Rep_p4",
    14: "neck.reduce_layer1", 15: "neck.upsample1", 17: "neck.Rep_p3",
    18: "neck.downsample2", 20: "neck.Rep_n3",
    21: "neck.downsample1", 23: "neck.Rep_n4",
    24: "detect:0", 25: "detect:1", 26: "detect:2",
}

_HEAD = dict(type="EffiDeHead", in_channels=[128, 256, 512], num_layers=3,
             begin_indices=24, anchors=1, out_indices=[17, 20, 23],
             strides=[8, 16, 32], use_dfl=True, reg_max=16)

# Three YOLOv6 v2.0 configurations (meituan/YOLOv6 configs/yolov6{n,m,l}.py,
# model sections), at full width: {name: (model section, training_mode)}.
OFFICE_CONFIGS = {
    # configs/yolov6n.py: EfficientRep + RepPANNeck, depth 0.33, width 0.25
    "yolov6n-office": (dict(
        build_type="office", depth_multiple=0.33, width_multiple=0.25,
        backbone=dict(type="EfficientRep", num_repeats=[1, 6, 12, 18, 6],
                      out_channels=[64, 128, 256, 512, 1024]),
        neck=dict(type="RepPANNeck", num_repeats=[12, 12, 12, 12],
                  out_channels=[256, 128, 128, 256, 256, 512]),
        head=_HEAD), "repvgg"),
    # configs/yolov6m.py: CSPBepBackbone + CSPRepPANNeck, depth 0.60,
    # width 0.75, csp_e 2/3, training_mode 'repvgg'
    "yolov6m-office": (dict(
        build_type="office", depth_multiple=0.60, width_multiple=0.75,
        backbone=dict(type="CSPBepBackbone", num_repeats=[1, 6, 12, 18, 6],
                      out_channels=[64, 128, 256, 512, 1024], csp_e=float(2) / 3),
        neck=dict(type="CSPRepPANNeck", num_repeats=[12, 12, 12, 12],
                  out_channels=[256, 128, 128, 256, 256, 512], csp_e=float(2) / 3),
        head=_HEAD), "repvgg"),
    # configs/yolov6l.py: CSPBepBackbone + CSPRepPANNeck, depth 1.0,
    # width 1.0, csp_e 1/2, training_mode 'conv_silu'
    "yolov6l-office": (dict(
        build_type="office", depth_multiple=1.0, width_multiple=1.0,
        backbone=dict(type="CSPBepBackbone", num_repeats=[1, 6, 12, 18, 6],
                      out_channels=[64, 128, 256, 512, 1024], csp_e=float(1) / 2),
        neck=dict(type="CSPRepPANNeck", num_repeats=[12, 12, 12, 12],
                  out_channels=[256, 128, 128, 256, 256, 512], csp_e=float(1) / 2),
        head=_HEAD), "conv_silu"),
}


def office_config_graph(name: str) -> Dict:
    """The graph dict of an OFFICE_CONFIGS entry."""
    model_cfg, training_mode = OFFICE_CONFIGS[name]
    return office_graph(model_cfg, training_mode)
