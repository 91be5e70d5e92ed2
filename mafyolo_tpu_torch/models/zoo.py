"""MAF-YOLO model graphs as plain Python specs.

These reproduce the layer graphs of the reference's configs/yaml/MAF-YOLO-{n,s,m}.yaml
(rows are [from, repeats, module, args] with the same per-module argument conventions
interpreted by parse_graph; see yolov6/models/yolo.py:15-120 for the reference parser).
The graphs are data, kept as Python so models build with zero file I/O. This file is a
copy of mafyolo_tpu/models/zoo.py (the JAX package cannot be imported without flax);
tests/test_torch_graph.py pins the two parses equal.

Architecture recap: P1/P2 RepVGG stem, four RepHDW stages with heterogeneous
large kernels (3/5/7/9) separated by MPRep downsamples, SPPF tail; the MAFPN neck
fuses P3..P5 via stride-2 ConvWrapper down-branches, nearest 2x up-branches and
multi-input Concats into RepHDW merge nodes; three Head_DepthUni decoupled heads.
"""

# Shared MAFPN + head topology: every MAF-YOLO variant uses the same wiring and differs
# only in channel widths / RepHDW depths, so the three graphs below are spelled out fully.

MAF_YOLO_N = dict(
    depth_multiple=1.0,
    width_multiple=0.375,
    backbone=[
        [-1, 1, "RepVGGBlock", [64, 3, 2]],      # 0  P1/2
        [-1, 1, "RepVGGBlock", [128, 3, 2]],     # 1  P2/4
        [-1, 1, "RepHDW", [48, True, 0.5, 3, 3]],
        [-1, 1, "MPRep", [256]],                  # 3  P3/8
        [-1, 1, "RepHDW", [96, True, 0.5, 5, 3]],
        [-1, 1, "MPRep", [512]],                  # 5  P4/16
        [-1, 1, "RepHDW", [192, True, 0.5, 7, 3]],
        [-1, 1, "MPRep", [1024]],                 # 7  P5/32
        [-1, 1, "RepHDW", [384, True, 0.5, 9, 3]],
        [-1, 1, "SPPF", [1024, 5]],               # 9
    ],
    neck=[
        [6, 1, "ConvWrapper", [96, 3, 2]],        # 10 P4->P5 down branch
        [[-1, 9], 1, "Concat", [1]],              # 11
        [-1, 1, "RepHDW", [192, False, 0.5, 9, 3]],   # 12 merge P5
        [-1, 1, "Upsample", [None, 2, "nearest"]],    # 13
        [4, 1, "ConvWrapper", [64, 3, 2]],        # 14 P3->P4 down branch
        [[-1, 6, -2], 1, "Concat", [1]],          # 15
        [-1, 1, "RepHDW", [128, False, 0.5, 7, 3]],   # 16 merge P4
        [-1, 1, "Upsample", [None, 2, "nearest"]],    # 17
        [2, 1, "ConvWrapper", [64, 3, 2]],        # 18 P2->P3 down branch
        [[-1, 4, -2], 1, "Concat", [1]],          # 19
        [-1, 1, "RepHDW", [128, False, 0.5, 5, 3]],   # 20 merge P3 (first)
        [[-1, 17], 1, "Concat", [1]],             # 21
        [-1, 1, "RepHDW", [128, False, 0.5, 5, 3]],   # 22 P3 out
        [-1, 1, "ConvWrapper", [128, 3, 2]],      # 23
        [20, 1, "ConvWrapper", [128, 3, 2]],      # 24
        [[-2, -1, 16, 13], 1, "Concat", [1]],     # 25
        [-1, 1, "RepHDW", [128, False, 0.5, 7, 3]],   # 26 P4 out
        [-1, 1, "ConvWrapper", [128, 3, 2]],      # 27
        [16, 1, "ConvWrapper", [128, 3, 2]],      # 28
        [[-2, -1, 12], 1, "Concat", [1]],         # 29
        [-1, 1, "RepHDW", [192, False, 0.5, 9, 3]],   # 30 P5 out
    ],
    effidehead=[
        [22, 1, "Head_DepthUni", [341, 16, 5]],   # 31
        [26, 1, "Head_DepthUni", [341, 16, 7]],   # 32
        [30, 1, "Head_DepthUni", [512, 16, 9]],   # 33
        [[31, 32, 33], 1, "Out", []],             # 34
    ],
)

MAF_YOLO_S = dict(
    depth_multiple=1.0,
    width_multiple=0.5,
    backbone=[
        [-1, 1, "RepVGGBlock", [64, 3, 2]],
        [-1, 1, "RepVGGBlock", [128, 3, 2]],
        [-1, 2, "RepHDW", [64, True, 0.5, 3, 3]],
        [-1, 1, "MPRep", [256]],
        [-1, 2, "RepHDW", [128, True, 0.5, 5, 3]],
        [-1, 1, "MPRep", [512]],
        [-1, 2, "RepHDW", [256, True, 0.5, 7, 3]],
        [-1, 1, "MPRep", [1024]],
        [-1, 2, "RepHDW", [512, True, 0.5, 9, 3]],
        [-1, 1, "SPPF", [1024, 5]],
    ],
    neck=[
        [6, 1, "ConvWrapper", [128, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [256, False, 0.5, 9, 3]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [4, 1, "ConvWrapper", [96, 3, 2]],
        [[-1, 6, -2], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [192, False, 0.5, 7, 3]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [2, 1, "ConvWrapper", [96, 3, 2]],
        [[-1, 4, -2], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [192, False, 0.5, 5, 3]],
        [[-1, 17], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [192, False, 0.5, 5, 3]],
        [-1, 1, "ConvWrapper", [192, 3, 2]],
        [20, 1, "ConvWrapper", [192, 3, 2]],
        [[-2, -1, 16, 13], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [192, False, 0.5, 7, 3]],
        [-1, 1, "ConvWrapper", [192, 3, 2]],
        [16, 1, "ConvWrapper", [192, 3, 2]],
        [[-2, -1, 12], 1, "Concat", [1]],
        [-1, 2, "RepHDW", [256, False, 0.5, 9, 3]],
    ],
    effidehead=[
        [22, 1, "Head_DepthUni", [384, 16, 5]],
        [26, 1, "Head_DepthUni", [384, 16, 7]],
        [30, 1, "Head_DepthUni", [512, 16, 9]],
        [[31, 32, 33], 1, "Out", []],
    ],
)

MAF_YOLO_M = dict(
    depth_multiple=1.0,
    width_multiple=0.75,
    backbone=[
        [-1, 1, "RepVGGBlock", [64, 3, 2]],
        [-1, 1, "RepVGGBlock", [128, 3, 2]],
        [-1, 2, "RepHDW", [96, True, 0.5, 3, 3]],
        [-1, 1, "MPRep", [256]],
        [-1, 4, "RepHDW", [192, True, 0.5, 5, 3]],
        [-1, 1, "MPRep", [512]],
        [-1, 4, "RepHDW", [384, True, 0.5, 7, 3]],
        [-1, 1, "MPRep", [1024]],
        [-1, 2, "RepHDW", [768, True, 0.5, 9, 3]],
        [-1, 1, "SPPF", [1024, 5]],
    ],
    neck=[
        [6, 1, "ConvWrapper", [256, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [512, False, 0.5, 9, 3]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [4, 1, "ConvWrapper", [192, 3, 2]],
        [[-1, 6, -2], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [384, False, 0.5, 7, 3]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [2, 1, "ConvWrapper", [192, 3, 2]],
        [[-1, 4, -2], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [384, False, 0.5, 5, 3]],
        [[-1, 17], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [256, False, 0.5, 5, 3]],
        [-1, 1, "ConvWrapper", [192, 3, 2]],
        [20, 1, "ConvWrapper", [192, 3, 2]],
        [[-2, -1, 16, 13], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [384, False, 0.5, 7, 3]],
        [-1, 1, "ConvWrapper", [192, 3, 2]],
        [16, 1, "ConvWrapper", [192, 3, 2]],
        [[-2, -1, 12], 1, "Concat", [1]],
        [-1, 3, "RepHDW", [384, False, 0.5, 9, 3]],
    ],
    effidehead=[
        [22, 1, "Head_DepthUni", [341, 16, 5]],
        [26, 1, "Head_DepthUni", [512, 16, 7]],
        [30, 1, "Head_DepthUni", [512, 16, 9]],
        [[31, 32, 33], 1, "Out", []],
    ],
)

MODEL_ZOO = {
    "maf-yolo-n": MAF_YOLO_N,
    "maf-yolo-s": MAF_YOLO_S,
    "maf-yolo-m": MAF_YOLO_M,
}
