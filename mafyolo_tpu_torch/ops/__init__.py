"""The port's kernels and their wrappers. Importing the package registers
the custom ops `mafyolo::greedy_nms`, `mafyolo::int8_conv`,
`mafyolo::int8_dw` and `mafyolo::dw_conv`, which a program saved by tools/export.py calls: import
it before `torch.export.load` of such a program."""
from mafyolo_tpu_torch.ops import dw_deploy, greedy_nms, quant_conv  # noqa: F401
