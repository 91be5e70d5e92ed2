"""Capture cache (core/graphs.py): set-up's seconds in the program's
`capture` spans (a key's warm-up on the side stream and its two graph
captures), less the kernel libraries' loads inside them (kernels.load),
summed over the run's process (program_spans.py)."""
from portbench import program_spans as P


def read(rec):
    return P.seconds(rec, "capture", less="kernels.load")
