"""Kernel loader (ops/_build.py): set-up's seconds in the program's
`kernels.load` spans (a library built with nvcc or found built, and
loaded), summed over the run's process (program_spans.py)."""
from portbench import program_spans as P


def read(rec):
    return P.seconds(rec, "kernels.load")
