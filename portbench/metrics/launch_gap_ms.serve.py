"""Capture cache (core/graphs.py): the device ms a batch from the end of the
copy of the batch into the graph's input to the fast replay's launch (the
host's return from the copy; the launch's own latency lies in the graph's
interval), the mean over the window's calls of the program's spans
(program_spans.py)."""
from portbench import program_spans as P


def read(rec):
    return P.mean_ms(rec, "launch_gap")
