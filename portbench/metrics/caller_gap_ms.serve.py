"""Capture cache (core/graphs.py), at its edge: the device ms a batch from
the predict's last clone to the next call's copy (the client's own share:
its copy of the detections to the host, its wait, its bookkeeping), the
mean over the window's calls but the last of the program's spans
(program_spans.py). Read under the profiler, so an upper bound: the gap
also holds what the profiler adds to the client's calls and what the
spans cost the host at the predict's exit and entry."""
from portbench import program_spans as P


def read(rec):
    return P.mean_ms(rec, "caller_gap")
