"""Capture cache (core/graphs.py): the device ms a batch from the fast
graph's last node to the call's next device op (the host's read of the
overflow flag, then the dense replay or the clones), the mean over the
window's calls of the program's spans (program_spans.py)."""
from portbench import program_spans as P


def read(rec):
    return P.mean_ms(rec, "flag_gap")
