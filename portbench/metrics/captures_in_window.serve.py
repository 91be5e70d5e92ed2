"""CUDA-graph captures during the window (core/graphs.py:PredictGraphs
.captures after minus before): 0 when the window's one key was captured at
set-up; a capture in the window costs a warm-up and two captures."""


def read(rec):
    return rec.get("counters", {}).get("captures")
