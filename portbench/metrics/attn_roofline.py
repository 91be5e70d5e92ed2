"""PSA attention (ops/attention.py): the bound of a batch's attentions over
the device ms a batch of their kernels (attn_ms.serve), in %. The bound
(reference/yolo11.py:attention_counts): q, k and v read once and the
output written once in bf16, 2 (dk + dv) N^2 operations a head at the bf16
peak; YOLO11x at bs32@640, 2 blocks of 6 heads over 400 cells: 59.0 MB,
11.8 GFLOP, 0.0176 ms, bytes-bound."""
from pathlib import Path

from portbench import harness
from portbench import yardstick as Y
from portbench.reference import yolo11 as RY

_ms = harness.load_module(Path(__file__).with_name("attn_ms.serve.py"), "pb_attn_ms")


def read(rec):
    if rec.get("config", {}).get("reference") != "yolo11":
        return None
    ms = _ms.read(rec)
    if ms is None:
        return None
    nbytes, ops = RY.attention_counts(rec["config"], rec["batch"], rec["img"])
    return 100.0 * Y.bound_ms(nbytes, ops, "bf16") / ms
