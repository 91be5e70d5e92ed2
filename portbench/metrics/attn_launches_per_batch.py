"""psa_attention launches a batch in the window (the program's counter
ops/attention.py:psa_attention.launches, advanced at each replay): 2 for
YOLO11x, one a PSA block."""


def read(rec):
    n = rec.get("counters", {}).get("psa_attention")
    return None if n is None or not rec.get("batches") else n / rec["batches"]
