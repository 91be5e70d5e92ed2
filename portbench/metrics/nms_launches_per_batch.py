"""greedy_nms launches a batch in the window (the program's counter
ops/greedy_nms.py:greedy_nms.launches, advanced at each replay): 1 on the
fast path, 9 where the batch overflows to the dense stage."""


def read(rec):
    n = rec.get("counters", {}).get("greedy_nms")
    return None if n is None or not rec.get("batches") else n / rec["batches"]
