"""Device idle share of the serve window: 1 - (union of the device's
kernel, copy and set spans) / (the window's host seconds), in %."""


def read(rec):
    if "busy_s" not in rec or "batches" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
