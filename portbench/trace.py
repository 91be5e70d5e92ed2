"""The traced window: torch.profiler over the measured window, reduced to
device time by kernel name, the device's busy time (the union of its
kernel, copy and set spans), and the breakdown: the device operations that
took most time and the idle gaps between device spans, summed by the
benchmark's own host span ("pb.*", torch.profiler.record_function) that was
open when each gap began."""
from __future__ import annotations

import torch

from portbench.yardstick import span_union

SPAN = "pb."


def span(name: str):
    """A host span of the benchmark's own around a call into the program."""
    return torch.profiler.record_function(SPAN + name)


class Window:
    """with Window(on) as w: ...; then w.reduce(window_s) -> dict."""

    def __init__(self, on: bool):
        self.on, self.prof = on, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def reduce(self, window_s: float, chips: int = 1) -> dict:
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in self.prof.events():
            if e.name.startswith(SPAN):
                if e.device_type != DeviceType.CUDA:
                    host.append((e.time_range.start, e.time_range.end, e.name[len(SPAN):]))
            elif e.device_type == DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        host.sort()
        busy_us, by_name = span_union(dev)
        gaps, end, opened, j = {}, None, [], 0
        for a, b, _ in dev:
            if end is not None and a > end:
                # the benchmark's spans nest: a stack of those open at `end`
                while j < len(host) and host[j][0] <= end:
                    while opened and opened[-1][1] < host[j][0]:
                        opened.pop()
                    opened.append(host[j])
                    j += 1
                while opened and opened[-1][1] < end:
                    opened.pop()
                label = opened[-1][2] if opened else "outside the benchmark's spans"
                gaps[label] = gaps.get(label, 0.0) + (a - end) / 1e6
            end = b if end is None else max(end, b)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"kernel_us": by_name, "busy_s": busy_us / 1e6 / chips,
                "window_s": window_s,
                "breakdown": {"device_ops": [[n, us / 1e6] for n, us in top],
                              "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                                  key=lambda kv: -kv[1])[:10]}}

