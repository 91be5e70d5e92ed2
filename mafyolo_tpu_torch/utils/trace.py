"""The port's spans: one table in memory, written where the work happens.

A span is a named stretch of host time, opened as a context manager; it
records its name, its own id, the id of the span open around it on the same
thread (its parent) and the id of its root (its call id: a root's call id is
its own id), its host start and end, and any attributes given. A span that
issues device work may also mark its device start and end with CUDA timing
events (`start()`, `end()`); those are read only by `export()`, once the
caller has synchronized the device. The table keeps the last MAX_ROWS
closed spans: whoever reads it clears it (`clear()`).

Two kinds of span:

- set-up spans (`span`) record always: they happen once a key or once a
  process (a capture, a kernel library's load);
- hot-path spans (`hot`) record only while a torch profiler records
  (torch.autograd.profiler._is_profiler_enabled: the Trainer's --profile,
  an operator's own torch.profiler.profile). With the profiler off, `hot`
  costs one boolean test and returns a shared span that records nothing and
  creates no event.

Nothing here reaches the profiler: no record_function range, no NVTX mark.
A profiler range would add a device-typed annotation over the kernels it
covers, and with it device time that no kernel takes.

Host times are time.perf_counter_ns() (CLOCK_MONOTONIC). The profiler's
events are on the Unix clock (kineto converts its own clock to it);
`export()` gives `profiler_offset_ns`, which added to a host time puts it
on that clock: a profiler event's `time_range` is microseconds from the
trace's start (`prof.profiler.kineto_results.trace_start_ns()`), so a host
time t lies at (t + profiler_offset_ns - trace_start_ns) / 1e3 there.

Device times are milliseconds from the first device mark recorded on the
same card since the table was last cleared.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler


class _Off:
    """The span `hot` returns while no profiler records: records nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        pass

    def end(self):
        pass


OFF = _Off()


class Span:
    """One row of the table while it is open; see the module docstring."""
    __slots__ = ("table", "row", "device")

    def __init__(self, table, row, device):
        self.table, self.row, self.device = table, row, device

    def __enter__(self):
        stack = self.table._stack()
        parent = stack[-1] if stack else None
        self.row["parent"] = parent["id"] if parent else None
        self.row["call"] = parent["call"] if parent else self.row["id"]
        stack.append(self.row)
        self.row["host_ns"] = [time.perf_counter_ns(), None]
        return self

    def __exit__(self, *exc):
        self.row["host_ns"][1] = time.perf_counter_ns()
        stack = self.table._stack()
        if stack and stack[-1] is self.row:
            stack.pop()
        self.table.rows.append(self.row)
        return False

    def _mark(self, i, mark):
        self.row.setdefault("device", [None, None])[i] = mark

    def start(self):
        """Mark the device start: an event recorded now on the current stream
        of the span's device (no mark without a CUDA device)."""
        if self.device is not None:
            self._mark(0, self.table._record(self.device))

    def end(self):
        """Mark the device end, as start() marks the start."""
        if self.device is not None:
            self._mark(1, self.table._record(self.device))

    @property
    def seconds(self) -> float:
        """The host seconds of a closed span."""
        t0, t1 = self.row["host_ns"]
        return (t1 - t0) / 1e9


MAX_ROWS = 1 << 16     # a table's closed spans: some 13000 profiled predict calls


class Table:
    """The spans of one process; `TABLE` below is the port's."""

    def __init__(self, max_rows: int = MAX_ROWS):
        # the last max_rows closed spans, in the order they closed
        self.rows = deque(maxlen=max_rows)
        self._ids = itertools.count(1)
        self._local = threading.local()  # each thread's stack of open spans
        self._origin = {}                # card index -> the first device mark

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, device):
        """(event, card): a timing event recorded now on the current stream
        of `device`."""
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        card = torch.cuda.current_device() if device.index is None else device.index
        self._origin.setdefault(card, event)
        return event, card

    def span(self, name: str, device=None, **attrs) -> Span:
        """A set-up span: records always. `device` is the CUDA torch.device
        its device marks go to (None: it marks none); attrs are kept with
        the row."""
        return Span(self, {"name": name, "id": next(self._ids), **attrs}, device)

    def hot(self, name: str, device=None, **attrs):
        """A hot-path span: a span while a torch profiler records, else OFF."""
        if not _profiler._is_profiler_enabled:
            return OFF
        return self.span(name, device, **attrs)

    def export(self) -> dict:
        """The table as plain data: {"profiler_offset_ns", "spans"}, each span
        {"name", "id", "parent", "call", "host_ns": [start, end], attrs...,
        and "device_ms": [start, end] where it marked both}. Reads the
        device marks: synchronize the device first."""
        spans = []
        for row in list(self.rows):
            out = {k: v for k, v in row.items() if k != "device"}
            out["host_ns"] = list(row["host_ns"])
            marks = row.get("device")
            if marks is not None and None not in marks:
                out["device_ms"] = [self._origin[card].elapsed_time(ev)
                                    for ev, card in marks]
            spans.append(out)
        return {"profiler_offset_ns": profiler_offset_ns(), "spans": spans}

    def clear(self):
        """Empty the table, between calls (a span open across it would land in
        the emptied table with marks older than its new origin)."""
        self.rows.clear()
        self._origin = {}


def profiler_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the closest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


TABLE = Table()
span, hot, export, clear = TABLE.span, TABLE.hot, TABLE.export, TABLE.clear

