"""The profiler's trace of a window, reduced to intervals.

A traced run wraps its window in ``torch.profiler`` (host and CUDA
activity). ``reduce`` keeps, on one clock in seconds from the window's
start: every device activity (kernels, copies, sets: name, start, end) and
every harness span (``bench::<name>#<item>`` ranges: name, item, thread,
start, end). The metric readers take their numbers from these.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import re

_SPAN = re.compile(r"^bench::([^#]+)(?:#(-?\d+))?$")
# the path kernels' device names: K2 (megakernel) and K5 (wavefront), not
# the record build K6 (megakernel_record)
PATH_KERNELS = r"(^|[^A-Za-z0-9_])(megakernel|wavefront)(<|\(|$)"


@dataclasses.dataclass
class Trace:
    window_s: float
    device: list      # (name, start, end), seconds from the window's start
    spans: list       # (name, item, thread id, start, end)

    def __hash__(self):
        return id(self)

    @functools.cache
    def _union(self, pattern=None):
        """The union of the device activity whose name matches ``pattern``
        (None: all), clipped to the window: (starts, ends, cumulative
        seconds before each interval), sorted."""
        rx = re.compile(pattern) if pattern is not None else None
        iv = sorted((max(s, 0.0), min(e, self.window_s)) for n, s, e in self.device
                    if e > 0.0 and s < self.window_s and (rx is None or rx.search(n)))
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        starts = [s for s, _ in out]
        ends = [e for _, e in out]
        before = [0.0]
        for s, e in out:
            before.append(before[-1] + e - s)
        return starts, ends, before

    def busy_intervals(self):
        """The union of device activity in the window, merged and sorted."""
        starts, ends, _ = self._union()
        return list(zip(starts, ends))

    def _covered(self, pattern, t: float) -> float:
        """Seconds of the union of ``pattern``'s activity before time t."""
        starts, ends, before = self._union(pattern)
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        return before[i - 1] + min(t, ends[i - 1]) - starts[i - 1]

    def busy_s(self, lo: float = 0.0, hi: float | None = None) -> float:
        """Seconds in [lo, hi] in which the device ran something."""
        hi = self.window_s if hi is None else hi
        return self._covered(None, hi) - self._covered(None, lo)

    def device_time(self, pattern, lo: float = 0.0, hi: float | None = None) -> float:
        """Seconds in [lo, hi] in which device activity whose name matches
        ``pattern`` ran."""
        hi = self.window_s if hi is None else hi
        return self._covered(pattern, hi) - self._covered(pattern, lo)

    def spans_named(self, name: str):
        return [s for s in self.spans if s[0] == name]


def profile():
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts)


def reduce(prof) -> Trace:
    """The ``bench::window`` range of a finished profile and what lies in it."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if "cuda" in str(e.device_type()).lower():
            # the harness's ranges are mirrored on the device's timeline as
            # annotations: they are no device work
            if not name.startswith("bench::"):
                device.append((name, t0, t1))
            continue
        m = _SPAN.match(name)
        if m:
            spans.append((m.group(1), int(m.group(2) or -1), e.start_thread_id(), t0, t1))
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("the trace has no bench::window range")
    w0, w1 = win[0][3], win[0][4]
    shift = lambda iv: [(*x[:-2], x[-2] - w0, x[-1] - w0) for x in iv]
    return Trace(window_s=w1 - w0, device=shift(device), spans=shift(spans))


def idle_gaps(trace: Trace, main_thread, top: int = 10):
    """Idle device seconds in the window by what the client thread was
    doing: each gap between device activities is given the innermost
    harness span of that thread that covers the gap's middle."""
    busy = trace.busy_intervals()
    gaps, t = [], 0.0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < trace.window_s:
        gaps.append((t, trace.window_s))
    mine = sorted((s for s in trace.spans if s[2] == main_thread and s[0] != "window"),
                  key=lambda s: s[3])
    starts = [s[3] for s in mine]
    longest = max((s[4] - s[3] for s in mine), default=0.0)
    by = {}
    for a, b in gaps:
        mid = (a + b) / 2
        # the spans that start by mid and could still cover it
        i = bisect.bisect_right(starts, mid)
        j = bisect.bisect_left(starts, mid - longest)
        cover = [s for s in mine[j:i] if s[4] >= mid]
        label = min(cover, key=lambda s: s[4] - s[3])[0] if cover else "between requests"
        by[label] = by.get(label, 0.0) + (b - a)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_device_ops(trace: Trace, top: int = 10):
    """The device operations that took the most time in the window."""
    by = {}
    for n, s, e in trace.device:
        d = max(0.0, min(e, trace.window_s) - max(s, 0.0))
        if d > 0:
            by[n] = by.get(n, 0.0) + d
    return sorted(([k[:200], v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
