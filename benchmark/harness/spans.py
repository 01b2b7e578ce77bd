"""Spans kept in memory until the run ends.

A span is a named interval on the host's clock (``time.perf_counter``)
around one call into a layer of the program, with the frame or request it
belongs to and the thread that ran it. When the run is traced, each span is
also a ``torch.profiler.record_function`` range, so that it lies in the
profiler's timeline beside the device's work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    item: int            # the frame or request
    thread: str

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, item: int = -1):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function(f"bench::{name}#{item}" if item >= 0 else f"bench::{name}")
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append(Span(name, t0, t1, item,
                                           threading.current_thread().name))
