"""Tracing / metrics (the JAX package's ``utils/profiling.py``).

The reference's only instrumentation is std::chrono prints
(reference: main.cc:65-105). Here:

  * ``trace_to(dir)`` — context manager around ``torch.profiler``: host and
    (on a CUDA device) device activity, exported as a Chrome trace
    ``dir/trace.json`` (chrome://tracing, Perfetto).
  * ``MetricsLog`` — structured JSON-lines per-frame metrics
    (samples/s, rays upper bound, stage timings), the machine-readable
    counterpart of the CLI's human prints.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a host + device trace, written to ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLog:
    def __init__(self, path: str | None):
        self._path = path
        self._f = open(path, "a") if path else None

    def log(self, **fields):
        fields.setdefault("t", time.time())
        if self._f:
            self._f.write(json.dumps(fields) + "\n")
            self._f.flush()
        return fields

    def frame(
        self,
        frame_index: int,
        setup_s: float,
        render_s: float,
        n_samples: int,
        max_bounces: int,
        **extra,
    ):
        # <=1 primary + bounces*(1 closest + 1 shadow) queries per sample
        rays_upper = n_samples * (1 + 2 * max_bounces)
        return self.log(
            kind="frame",
            frame=frame_index,
            setup_ms=round(setup_s * 1e3, 1),
            render_ms=round(render_s * 1e3, 1),
            msamples_per_s=round(n_samples / render_s / 1e6, 4),
            mrays_per_s_upper=round(rays_upper / render_s / 1e6, 4),
            **extra,
        )

    def close(self):
        if self._f:
            self._f.close()
