"""entry_overhead_ms.film: per frame, the host window of
``render.render_frame`` (the row-major list, the fused renderer's launches
and sums, the device tonemap, the copies back) less the path kernels'
device time inside it, in ms (the profiler's trace)."""

from benchmark.metrics._entry import overhead_ms


def read(run):
    return overhead_ms(run, "render_frame")
