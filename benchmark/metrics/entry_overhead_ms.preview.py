"""entry_overhead_ms.preview: per request, the host window of
``render.render_pixels`` and ``render.to_bgra`` (the list check, the
launch, the sums to the host, back up to tonemap, the BGRA down) less the
path kernels' device time inside it, in ms (the profiler's trace)."""

from benchmark.metrics._entry import overhead_ms


def read(run):
    return overhead_ms(run, "render_pixels")
