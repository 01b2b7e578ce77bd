"""The render entry's own time per request: the host window of the
harness's ``render_entry`` span in the profiler's timeline, less the path
kernels' device time inside it. Shared by the entry_overhead_ms readers."""

from benchmark.harness.trace import PATH_KERNELS


def overhead_ms(run, entry: str):
    if run.trace is None or run.cell.traffic["route"]["entry"] != entry:
        return None
    spans = run.trace.spans_named("render_entry")
    if not spans:
        return None
    own = [(e - s) - run.trace.device_time(PATH_KERNELS, s, e) for _, _, _, s, e in spans]
    return 1e3 * sum(own) / len(own)
