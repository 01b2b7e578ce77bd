"""path_kernel_ms_per_msample: the path kernels' device time in the window
(the profiler's kernels named megakernel or wavefront: K2 and K5), in ms
per million samples rendered in the window."""

from benchmark.harness.trace import PATH_KERNELS


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_time(PATH_KERNELS)
    if t <= 0 or run.samples == 0:
        return None
    return 1e3 * t / (run.samples / 1e6)
