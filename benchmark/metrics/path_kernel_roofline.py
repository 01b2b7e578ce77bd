"""path_kernel_roofline: the least time an H100 could take for the
window's path work (benchmark/harness/roofline.py: the reference's path
events on the checked pixels scaled to the window's samples, and the
scene's tables read once and the output written once per request) over the
path kernels' device time, in %."""

from benchmark.harness import roofline
from benchmark.harness.trace import PATH_KERNELS


def read(run):
    if run.trace is None or not run.counts.get("samples"):
        return None
    t = run.trace.device_time(PATH_KERNELS)
    if t <= 0:
        return None
    cfg = run.cell.config["render"]
    pixels = cfg["image_width"] * cfg["image_height"]
    flop = roofline.flops(run.counts, run.samples / run.counts["samples"])
    nbytes = sum(run.table_bytes) + 12 * pixels * len(run.done)
    least, _ = roofline.least_seconds(flop, nbytes)
    return 100.0 * least / t
