"""Where one sample's time goes on the card: a profiler trace of the
integrator over one tile.

    python3 -m pathtracing_tpu_torch.trace_sample [--lanes N] [--trace FILE]

Runs ``path_trace_samples`` on the golden scene at the PRODUCTION preset's
geometry (1920x1080, 5 bounces) for one sample on ``--lanes`` pixels (default:
the frame's first render tile): once to warm up, once timed, once under
``torch.profiler``. Prints one JSON object: the wall time of the unprofiled
and of the profiled sample, the device busy time, and two idle shares.
``device_idle_share_profiled`` pairs busy and wall time of the one profiled
sample; the profiler slows the host, so it is an upper estimate.
``device_idle_share_vs_unprofiled_wall`` sets the same busy time against the
unprofiled sample's wall time: two runs, valid as far as a kernel takes the
same time with the profiler on. Neither is clipped: busy time above either
wall time raises. Then the number of device kernels and the kernels that
take most device time, with the ray-query kernel's share singled out. CUDA
only; it raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pathtracing_tpu_torch.config import PRODUCTION
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.render import CUDA_TILE_PIXELS
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.utils.goldenio import load_golden

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--lanes", type=int,
        default=min(CUDA_TILE_PIXELS, PRODUCTION.image_width * PRODUCTION.image_height),
    )
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()

    cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=8)
    scene = scene_device_from_golden(load_golden(str(GOLDEN / "scene.gold")), cfg)
    idx = torch.arange(args.lanes, dtype=torch.int32, device="cuda")
    xs, ys = idx % cfg.image_width, idx // cfg.image_width
    si = torch.zeros_like(xs)

    def sample():
        path_trace_samples(cfg, scene, xs, ys, si)
        torch.cuda.synchronize()

    sample()  # warm-up: builds the kernel, fills the allocator's pools
    t0 = time.perf_counter()
    sample()
    wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        pathlib.Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    device = [
        (e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e3)
        for e in prof.key_averages()
        if getattr(e, "self_device_time_total", 0.0) > 0
        and getattr(e, "device_type", None) is not None
        and "cuda" in str(e.device_type).lower()
    ]
    device.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in device)
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    if busy_ms > min(wall_ms, profiled_wall_ms):
        raise RuntimeError(
            f"device busy {busy_ms} ms exceeds a sample's wall time "
            f"({wall_ms} ms unprofiled, {profiled_wall_ms} ms profiled): "
            "the two runs do not belong together or the trace is wrong"
        )
    rq_ms = sum(r[2] for r in device if "ray_query_kernel" in r[0])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi, "lanes": args.lanes, "bounces": cfg.max_bounces,
        "sample_wall_ms": wall_ms,
        "profiled_sample_wall_ms": profiled_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / profiled_wall_ms,
        "device_idle_share_vs_unprofiled_wall": 1.0 - busy_ms / wall_ms,
        "device_kernels": sum(r[1] for r in device),
        "ray_query_kernel_ms": rq_ms,
        "ray_query_share_of_busy": rq_ms / busy_ms,
        "top_kernels": [
            {"name": k[:80], "count": c, "ms": ms} for k, c, ms in device[:8]
        ],
    }))


if __name__ == "__main__":
    main()
