"""Where one sample's time goes on the card: a profiler trace of the
integrator over one tile.

    python3 -m pathtracing_tpu_torch.trace_sample [--lanes N] [--trace FILE]
                                                  [--wide]

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
take most device time, with the ray-query kernel's share singled out.
``--wide`` packs the scene with the wide-BVH mega-table (layout w8), so the
ray queries go through the wide kernel; nothing else changes.

``--grad`` profiles one chunk of the frame gradient instead
(``diff/render.make_fast_grad_frame_fn``'s pass 2 at 1 spp, every field):
the megakernel's record build (K6) records the 1080p frame once, outside
the profile, and the profiled step is the autograd replay of the frame's
last ``--lanes`` items (default ``REPLAY_CHUNK``, the bottom rows, where the
geometry is) and its backward. The wide tables are implied. The output then
also gives the share of the gathers' backward kernels (K7a ``stg_*``, K7b
``rowg_*``) and of PyTorch's index backward (``indexing_backward*``, the
transpose of a plain gather; none is left on the gradient path).

CUDA only; it raises without a card.
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
from pathtracing_tpu_torch.diff.render import (
    DIFFERENTIABLE_FIELDS,
    REPLAY_CHUNK,
    frame_items,
    replay_value_and_grad,
)
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel
from pathtracing_tpu_torch.render import default_tile_pixels
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.utils.goldenio import load_golden

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    n_frame = PRODUCTION.image_width * PRODUCTION.image_height
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    ap.add_argument("--wide", action="store_true",
                    help="pack the scene with the wide-BVH mega-table")
    ap.add_argument("--grad", action="store_true",
                    help="profile one replay chunk of the frame gradient")
    args = ap.parse_args()
    wide = args.wide or args.grad

    cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=8)
    scene = scene_device_from_golden(
        load_golden(str(GOLDEN / "scene.gold")), cfg, wide=wide
    )
    lanes = args.lanes or (REPLAY_CHUNK if args.grad
                           else min(default_tile_pixels(scene), n_frame))
    if args.grad:
        xs, ys, si = frame_items(cfg, n_frame, 1, 0, torch.device("cuda"))
        _, (prim, bounce) = path_trace_megakernel(cfg, scene, n_frame, 1, record=True)
        part = slice(n_frame - lanes, n_frame)
        xs, ys, si = xs[part], ys[part], si[part]
        records = ({k: v[part] for k, v in prim.items()},
                   {k: v[:, part] for k, v in bounce.items()})
    else:
        idx = torch.arange(lanes, dtype=torch.int32, device="cuda")
        xs, ys = idx % cfg.image_width, idx // cfg.image_width
        si = torch.zeros_like(xs)

    def sample():
        if args.grad:
            replay_value_and_grad(cfg, scene, xs, ys, si, records, None,
                                  DIFFERENTIABLE_FIELDS)
        else:
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
    k7_ms = sum(r[2] for r in device if "stg_" in r[0] or "rowg_" in r[0])
    ib_ms = sum(r[2] for r in device if "indexing_backward" in r[0])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi, "lanes": lanes, "bounces": cfg.max_bounces,
        "wide": wide, "grad": args.grad,
        "sample_wall_ms": wall_ms,
        "profiled_sample_wall_ms": profiled_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share_profiled": 1.0 - busy_ms / profiled_wall_ms,
        "device_idle_share_vs_unprofiled_wall": 1.0 - busy_ms / wall_ms,
        "device_kernels": sum(r[1] for r in device),
        "ray_query_kernel_ms": rq_ms,
        "ray_query_share_of_busy": rq_ms / busy_ms,
        "gather_grad_kernels_ms": k7_ms,
        "gather_grad_share_of_busy": k7_ms / busy_ms,
        "indexing_backward_ms": ib_ms,
        "indexing_backward_share_of_busy": ib_ms / busy_ms,
        "top_kernels": [
            {"name": k[:80], "count": c, "ms": ms} for k, c, ms in device[:12]
        ],
    }))


if __name__ == "__main__":
    main()
