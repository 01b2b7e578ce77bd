"""Command-line frame renderer (reference frame loop: main.cc:60-108); the JAX
package's ``cli.py``.

    python -m pathtracing_tpu_torch.cli --data-dir DIR --preset testing --frames 0 1 --spp 16
    python -m pathtracing_tpu_torch.cli --device cpu --data-dir DIR --width 32 --height 18 --spp 2

Renders frames of the full animated scene (or a static preset) to
output/frame_%04d.bmp with per-stage timing prints mirroring the
reference's, and frame-granular resume (--resume skips existing frames).
``--adaptive BASE`` renders each frame by variance-guided adaptive sampling
(adaptive.py) and ``--aovs`` also writes its primary-hit AOV buffers
(aov.py) to frame_NNNN.aovs.npz, as the JAX package's CLI does.
The meshes come from --data-dir (or $PT_DATA_DIR): the reference's data
folder, or stand-ins written by ``scene/standins.write_standins``.

It renders on the CUDA device and raises when there is none; ``--device
cpu`` renders on the CPU (the kernels' plain versions). While frame N
renders, a worker thread evaluates the animation, builds the subframe
TLASes and packs frame N+1. ``--metrics`` lines carry, per frame, the
launches of each kernel during its render, the bytes of each device table
and, on a CUDA device, the peak of allocated device memory (and the
placement's launches during load_scene).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def _kernel_modules():
    """The kernel wrappers whose launches the metrics report."""
    from pathtracing_tpu_torch.ops import (
        cuda_megakernel,
        cuda_traversal,
        cuda_wavefront,
        cuda_wide_traversal,
    )

    return {"ray_query": cuda_traversal, "wide_ray_query": cuda_wide_traversal,
            "megakernel": cuda_megakernel, "wavefront": cuda_wavefront}


def _reset_launches(mods) -> None:
    for mod in mods.values():
        mod.reset_launches()


def _launches(mods) -> dict:
    return {name: mod.launches for name, mod in mods.items()}


def _table_bytes(dev) -> dict:
    """Bytes of each device table of a packed frame."""
    return {k: v.numel() * v.element_size() for k, v in dev._asdict().items()
            if v is not None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["testing", "production"], default="testing")
    ap.add_argument(
        "--model",
        choices=["full_animation", "teapot_rocks", "cornell_box", "sphere_ground"],
        default="full_animation",
        help="scene preset (pathtracing_tpu_torch/models); full_animation is "
        "the reference's animated scene, the others are static",
    )
    ap.add_argument("--frames", type=int, nargs=2, default=[0, 1], metavar=("BEGIN", "END"))
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--out", default="output")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default=None,
        help="cuda (the default; raises when there is no CUDA device) or cpu",
    )
    ap.add_argument("--resume", action="store_true", help="skip existing frames")
    ap.add_argument(
        "--tile-pixels", type=int, default=None,
        help="pixels per scan / wavefront tile (default: the tuning table's "
             "tile_pixels for the device type and the scene's size, "
             "pathtracing_tpu_torch/tuning.py; $PT_TUNED_FILE over its builtin rows)",
    )
    ap.add_argument(
        "--sample-range",
        type=int,
        nargs=2,
        metavar=("A", "B"),
        help="render only samples [A,B) per frame, writing partial "
        "accumulations (frame_NNNN.part_A_B.npz) instead of BMPs; "
        "partials from any machine merge with --merge",
    )
    ap.add_argument(
        "--merge",
        action="store_true",
        help="merge partial sample accumulations in --out into BMPs",
    )
    ap.add_argument(
        "--metrics",
        default=None,
        help="append JSON-lines per-frame metrics to this file",
    )
    ap.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace of the first frame",
    )
    ap.add_argument(
        "--wavefront",
        action="store_true",
        help="use the wavefront renderer (ops/wavefront.py)",
    )
    ap.add_argument(
        "--wide",
        choices=["auto", "1", "0"],
        default="auto",
        help="attach the wide-BVH mega-table fast path (accel/wide.py; "
        "enables the megakernel on a CUDA device). auto = on when the "
        "device is CUDA",
    )
    ap.add_argument(
        "--shard",
        action="store_true",
        help="shard each frame over all local devices (tiles axis)",
    )
    ap.add_argument(
        "--adaptive",
        type=int,
        default=None,
        metavar="BASE_SPP",
        help="variance-guided adaptive sampling: uniform BASE_SPP pass, "
        "then allocate the remaining (spp - BASE_SPP) x pixels budget "
        "where the luminance variance is",
    )
    ap.add_argument(
        "--aovs",
        action="store_true",
        help="also write frame_NNNN.aovs.npz (albedo/normal/depth/coverage "
        "primary-hit buffers)",
    )
    args = ap.parse_args(argv)

    if args.adaptive is not None:
        if args.sample_range or args.shard:
            ap.error("--adaptive cannot combine with --sample-range/--shard")
        spp_total = args.spp or (
            256 if args.preset == "testing" else 1024
        )
        if not (1 <= args.adaptive <= spp_total):
            ap.error(f"--adaptive BASE must be in [1, spp={spp_total}]")

    if args.merge:
        return merge_partials(args)

    # The device rule of the port: CUDA, or the CPU on request; no fallback.
    from pathtracing_tpu_torch.utils.platform import ensure_backend

    device = ensure_backend(args.device)
    print(f"backend: {device.type}", flush=True)

    import torch

    from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX
    from pathtracing_tpu_torch.config import PRODUCTION, TESTING
    from pathtracing_tpu_torch.io.bmp import write_bmp
    from pathtracing_tpu_torch.render import render_frame
    from pathtracing_tpu_torch.scene.device import DevicePacker
    from pathtracing_tpu_torch.scene.loader import (
        get_animation_frame_count,
        load_scene,
        setup_animation_frame,
    )

    config = TESTING if args.preset == "testing" else PRODUCTION
    overrides = {}
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_bounces:
        overrides["max_bounces"] = args.max_bounces
    if args.width:
        overrides["image_width"] = args.width
    if args.height:
        overrides["image_height"] = args.height
    if overrides:
        config = dataclasses.replace(config, **overrides)

    os.makedirs(args.out, exist_ok=True)

    from pathtracing_tpu_torch.utils.profiling import MetricsLog, trace_to
    import contextlib

    metrics = MetricsLog(args.metrics)
    kernels = _kernel_modules()
    _reset_launches(kernels)

    wide = (device.type == "cuda") if args.wide == "auto" else args.wide == "1"
    t0 = time.perf_counter()
    if args.model != "full_animation":
        from pathtracing_tpu_torch import models

        kw = (
            {"data_dir": args.data_dir}
            if args.data_dir and args.model == "teapot_rocks"
            else {}
        )
        if args.model == "teapot_rocks":
            kw["wide"] = wide
        _, static_dev = models.build(args.model, config, device=device, **kw)
        scene = packer = None
        load_s, packer_s = time.perf_counter() - t0, 0.0  # the preset packs
    else:
        scene = load_scene(data_dir=args.data_dir, config=config, device=device)
        load_s = time.perf_counter() - t0
        packer = DevicePacker(scene, wide=wide, chunk_max=CHUNK_MAX if wide else None,
                              device=device)
        packer_s = time.perf_counter() - t0 - load_s
    print(
        f"EXECUTION TIME OF load_scene() : "
        f"{(time.perf_counter()-t0)*1e3:.0f}ms"
    )
    metrics.log(kind="load", model=args.model, device=device.type, wide=wide,
                load_ms=round(load_s * 1e3, 1), packer_ms=round(packer_s * 1e3, 1),
                launches=_launches(kernels))

    begin, end = args.frames
    if args.model != "full_animation":
        end = min(end, begin + 1)  # static scene: one frame
    else:
        end = min(end, get_animation_frame_count(config))

    todo = []
    for frame_index in range(begin, end):
        out_path = os.path.join(args.out, f"frame_{frame_index:04d}.bmp")
        if args.resume and os.path.exists(out_path):
            print(f"FRAME #{frame_index} exists, skipping")
            continue
        todo.append((frame_index, out_path))

    def setup_pack(frame_index):
        """Host-side frame prep: animation eval + subframe TLAS builds + pack.

        Runs on a worker thread for frame N+1 while the device renders frame
        N (the reference's TLAS build is likewise host work off the render's
        critical path, scene.cc:698-710). Safe because the render only touches
        the already-packed device tables, never `scene`; the uploads go to
        the device's default stream, so they are ordered before the render
        that reads them.
        """
        if scene is None:
            return static_dev, 0.0, 0.0  # static preset: already packed
        t0 = time.perf_counter()
        setup_animation_frame(scene, frame_index, config)
        t1 = time.perf_counter()
        dev = packer.pack_frame(scene)
        t2 = time.perf_counter()
        return dev, t2 - t0, t2 - t1

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    total_t0 = time.perf_counter()
    next_fut = pool.submit(setup_pack, todo[0][0]) if todo else None
    for i, (frame_index, out_path) in enumerate(todo):
        dev, setup_s, pack_s = next_fut.result()
        if i + 1 < len(todo):
            next_fut = pool.submit(setup_pack, todo[i + 1][0])
        print(
            f"FRAME #{frame_index} EXECUTION TIME OF setup_animation_frame() : "
            f"{setup_s*1e3:.0f}ms"
        )

        profile_ctx = (
            trace_to(args.profile_dir)
            if args.profile_dir and frame_index == begin
            else contextlib.nullcontext()
        )
        _reset_launches(kernels)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        image = None
        passes = {}  # the adaptive passes' and the AOV pass's host seconds
        with profile_ctx:  # the trace's start and export stay outside the time
            t0 = time.perf_counter()
            if args.sample_range:
                a, b = args.sample_range
                from pathtracing_tpu_torch.render import render_pixels

                W, H = config.image_width, config.image_height
                idx = np.arange(W * H, dtype=np.int32)
                sums = render_pixels(
                    config, dev, idx % W, idx // W,
                    spp=b - a, sample_base=a, average=False,
                    tile_pixels=args.tile_pixels, wavefront=args.wavefront,
                    device=device,
                ).reshape(H, W, 3)
                part = os.path.join(
                    args.out, f"frame_{frame_index:04d}.part_{a}_{b}.npz"
                )
                np.savez_compressed(part, sums=sums, sample_range=(a, b))
            elif args.shard:
                from pathtracing_tpu_torch.parallel.multihost import local_device_mesh
                from pathtracing_tpu_torch.parallel.sharding import render_frame_sharded
                from pathtracing_tpu_torch.render import to_bgra

                colors = render_frame_sharded(
                    config, dev, local_device_mesh(device_type=device.type),
                    wavefront=args.wavefront,
                )
                image = to_bgra(colors, device=device)
            elif args.adaptive is not None:
                from pathtracing_tpu_torch.adaptive import render_adaptive
                from pathtracing_tpu_torch.render import to_bgra

                W, H = config.image_width, config.image_height
                idx = np.arange(W * H, dtype=np.int32)
                colors, counts = render_adaptive(
                    config, dev, idx % W, idx // W,
                    spp_base=args.adaptive, spp_total=config.samples_per_pixel,
                    tile_pixels=args.tile_pixels, wavefront=args.wavefront,
                    device=device, timings=passes,
                )
                colors = colors.reshape(H, W, 3)
                print(
                    f"FRAME #{frame_index} adaptive samples/pixel: "
                    f"min={counts.min()} mean={counts.mean():.1f} "
                    f"max={counts.max()}"
                )
                image = to_bgra(colors, device=device)
            else:
                colors, image = render_frame(
                    config, dev, tile_pixels=args.tile_pixels,
                    wavefront=args.wavefront, device=device,
                )
            if args.aovs:
                from pathtracing_tpu_torch.aov import render_aovs

                t_aov = time.perf_counter()
                W, H = config.image_width, config.image_height
                idx = np.arange(W * H, dtype=np.int32)
                aovs = render_aovs(
                    config, dev, idx % W, idx // W,
                    spp=min(config.samples_per_pixel, 8),
                    tile_pixels=args.tile_pixels, device=device,
                )
                passes["aov_s"] = time.perf_counter() - t_aov
                np.savez_compressed(
                    os.path.join(args.out, f"frame_{frame_index:04d}.aovs.npz"),
                    **{k: v.reshape(H, W, -1).squeeze() for k, v in aovs.items()},
                )
            dt = time.perf_counter() - t0
        n_samples = config.image_width * config.image_height * (
            (args.sample_range[1] - args.sample_range[0])
            if args.sample_range
            else config.samples_per_pixel
        )
        print(
            f"FRAME #{frame_index} EXECUTION TIME OF render() : {dt*1e3:.0f}ms "
            f"({n_samples/dt/1e6:.2f} Msamples/s)"
        )
        # pack_ms: the part of setup_ms in pack_frame, whose uploads wait on
        # the device's default stream behind the previous frame's render
        extra = {"pack_ms": round(pack_s * 1e3, 1), "launches": _launches(kernels),
                 "table_bytes": _table_bytes(dev),
                 **{k[:-2] + "_ms": round(v * 1e3, 1) for k, v in passes.items()}}
        if device.type == "cuda":
            extra["peak_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
        metrics.frame(frame_index, setup_s, dt, n_samples, config.max_bounces, **extra)

        if image is not None:
            write_bmp(out_path, image)
    pool.shutdown()
    metrics.close()
    print(
        f"\n\nEXECUTION TIME OF PROGRAM FOR {end-begin} FRAMES: "
        f"{(time.perf_counter()-total_t0)*1e3:.0f}ms"
    )


def merge_partials(args):
    """Merge frame_NNNN.part_A_B.npz partial sums into tonemapped BMPs.

    The sample-range seeding contract makes partials order-independent and
    machine-independent; overlapping or missing ranges are reported. The
    tonemap runs on ``args.device`` (None: CUDA), as a frame's does.
    """
    import glob
    import re

    from pathtracing_tpu_torch.io.bmp import write_bmp
    from pathtracing_tpu_torch.render import to_bgra
    from pathtracing_tpu_torch.utils.platform import ensure_backend

    device = ensure_backend(getattr(args, "device", None))
    pattern = re.compile(r"frame_(\d{4})\.part_(\d+)_(\d+)\.npz$")
    frames: dict = {}
    for path in sorted(glob.glob(os.path.join(args.out, "frame_*.part_*.npz"))):
        m = pattern.search(path)
        if not m:
            continue
        frames.setdefault(int(m.group(1)), []).append(
            (int(m.group(2)), int(m.group(3)), path)
        )

    if not frames:
        print(f"no partials found in {args.out}")
        return 1

    for frame_index, parts in sorted(frames.items()):
        parts.sort()
        covered = []
        total = None
        n_samples = 0
        for a, b, path in parts:
            data = np.load(path)
            sums = data["sums"]
            total = sums if total is None else total + sums
            n_samples += b - a
            covered.append((a, b))
        # coverage check
        merged_ok = True
        pos = covered[0][0]
        for a, b in covered:
            if a != pos:
                merged_ok = False
            pos = b
        if not merged_ok:
            print(f"FRAME #{frame_index}: WARNING ranges {covered} have gaps/overlap")
        colors = total / np.float32(n_samples)
        image = to_bgra(colors, device=device)
        out_path = os.path.join(args.out, f"frame_{frame_index:04d}.bmp")
        write_bmp(out_path, image)
        print(f"FRAME #{frame_index}: merged {n_samples} spp from {len(parts)} partials -> {out_path}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
