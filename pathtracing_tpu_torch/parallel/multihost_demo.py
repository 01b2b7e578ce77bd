"""Multi-process demo of parallel/multihost.py: N processes on this machine,
each a "host", run the frame loop the way a cluster would run it.

1. ``initialize_distributed`` against a ``tcp://127.0.0.1:<port>``
   coordinator (``torch.distributed``, ``gloo``),
2. an ``all_reduce`` of one per process, which must sum to N (the
   collective sanity check),
3. ``frames_for_host`` round-robin frame assignment,
4. each host renders its frames of the golden scene over its devices
   (``render_frames_distributed``: ``render_frame_sharded`` on
   ``local_device_mesh``, then the tonemap and the BMP).

Then this process renders the same frames alone into ``<out>/single``, and
every frame file of the N hosts must be byte-identical to its.

    python -m pathtracing_tpu_torch.parallel.multihost_demo [--processes 2]
        [--frames 4] [--size 64x36] [--spp 2] [--device cuda|cpu] [--out DIR]

Each host prints a JSON line with its frames, seconds and kernel launches
(none on the CPU); the last line is the result's. Exits 0 when every check
held.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "tests" / "golden" / "scene.gold"


def render_host_frames(args, out: str) -> dict:
    """This process's frames (``frames_for_host``: all of them outside a
    process group) of the golden scene into ``out``; returns its JSON
    line's fields."""
    import torch

    from pathtracing_tpu_torch.config import TESTING
    from pathtracing_tpu_torch.ops import cuda_traversal, cuda_wavefront
    from pathtracing_tpu_torch.parallel.multihost import (
        frames_for_host,
        render_frames_distributed,
    )
    from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
    from pathtracing_tpu_torch.utils.goldenio import load_golden

    if args.device == "cpu":
        # the hosts share this machine's cores: one intra-op thread each, so
        # that N processes do not oversubscribe them
        torch.set_num_threads(1)
    w, h = (int(v) for v in args.size.split("x"))
    config = dataclasses.replace(TESTING, image_width=w, image_height=h,
                                 samples_per_pixel=args.spp)
    scene = scene_device_from_golden(load_golden(str(args.golden)), config,
                                     device="cpu" if args.device == "cpu" else None)
    kernels = {"ray_query": cuda_traversal, "wavefront": cuda_wavefront}
    for mod in kernels.values():
        mod.reset_launches()
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    render_frames_distributed(config, lambda f: scene, 0, args.frames, out,
                              device_type=args.device)
    return {"frames": frames_for_host(0, args.frames), "seconds": time.perf_counter() - t0,
            "launches": {k: mod.launches for k, mod in kernels.items()}}


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    from pathtracing_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(args.coordinator, args.processes, args.process_id)
    try:
        total = torch.ones(1)
        dist.all_reduce(total)
        if int(total[0]) != args.processes:
            print(f"[host {args.process_id}] all_reduce gave {total.item()}", flush=True)
            return 1
        print(json.dumps({"host": args.process_id, **render_host_frames(args, args.out)}),
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_hosts(args, out: str) -> list[int]:
    """Run ``args.processes`` worker processes into ``out``; returns their
    exit codes (a worker past the timeout is killed and counts -9). No
    worker outlives the call."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    procs = []
    try:
        for pid in range(args.processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pathtracing_tpu_torch.parallel.multihost_demo",
                 "--worker", "--coordinator", coordinator, "--processes", str(args.processes),
                 "--process-id", str(pid), "--frames", str(args.frames), "--size", args.size,
                 "--spp", str(args.spp), "--device", args.device, "--golden", str(args.golden),
                 "--out", out],
                env=env, cwd=str(ROOT),
            ))
        deadline = time.monotonic() + args.timeout
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", default="64x36")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--golden", default=str(GOLDEN))
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=int, default=600)
    # worker-mode internals
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    if args.worker:
        return worker(args)

    out = args.out or tempfile.mkdtemp(prefix="multihost_")
    t0 = time.perf_counter()
    rcs = run_hosts(args, out)
    hosts_s = time.perf_counter() - t0
    # the reference: this process alone, outside any process group
    single = os.path.join(out, "single")
    print(json.dumps({"host": "single", **render_host_frames(args, single)}), flush=True)
    names = [f"frame_{f:04d}.bmp" for f in range(args.frames)]
    read = lambda d, n: (pathlib.Path(d, n).read_bytes() if pathlib.Path(d, n).exists()
                         else None)
    missing = [n for n in names if read(out, n) is None]
    differ = [n for n in names if read(out, n) != read(single, n)]
    ok = not any(rcs) and not missing and not differ
    print(json.dumps({"ok": ok, "processes": args.processes, "frames": args.frames,
                      "size": args.size, "spp": args.spp, "device": args.device,
                      "exit_codes": rcs,
                      "missing": missing, "differ_from_single": differ,
                      "hosts_seconds": hosts_s, "out": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
