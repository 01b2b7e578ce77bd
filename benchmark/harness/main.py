"""One run of one cell: set-up, a measured window, the output check, and
the result line.

    python3 benchmark/run.py --workload lumi_animation.film64 --seed 7 \
        --seconds 30 --trace 0

Set-up (``setup_s``, from the process's start to the window's) loads the
scene, packs its tables and renders one warm request of the cell's own
shapes. The window then drives the closed loop for ``--seconds``; every
request that starts before then runs to its end. With ``--trace 1`` the
window runs under ``torch.profiler`` and the result carries the cell's
per-layer metrics in place of its end-to-end ones. After the window the
program's state is dropped and the plain reference checks the pixels the
seed picked. The last line of standard output is one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

from benchmark.harness import check as chk
from benchmark.harness import spec
from benchmark.harness import trace as tr
from benchmark.harness.loops import ClosedLoop
from benchmark.harness.spans import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracing_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``pathtracing_tpu_torch`` is not ``pathtracing_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def p95(values) -> float:
    """The 95th percentile of all values (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def data_dir(config: dict, bench_dir=spec.BENCH_DIR) -> str:
    """The folder of the configuration's input files, written once by its
    scene module into the benchmark's cache."""
    scene = spec.find_module("scenes", config["scene"], bench_dir)
    return scene.write_inputs(pathlib.Path(bench_dir) / ".cache" / "inputs" / config["scene"])


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    cell: spec.Cell
    done: list            # loops.Done, in order
    window: tuple         # (start, end) on the host's clock
    rec: Recorder
    trace: tr.Trace | None
    counts: dict          # the reference's path events on the checked pixels
    table_bytes: list     # per request: bytes of the scene's tables
    launches: int         # of the route's path kernel

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def samples(self) -> int:
        return sum(d.samples for d in self.done)


def _card(count: int) -> dict:
    """The card the run used, as the result's ``device`` names it, with its
    power limit beside it."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        out["power_limit"] = q.stdout.strip().splitlines()[0] if q.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = ""
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, system_factory=None) -> dict:
    """Set-up, window and check of ``cell``; returns the result object.
    ``system_factory(config, traffic, device, rec, data_dir)`` makes the
    system under test (default: the port, ``harness/system.System``)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if system_factory is None:
        from benchmark.harness.system import System as system_factory
    rec = Recorder(traced=traced)
    ddir = data_dir(cell.config, cell.bench_dir)
    system = system_factory(cell.config, cell.traffic, device, rec, ddir,
                            bench_dir=cell.bench_dir)
    system.load()
    loop = ClosedLoop(system, cell.traffic, seed, rec)
    loop.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    system.reset_launches()

    prof = None
    if traced:
        prof = tr.profile()
        prof.__enter__()
        with rec.span("window"):
            done, t0, t1 = loop.run(seconds)
            if cuda:
                torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    else:
        done, t0, t1 = loop.run(seconds)
    launches = system.launches()
    loop.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace = tr.reduce(prof) if prof is not None else None
    del prof
    system.close()
    del system, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # the output check, with the reference's path events for the roofline
    ref = chk.Reference(cell.config, ddir, torch.device(device), bench_dir=cell.bench_dir)
    counts = {}
    t_check = time.perf_counter()
    numbers, far = chk.check_window(ref, done, counts=counts)
    table_bytes = [ref.frame_bytes[d.req.frame] for d in done]
    if cuda:
        numbers["kernel_missing"] = int(launches == 0)
    checks = {k: {"value": v, "limit": cell.limits[k]["limit"]} for k, v in numbers.items()}
    correct = bool(done) and all(c["value"] <= c["limit"] for c in checks.values())

    run = Run(cell, done, (t0, t1), rec, trace, counts, table_bytes, launches)
    metrics = {}
    if not traced:
        names = {m["name"]: m for m in cell.end_to_end}
        values = {
            "setup_s": setup_s,
            "msamples_per_s": run.samples / run.window_s / 1e6,
            "frame_ms_p95": p95([d.latency for d in done]) * 1e3,
            "peak_alloc_gib": peak / 2**30,
        }
        for name, m in names.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = _card(cell.chips) if cuda else {"platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = int(peak)
    out = {"correct": correct, "attempted": len(done), "failed": 0,
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        main = [s[2] for s in trace.spans if s[0] == "window"][0]
        out["breakdown"] = {"device_ops": tr.top_device_ops(trace),
                            "idle_gaps": tr.idle_gaps(trace, main)}
    # seconds of the run's phases and the far channels, for the record
    out["phases"] = {"setup_s": setup_s, "window_s": t1 - t0,
                     "check_s": time.perf_counter() - t_check, "far": far}
    out["checks"] = checks
    return out


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if importlib.util.find_spec("pathtracing_tpu_torch") is None:
        print("benchmark: the program (pathtracing_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 3

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: the port must not load JAX or the "
              "JAX package", file=sys.stderr)
        return 4
    for line in out["phases"]["far"]:
        print(line, file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
