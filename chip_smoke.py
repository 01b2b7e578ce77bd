#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``pathtracing_tpu_torch``).

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Drives the port's main path — golden scene -> pack -> ``render_frame``
(every ray query served by the hand-written CUDA kernel) -> BGRA -> BMP — at
the PRODUCTION preset's geometry (1920x1080, 5 bounces) with spp cut from
1024 to 8 (one motion-blur step), and holds the kernel against its plain
PyTorch version and against the C++ oracle's goldens on the way. Phases, one
JSON object per line:

  device        card name + power limit (nvidia-smi), torch / CUDA versions
  build         seconds to build csrc/ at first use, ptxas' register report
  kernel_check  ray_query kernel vs plain version: the 4096 rays of
                rays.gold in five modes, and the two batches the main path
                gives it (primary: one tile of camera rays; bounce: 2 x tile
                shadow+bounce rays with a per-lane any-hit mask and inactive
                lanes). ids equal, thit/u/v within rtol=1e-6, atol=1e-6;
                vs the oracle columns at tests/test_traversal.py's bars.
                Kernel / plain times, the plain version's row-read counts
                and the bound.
  breakdown     one tile x one sample: time inside the kernel vs the rest
  oracle_frame  TESTING preset 640x360, spp 8, 4 bounces vs render8.gold
  main_path     the frame above; finite radiance, launch count, BMP written
  kernels       the per-kernel summary line
and last ``{"ok": true, "device": {...}}``. Any failed phase raises: the
script exits non-zero and prints no result line. There is no CPU fallback:
without a CUDA device it exits 2 at once. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

from pathtracing_tpu_torch.config import PRODUCTION, TESTING
from pathtracing_tpu_torch.io.bmp import read_bmp, write_bmp
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.ops import integrator
from pathtracing_tpu_torch.ops.tonemap import tonemap
from pathtracing_tpu_torch.ops.traversal import ray_query, ray_query_plain
from pathtracing_tpu_torch.render import CUDA_TILE_PIXELS, render_frame
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.utils.goldenio import load_golden
from pathtracing_tpu_torch.utils.vec import Vec3

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
MAIN_SPP = 8  # PRODUCTION asks for 1024; cut so the run fits its time limit

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Row bytes of the tables, and flops per visit (counted from the source:
# slab test 27, triangle test 52, BLAS entry 45).
NODE_ROW_B, TRI_ROW_B, INST_ROW_B = 32, 48, 84 + 24
NODE_FLOPS, TRI_FLOPS, INST_FLOPS = 27, 52, 45

RTOL = ATOL = 1e-6  # kernel vs plain version: same ops, same order, no FMA


def require(cond, what) -> None:
    """A check that survives ``python -O``."""
    if not cond:
        raise AssertionError(str(what))


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ----------------------------------------------------------------- comparing


def compare_hits(tag, hk, ok, hp, op):
    """Kernel result vs plain version's: ids equal, floats within RTOL/ATOL.
    Returns the max abs error over thit/u/v; raises with the counts if not."""
    bad = {
        "occluded": int((ok != op).sum()),
        "inst": int((hk.inst != hp.inst).sum()),
        "prim": int((hk.prim != hp.prim).sum()),
        "back": int((hk.back != hp.back).sum()),
    }
    err = 0.0
    for name in ("thit", "bary_u", "bary_v"):
        a, b = getattr(hk, name), getattr(hp, name)
        close = torch.isclose(a, b, rtol=RTOL, atol=ATOL)
        bad[name] = int((~close).sum())
        err = max(err, float((a - b).abs().max()))
    if any(bad.values()):
        raise AssertionError(f"{tag}: kernel disagrees with plain version: {bad}")
    return err


def check_oracle(rays_g, hit, occluded_anyhit):
    """tests/test_traversal.py's bars against the oracle columns."""
    thit = hit.thit.cpu().numpy()
    miss_ref = rays_g["thit"] < 0
    np.testing.assert_array_equal(thit < 0, miss_ref)
    h = ~miss_ref
    np.testing.assert_allclose(thit[h], rays_g["thit"][h], rtol=2e-5, atol=1e-5)
    same = (hit.inst.cpu().numpy() == rays_g["inst"].view(np.int32)) & (
        hit.prim.cpu().numpy() == rays_g["prim"].view(np.int32)
    )
    diff = h & ~same
    require(diff.mean() <= 0.002, f"{diff.sum()} id mismatches vs oracle")
    exact = h & same
    np.testing.assert_array_equal(
        hit.back.cpu().numpy()[exact].astype(np.uint32), rays_g["back"][exact]
    )
    for k, col in (("bary_u", 0), ("bary_v", 1)):
        np.testing.assert_allclose(
            getattr(hit, k).cpu().numpy()[exact], rays_g["bary"][exact, col],
            rtol=2e-5, atol=2e-6,
        )
    np.testing.assert_array_equal(
        occluded_anyhit.cpu().numpy().astype(np.uint32), rays_g["occluded"]
    )
    return int(diff.sum())


# -------------------------------------------------------------------- timing


def time_kernel(args, kwargs, reps=5):
    """Median ms of one launch, L2 flushed before each (between two queries
    of a frame the shading pass streams far more than the 50 MB L2)."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    ray_query(*args, **kwargs)  # warm-up
    ms = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ray_query(*args, **kwargs)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms)), ms


def ray_io_bytes(anyhit, tmax0, rays: int, active: int) -> int:
    """Bytes the function must move for this batch's rays: every lane's
    ``active`` byte in and its seven outputs out; the ray itself only for an
    active lane (an inactive lane's result does not depend on it)."""
    every = 1 + 3 * 4 + 2 * 4 + 2  # active; thit,u,v + inst,prim + back,occluded
    ray = 4 + 4 + 24  # tlas_count, tlas_offset, org+dir
    ray += 1 if isinstance(anyhit, torch.Tensor) else 0
    ray += 4 if isinstance(tmax0, torch.Tensor) and tmax0.dim() else 0
    return rays * every + active * ray


def measure_shape(tag, args, kwargs):
    """One main-path batch: kernel vs plain, times, counts, bound."""
    R = args[3].x.shape[0]
    hk, ok = ray_query(*args, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # this batch's row reads, counted by the plain version as it walks
    hp, op, (node, inst, tri) = ray_query_plain(*args, **kwargs, return_counts=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_hits(tag, hk, ok, hp, op)

    ms, all_ms = time_kernel(args, kwargs)

    # The bound: each input read once and each output written once at the
    # card's memory rate, against this batch's flops (from the counted row
    # visits) at its float32 rate. The row reads the walk makes are many
    # times the tables' size, but the tables sit in L2, so re-reads are not
    # traffic the card must pay for; their cost at device-memory rate is
    # reported beside the bound, not as the bound.
    n_active = int(args[7].sum())
    io_b = ray_io_bytes(kwargs.get("anyhit", False), args[6], R, n_active)
    row_b = node * NODE_ROW_B + tri * TRI_ROW_B + inst * INST_ROW_B
    flops = node * NODE_FLOPS + tri * TRI_FLOPS + inst * INST_FLOPS
    bound_bytes_ms = (CT.table_bytes(args[0]) + io_b) / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    return {
        "shape": tag, "rays": R, "active": n_active, "io_bytes": io_b,
        "max_abs_err": err, "ms": ms, "ms_all": all_ms, "plain_ms": plain_ms,
        "node_rows": node, "inst_rows": inst, "tri_rows": tri,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_ops_ms,
        "row_reads_at_hbm_rate_ms": (row_b + io_b) / HBM_BYTES_PER_S * 1e3,
        "roofline_share": bound_ms / ms,
    }


def main_path_tile_lanes(cfg) -> int:
    """Lanes of the first (largest) tile of the main path's frame."""
    return min(CUDA_TILE_PIXELS, cfg.image_width * cfg.image_height)


def capture_main_path_queries(cfg, scene, n):
    """The arguments ``path_trace_samples`` hands to ``ray_query`` for one
    tile of n pixels of the frame: [primary, bounce 1, ...]."""
    calls = []
    orig = integrator.ray_query

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    xs, ys = idx % cfg.image_width, idx // cfg.image_width
    integrator.ray_query = spy
    try:
        integrator.path_trace_samples(cfg, scene, xs, ys, torch.zeros_like(xs))
    finally:
        integrator.ray_query = orig
    torch.cuda.synchronize()
    return calls


# -------------------------------------------------------------------- phases


def phase_kernel_check(scene_g, rays_g, scene, prod_cfg, prod_scene):
    dev = scene.nl8.device
    R = 4096
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32, device=dev)
    tlc, tlo = full(scene_g["tlas"][0]), full(scene_g["tlas"][1])
    col = lambda a, i: torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev)
    org = Vec3(*(col(rays_g["origins"], i) for i in range(3)))
    d = Vec3(*(col(rays_g["dirs"], i) for i in range(3)))
    on = torch.ones(R, dtype=torch.bool, device=dev)
    rs = np.random.default_rng(7)
    mask = torch.from_numpy(rs.random(R) < 0.5).to(dev)
    some = torch.from_numpy(rs.random(R) < 0.7).to(dev)
    tmax_lane = torch.from_numpy(
        rs.uniform(0.5, 40.0, R).astype(np.float32)
    ).to(dev)

    def both(tag, n, tmin, tmax0, active, anyhit):
        cut = lambda t: t[:n].contiguous() if isinstance(t, torch.Tensor) and t.dim() else t
        a = (scene, cut(tlc), cut(tlo), Vec3(*map(cut, org)), Vec3(*map(cut, d)),
             tmin, cut(tmax0), cut(active))
        hk, ok = ray_query(*a, anyhit=cut(anyhit))
        torch.cuda.synchronize()
        hp, op = ray_query_plain(*a, anyhit=cut(anyhit))
        return compare_hits(tag, hk, ok, hp, op), hk, ok

    errs = {}
    errs["closest"], hit_c, _ = both("closest", R, 0.0, 1e9, on, False)
    errs["anyhit"], _, occ_a = both("anyhit", R, 1e-4, 1e9, on, True)
    errs["mixed_mask"], _, _ = both("mixed_mask", R, 1e-4, 1e9, on, mask)
    errs["inactive_lanes"], hit_i, occ_i = both("inactive_lanes", R, 0.0, 1e9, some, mask)
    require(bool((hit_i.thit[~some] == -1).all()) and not bool(occ_i[~some].any()),
            "inactive lanes traced")
    # R not a multiple of the block, per-lane tmax0
    errs["ragged_tmax_lane"], _, _ = both(
        "ragged_tmax_lane", R - 37, 1e-4, tmax_lane, some, mask
    )
    require((R - 37) % CT.block_size() != 0, "ragged batch is a block multiple")
    id_ties = check_oracle(rays_g, hit_c, occ_a)
    emit("kernel_check", part="rays.gold", rays=R, modes=list(errs),
         max_abs_err=max(errs.values()), rtol=RTOL, atol=ATOL,
         oracle_id_mismatches=id_ties, ids="equal")

    lanes = main_path_tile_lanes(prod_cfg)
    calls = capture_main_path_queries(prod_cfg, prod_scene, lanes)
    require(len(calls) == 1 + prod_cfg.max_bounces, f"{len(calls)} ray queries per sample")
    shapes = [
        measure_shape("primary", *calls[0]),
        measure_shape("bounce", *calls[1]),
    ]
    require(shapes[1]["rays"] == 2 * lanes, "bounce batch is not 2 x tile")
    require(shapes[1]["active"] < shapes[1]["rays"], "bounce batch holds no inactive lane")
    for s in shapes:
        emit("kernel_check", part="main_path_shape", **s)
    return max(max(errs.values()), *(s["max_abs_err"] for s in shapes)), shapes


def phase_breakdown(cfg, scene):
    """One tile, one sample: how much of its time is the kernel."""
    spans = []
    orig = integrator.ray_query

    def timed(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out

    lanes = main_path_tile_lanes(cfg)
    idx = torch.arange(lanes, dtype=torch.int32, device="cuda")
    xs, ys = idx % cfg.image_width, idx // cfg.image_width
    si = torch.zeros_like(xs)
    integrator.path_trace_samples(cfg, scene, xs, ys, si)  # warm-up
    torch.cuda.synchronize()
    integrator.ray_query = timed
    try:
        t0 = time.perf_counter()
        integrator.path_trace_samples(cfg, scene, xs, ys, si)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        integrator.ray_query = orig
    per_query = [a.elapsed_time(b) for a, b in spans]
    emit("breakdown", lanes=lanes, samples=1,
         sample_wall_ms=wall_ms, ray_query_ms=per_query,
         ray_query_ms_total=sum(per_query),
         ray_query_share=sum(per_query) / wall_ms)


def phase_oracle_frame(scene):
    rg = load_golden(str(GOLDEN / "render8.gold"))
    ref = rg["colors"]
    t0 = time.perf_counter()
    colors, _ = render_frame(TESTING, scene, spp=8)
    sec = time.perf_counter() - t0
    require(colors.shape == ref.shape and np.isfinite(colors).all(), "oracle frame shape/finite")
    rel = np.abs(colors - ref) / (np.abs(ref) + 1e-3)
    q98 = float(np.quantile(rel, 0.98))

    def tm(c):
        t = torch.from_numpy(np.ascontiguousarray(c.reshape(-1, 3))).cuda()
        b, g, r, _ = tonemap(Vec3(t[:, 0], t[:, 1], t[:, 2]))
        return torch.stack([b, g, r], -1).cpu().numpy().astype(np.float64)

    mse = ((tm(colors) - tm(ref)) ** 2).mean()
    psnr = float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
    emit("oracle_frame", width=640, height=360, spp=8, bounces=TESTING.max_bounces,
         rel_q98=q98, rel_q98_bar=1e-3, psnr_db=psnr, psnr_bar_db=35.0, seconds=sec)
    require(q98 < 1e-3, f"oracle frame rel q98 {q98}")
    require(psnr > 35.0, f"oracle frame PSNR {psnr}")
    return float(np.minimum(ref, 10.0).mean())


def phase_main_path(cfg, scene, oracle_mean):
    W, H = cfg.image_width, cfg.image_height
    tiles = -(-W * H // CUDA_TILE_PIXELS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CT.reset_launches()
    t0 = time.perf_counter()
    colors, image = render_frame(cfg, scene, spp=MAIN_SPP)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = CT.launches
    peak = torch.cuda.max_memory_allocated()

    expected = tiles * MAIN_SPP * (1 + cfg.max_bounces)
    require(colors.shape == (H, W, 3) and image.shape == (H, W, 4), "frame shape")
    require(image.dtype == np.uint8, "image dtype")
    require(np.isfinite(colors).all(), "non-finite radiance")
    require(launches == expected, f"{launches} kernel launches, expected {expected}")
    # same scene and camera as the oracle's 640x360 frame: the mean radiance
    # (fireflies clipped) must agree, whatever the resolution
    mean_ratio = float(np.minimum(colors, 10.0).mean()) / oracle_mean
    require(0.9 < mean_ratio < 1.1, f"mean radiance vs oracle frame: {mean_ratio}")

    out = ROOT / "output"
    out.mkdir(exist_ok=True)
    bmp = out / "chip_smoke_frame.bmp"
    write_bmp(str(bmp), image)
    back = read_bmp(str(bmp))
    require(np.array_equal(back[..., ::-1], image[..., :3]), "BMP round trip")
    emit("main_path", width=W, height=H, bounces=cfg.max_bounces, spp=MAIN_SPP,
         spp_reduced_from=PRODUCTION.samples_per_pixel, tiles=tiles,
         tile_pixels=CUDA_TILE_PIXELS, launches=launches,
         launches_expected=expected, seconds=sec,
         msamples_per_s=W * H * MAIN_SPP / sec / 1e6,
         peak_memory_allocated_bytes=int(peak), mean_vs_oracle=mean_ratio,
         bmp=str(bmp.relative_to(ROOT)), bmp_bytes=bmp.stat().st_size)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, torch=torch.__version__,
         cuda=torch.version.cuda, numpy=np.__version__,
         python=sys.version.split()[0])

    CT.build(verbose=True)
    log = (CT.BUILD_DIR / "build.log").read_text()
    emit("build", seconds=CT.build_seconds, source=str(CT.SOURCE.relative_to(ROOT)),
         flags=list(CT.NVCC_FLAGS),
         registers=[int(x) for x in re.findall(r"Used (\d+) registers", log)],
         spill_bytes=[int(x) for x in re.findall(r"(\d+) bytes spill stores", log)])

    scene_g = load_golden(str(GOLDEN / "scene.gold"))
    rays_g = load_golden(str(GOLDEN / "rays.gold"))
    scene = scene_device_from_golden(scene_g, TESTING)
    # PRODUCTION geometry with spp cut to MAIN_SPP; the scene is built with
    # the config it is rendered with (one subframe row per motion-blur step)
    prod_cfg = dataclasses.replace(PRODUCTION, samples_per_pixel=MAIN_SPP)
    prod_scene = scene_device_from_golden(scene_g, prod_cfg)
    emit("scene", table_bytes=CT.table_bytes(scene),
         nl8_rows=scene.nl8.shape[0], triangles=scene.tri_pos.shape[0],
         instances=scene.inst_f.shape[0])

    max_err, shapes = phase_kernel_check(scene_g, rays_g, scene, prod_cfg, prod_scene)
    phase_breakdown(prod_cfg, prod_scene)
    oracle_mean = phase_oracle_frame(scene)
    launches = phase_main_path(prod_cfg, prod_scene, oracle_mean)

    emit("done", seconds=time.perf_counter() - t_start)
    bounce = shapes[1]  # the batch launched max_bounces times of 1+max_bounces
    print(json.dumps({"kernels": [{
        "name": "ray_query",
        "route": "cuda",
        "source": "pathtracing_tpu_torch/csrc/ray_query.cu",
        "replaces": "pathtracing_tpu/ops/pallas_traversal.py:64",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": bounce["ms"],
        "plain_ms": bounce["plain_ms"],
        "bound_ms": bounce["bound_ms"],
        "bound_by": bounce["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a BVH ray query
        "shape": f"bounce batch, {bounce['rays']} rays",
        "primary": {k: shapes[0][k] for k in
                    ("rays", "ms", "plain_ms", "bound_ms", "bound_by")},
        "card": smi,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
