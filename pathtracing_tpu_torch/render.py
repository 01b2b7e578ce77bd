"""Tiled frame rendering.

The reference's ``baseline_render`` is a flat OpenMP loop over pixels with a
serial sample loop per pixel (reference: main.cc:12-46). Here a frame is a
list of flat pixel tiles; each tile renders as a batch of ``tile_pixels``
lanes with samples accumulated by a Python loop over sample indices.

Entry points take ``device=None``, which means CUDA and raises when there is
no card; the scene's tensors must lie on that device.

On a CUDA device a row-major [0, N) pixel list on a scene with wide tables
renders through the megakernel (ops/megakernel.py, kernel K2), as the JAX
package picks its megakernel on a TPU; everything else, and every render on
the CPU, goes through the tiled scan of ``path_trace_samples``, unless the
caller asks for the wavefront renderer (``wavefront=True``: ops/wavefront.py,
kernel K5 on the card, any pixel list, binary or wide tables), which stays
opt-in as in the JAX package.

The two fused renderers (K2, K5) keep their sums on the device: each spp
chunk's sums are added into one device tensor, the average divides by a
device tensor (a true division: PyTorch's CUDA kernels divide by a Python
scalar as a multiply by its reciprocal, which is not the host's float32
division), and ``render_frame`` tonemaps on the device and copies the
colours and the BGRA image back once each.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel
from pathtracing_tpu_torch.ops.tonemap import tonemap
from pathtracing_tpu_torch.ops.wavefront import path_trace_wavefront
from pathtracing_tpu_torch.utils.vec import Vec3

def _render_tile(config: RenderConfig, scene, xs, ys, spp: int, sample_base=0):
    """Sum `spp` samples per lane starting at sample_base; returns (r,g,b).

    Sample ranges are independent given the (x, y, sample_index) seeding
    (reference: path_tracer.hh:659), so partial ranges rendered anywhere —
    another device, another host, another run — sum to the full result.
    """
    zero = lambda: torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
    r, g, b = zero(), zero(), zero()
    for sample_index in range(int(sample_base), int(sample_base) + spp):
        si = torch.full(xs.shape, sample_index, dtype=torch.int32, device=xs.device)
        c = path_trace_samples(config, scene, xs, ys, si)
        # in place: the three sums are the only state that outlives a sample
        r += c.x
        g += c.y
        b += c.z
    return r, g, b


def default_tile_pixels(scene, device=None) -> int:
    """Tile size from the tuning table (pathtracing_tpu_torch/tuning.py, its
    tuned file over its builtin rows), by device type (``device``, else the
    scene's) and by the scene's size class ("large" above
    ``LARGE_SCENE_NODES`` nl8 nodes), as the JAX package resolves it per
    platform. On a CUDA device a scan sample is ~20,000 small eager kernels
    whatever the tile size, so a tile is as large as memory allows (eager
    PyTorch keeps a bounce's temporaries alive as full-width tensors, and the
    merged ray query runs 2 x tile lanes, so the tile also sets peak device
    memory: PERF.md has the figure taken on the card); on the CPU the optimum
    is cache-bound."""
    from pathtracing_tpu_torch.tuning import get_tuning

    kind = torch.device(device).type if device is not None else scene.nl8.device.type
    large = (scene.nl8.shape[0] // 8) > LARGE_SCENE_NODES
    return int(get_tuning(kind, "large" if large else "small")["tile_pixels"])


def _tile(v, start: int, end: int, device) -> torch.Tensor:
    """Lanes [start, end) of a pixel coordinate list (numpy, or an int32
    tensor already on ``device``) as an int32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v[start:end]
    return torch.from_numpy(np.ascontiguousarray(v[start:end], np.int32)).to(device)


def run_tiled(kernel, xs, ys, tile_pixels: int, n_channels: int, device):
    """Run a per-lane function over a pixel list in tiles of at most
    ``tile_pixels`` lanes.

    kernel(txs, tys) -> tuple of n_channels (n,) tensors on ``device``. The
    last tile is simply shorter: eager PyTorch has no compiled shape to keep
    fixed, so nothing is padded. Every tile is enqueued before any result is
    copied back (the copy is the only point that waits for the device).
    Returns a list of n_channels (N,) float32 numpy arrays.
    """
    n = len(xs)
    out = [np.empty(n, np.float32) for _ in range(n_channels)]
    pending = []
    for start in range(0, n, tile_pixels):
        end = min(start + tile_pixels, n)
        pending.append((start, end, kernel(_tile(xs, start, end, device),
                                           _tile(ys, start, end, device))))
    for start, end, res in pending:
        for k in range(n_channels):
            out[k][start:end] = res[k].cpu().numpy()
    return out


def _bgra(c: torch.Tensor) -> torch.Tensor:
    """(..., 3) radiance tensor -> (..., 4) uint8 BGRA on its device."""
    b, g, r, a = tonemap(Vec3(c[..., 0], c[..., 1], c[..., 2]))
    return torch.stack([b, g, r, a], dim=-1)


def to_bgra(colors: np.ndarray, device=None) -> np.ndarray:
    """Tonemap (H, W, 3) radiance to the reference's uchar BGRA layout
    (reference: path_tracer.hh:753-771, main.cc:42-46)."""
    device = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(colors, np.float32)).to(device)
    return _bgra(c).cpu().numpy()


def _row_major(xs, ys, width: int) -> bool:
    """Whether (xs, ys) is pixels [0, N) of a row-major frame ``width``
    wide: the full rows compared against one row's x and a column of row
    numbers, and the last partial row, broadcast (no N-long index array)."""
    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    xs, ys = host(xs), host(ys)
    n = len(xs)
    if ys.shape != xs.shape or xs.ndim != 1:
        return False
    rows, rest = divmod(n, width)
    full = rows * width
    x_row = np.arange(width)
    return bool(
        (xs[:full].reshape(rows, width) == x_row).all()
        and (ys[:full].reshape(rows, width) == np.arange(rows)[:, None]).all()
        and (xs[full:] == x_row[:rest]).all()
        and (ys[full:] == rows).all()
    )


def megakernel_supported(scene, xs, ys, width: int) -> bool:
    """The megakernel owns pixels [0, N) of a row-major frame and needs the
    wide tables (the JAX package's rule; area-light scenes pass it, as
    there)."""
    return getattr(scene, "wide_rows", None) is not None and _row_major(xs, ys, width)


# Megakernel dispatch budgets, the JAX package's (its render.py):
# an accumulator-memory budget (PT_MK_ACC_MB) and a cap on the samples one
# dispatch renders (PT_MK_DISPATCH_SAMPLES), smaller for large scenes. Here
# the accumulator is the kernel's per-pixel output, and the cap keeps one
# launch's device time bounded; partial sums add exactly (the sample-range
# seeding contract, reference: path_tracer.hh:659).
DEFAULT_MK_ACC_MB = 25600
DEFAULT_MK_DISPATCH_SAMPLES = 32 << 20
DEFAULT_MK_DISPATCH_SAMPLES_LARGE = 4 << 20
# nl8 nodes above which a scene counts as large (the JAX package's
# ops/traversal.LARGE_SCENE_NODES)
LARGE_SCENE_NODES = 100_000


def _mk_spp_chunk(
    n_pixels: int, spp: int, scene=None, bytes_per_pixel: int = 12
) -> int:
    """Largest per-dispatch spp within the memory and dispatch budgets;
    prefers a divisor of spp so every dispatch renders the same count.
    ``bytes_per_pixel``: 12 for the three radiance planes, 16 with the
    luminance-squared plane."""
    default_cap = DEFAULT_MK_DISPATCH_SAMPLES
    if scene is not None and (scene.nl8.shape[0] // 8) > LARGE_SCENE_NODES:
        default_cap = DEFAULT_MK_DISPATCH_SAMPLES_LARGE
    budget = int(os.environ.get("PT_MK_ACC_MB", DEFAULT_MK_ACC_MB)) << 20
    cap = int(os.environ.get("PT_MK_DISPATCH_SAMPLES", default_cap))
    limit = max(
        1, min(budget // (n_pixels * bytes_per_pixel), cap // n_pixels)
    )
    if spp <= limit:
        return spp
    for c in range(limit, 0, -1):
        if spp % c == 0:
            return c
    return limit


def _render_fused(config, scene, xs, ys, spp: int, sample_base: int, device,
                  wavefront: bool, tile_pixels: int) -> torch.Tensor:
    """Raw (N, 3) sums on ``device`` by a fused renderer: the megakernel
    over pixels [0, N) (row-major, so xs / ys are not read), or the wavefront
    over run_tiled's tiles of the list (numpy, or int32 tensors on the
    device). Each tile takes one call per spp chunk (``_mk_spp_chunk``), and
    each chunk's sums are added into the one device tensor in chunk order:
    the host waits once, at the end, where it also learns whether the step
    cap abandoned samples (then it raises: the output would be darkened)."""
    n = len(xs)
    base = int(sample_base)
    out = torch.zeros((n, 3), dtype=torch.float32, device=device)
    if wavefront:
        spans = [(a, min(a + tile_pixels, n)) for a in range(0, n, tile_pixels)]
    else:
        spans = [(0, n)] if n else []
    truncated = []  # (first sample, samples, one-element count tensor)
    for start, end in spans:
        if wavefront:
            txs, tys = _tile(xs, start, end, device), _tile(ys, start, end, device)
        chunk = _mk_spp_chunk(end - start, spp, scene)
        for a in range(0, spp, chunk):
            c = min(chunk, spp - a)
            if wavefront:
                acc, n_trunc = path_trace_wavefront(
                    config, scene, txs, tys, c, base + a, return_truncated=True,
                    device=device,
                )
            else:
                acc, n_trunc = path_trace_megakernel(
                    config, scene, n, c, base + a, return_truncated=True, device=device,
                )
            for k, plane in enumerate(acc):
                out[start:end, k].add_(plane)
            truncated.append((base + a, c, n_trunc))
    if truncated:
        counts = torch.cat([t for *_, t in truncated]).tolist()
        for (first, c, _), k in zip(truncated, counts):
            if k:
                kind = "wavefront" if wavefront else "megakernel"
                raise RuntimeError(
                    f"{kind} step cap abandoned {k} samples (samples [{first}, "
                    f"{first + c})): output would be darkened"
                )
    return out


def _average(out: torch.Tensor, spp: int) -> torch.Tensor:
    """out / spp as the host's float32 division computes it: a tensor
    divided by a tensor on its device is a true division on either device
    (PyTorch's CUDA kernels divide by a Python scalar as a multiply by its
    reciprocal)."""
    return out / torch.full((1,), spp, dtype=out.dtype, device=out.device)


def _render(
    config: RenderConfig,
    scene,
    xs,
    ys,
    spp,
    tile_pixels,
    sample_base,
    average: bool,
    wavefront: bool,
    megakernel,
    device,
    row_major: bool = False,
) -> torch.Tensor:
    """render_pixels on the device: (N, 3) f32 on ``device``. ``row_major``:
    the caller built the list as pixels [0, N) of the frame (else it is
    checked where it matters)."""
    if scene.nl8.device != device:
        raise ValueError(
            f"scene is on {scene.nl8.device}, render asked for {device}"
        )
    spp = spp or config.samples_per_pixel
    if tile_pixels is None:
        tile_pixels = default_tile_pixels(scene, device)

    def supported():
        if row_major:  # the caller built the list: only the tables decide
            return getattr(scene, "wide_rows", None) is not None
        return megakernel_supported(scene, xs, ys, config.image_width)

    if wavefront:
        if megakernel:
            raise ValueError("wavefront=True and megakernel=True: pick one renderer")
        megakernel = False
    elif megakernel is None:
        megakernel = device.type == "cuda" and supported()
    elif megakernel and not supported():
        raise ValueError(
            "megakernel needs wide tables and a row-major [0, N) pixel list"
        )
    if megakernel or wavefront:
        out = _render_fused(config, scene, xs, ys, spp, sample_base, device,
                            wavefront, tile_pixels)
    else:
        kernel = lambda txs, tys: _render_tile(
            config, scene, txs, tys, spp, int(sample_base)
        )
        r, g, b = run_tiled(kernel, xs, ys, tile_pixels, 3, device)
        out = torch.from_numpy(np.stack([r, g, b], -1)).to(device)
    return _average(out, spp) if average else out


def render_pixels(
    config: RenderConfig,
    scene,
    xs: np.ndarray,
    ys: np.ndarray,
    spp: int | None = None,
    tile_pixels: int | None = None,
    sample_base: int = 0,
    average: bool = True,
    wavefront: bool = False,
    megakernel: bool | None = None,
    device=None,
):
    """Radiance for an arbitrary pixel list. Returns (N, 3) f32 (numpy).

    average=False returns raw sums over [sample_base, sample_base+spp) for
    sample-range checkpointing (partials merge by addition).
    megakernel=True renders through the megakernel (needs wide tables and a
    row-major [0, N) pixel list, else ValueError); None picks it on a CUDA
    device when ``megakernel_supported``, and the scan otherwise (always on
    the CPU, as the JAX package picks it on a TPU only); False pins the scan.
    wavefront=True renders through the wavefront renderer (ops/wavefront.py:
    kernel K5 on a CUDA device, its plain version on the CPU; any pixel list,
    binary or wide tables), in ``tile_pixels`` tiles; it is never picked on
    its own. tile_pixels=None takes ``default_tile_pixels`` (the tuning
    table's row for the device type and the scene's size). ``device=None``
    means CUDA.
    """
    device = resolve_device(device)
    return _render(
        config, scene, xs, ys, spp, tile_pixels, sample_base, average, wavefront,
        megakernel, device,
    ).cpu().numpy()


def render_frame(
    config: RenderConfig,
    scene,
    spp: int | None = None,
    tile_pixels: int | None = None,
    wavefront: bool = False,
    device=None,
):
    """Render a full frame; returns (colors (H,W,3) f32, image (H,W,4) u8 BGRA).

    On a CUDA device a scene with wide tables renders through the megakernel
    (``render_pixels``' auto-selection); ``wavefront=True`` renders through
    the wavefront renderer; ``render_pixels(..., megakernel=False)`` pins the
    scan. The colours are tonemapped on the device and each array is copied
    back once."""
    device = resolve_device(device)
    W, H = config.image_width, config.image_height
    # the row-major list, made on the device (the megakernel reads none of
    # it); ys takes the index's memory
    idx = torch.arange(W * H, dtype=torch.int32, device=device)
    xs = torch.remainder(idx, W)
    ys = idx.div_(W, rounding_mode="floor")
    colors = _render(
        config, scene, xs, ys, spp, tile_pixels, 0, True, wavefront, None, device,
        row_major=True,
    ).view(H, W, 3)
    return colors.cpu().numpy(), _bgra(colors).cpu().numpy()
