"""Tiled frame rendering.

The reference's ``baseline_render`` is a flat OpenMP loop over pixels with a
serial sample loop per pixel (reference: main.cc:12-46). Here a frame is a
list of flat pixel tiles; each tile renders as a batch of ``tile_pixels``
lanes with samples accumulated by a Python loop over sample indices.

Entry points take ``device=None``, which means CUDA and raises when there is
no card; the scene's tensors must lie on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.tonemap import tonemap
from pathtracing_tpu_torch.utils.vec import Vec3

# Lanes per tile on a CUDA device. A sample is ~20,000 small eager kernels
# whatever the tile size, and the host enqueues them at ~10 us each: at 2^20
# lanes the card idles roughly half the time, at a whole 1920x1080 frame per
# tile a fifth or less (PERF.md, Findings). So a tile is as large as memory allows:
# 2^21 lanes takes a 1080p frame whole. Eager PyTorch keeps a bounce's
# temporaries alive as full-width tensors and the merged ray query runs
# 2 x tile lanes, so the tile size also sets peak device memory (PERF.md has
# the figure taken on the card). One constant stands where the JAX package
# looks a tile size up per platform and scene size.
CUDA_TILE_PIXELS = 1 << 21
# On the CPU the optimum is cache-bound.
CPU_TILE_PIXELS = 1 << 15


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


def default_tile_pixels(device) -> int:
    """Tile size for a device type."""
    return CUDA_TILE_PIXELS if torch.device(device).type == "cuda" else CPU_TILE_PIXELS


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
        txs = torch.from_numpy(np.ascontiguousarray(xs[start:end], np.int32)).to(device)
        tys = torch.from_numpy(np.ascontiguousarray(ys[start:end], np.int32)).to(device)
        pending.append((start, end, kernel(txs, tys)))
    for start, end, res in pending:
        for k in range(n_channels):
            out[k][start:end] = res[k].cpu().numpy()
    return out


def to_bgra(colors: np.ndarray, device=None) -> np.ndarray:
    """Tonemap (H, W, 3) radiance to the reference's uchar BGRA layout
    (reference: path_tracer.hh:753-771, main.cc:42-46)."""
    device = resolve_device(device)
    c = torch.from_numpy(np.ascontiguousarray(colors, np.float32)).to(device)
    b, g, r, a = tonemap(Vec3(c[..., 0], c[..., 1], c[..., 2]))
    return torch.stack([b, g, r, a], dim=-1).cpu().numpy()


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
    tile_pixels=None resolves per device type. ``device=None`` means CUDA.
    The JAX package's other renderers are later slices of the port:
    wavefront=True (path regeneration, ops/wavefront.py) and megakernel=True
    (persistent lanes, ops/megakernel.py) raise NotImplementedError;
    megakernel=None selects the scan integrator, the only one here.
    """
    if wavefront:
        raise NotImplementedError(
            "wavefront=True: the path-regeneration renderer is a later slice "
            "of the port (ops/wavefront.py)"
        )
    if megakernel:
        raise NotImplementedError(
            "megakernel=True: the persistent-lane renderer is a later slice "
            "of the port (ops/megakernel.py)"
        )
    device = resolve_device(device)
    if scene.nl8.device != device:
        raise ValueError(
            f"scene is on {scene.nl8.device}, render asked for {device}"
        )
    spp = spp or config.samples_per_pixel
    if tile_pixels is None:
        tile_pixels = default_tile_pixels(device)
    kernel = lambda txs, tys: _render_tile(
        config, scene, txs, tys, spp, int(sample_base)
    )
    r, g, b = run_tiled(kernel, xs, ys, tile_pixels, 3, device)
    out = np.stack([r, g, b], -1)
    if average:
        return out / np.float32(spp)
    return out


def render_frame(
    config: RenderConfig,
    scene,
    spp: int | None = None,
    tile_pixels: int | None = None,
    wavefront: bool = False,
    device=None,
):
    """Render a full frame; returns (colors (H,W,3) f32, image (H,W,4) u8 BGRA)."""
    device = resolve_device(device)
    W, H = config.image_width, config.image_height
    idx = np.arange(W * H, dtype=np.int32)
    xs = idx % W
    ys = idx // W
    colors = render_pixels(
        config, scene, xs, ys, spp, tile_pixels, wavefront=wavefront,
        device=device,
    ).reshape(H, W, 3)
    return colors, to_bgra(colors, device)
