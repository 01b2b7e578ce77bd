"""Arbitrary output variables (AOVs): per-pixel albedo / normal / depth
buffers from the primary hit; the JAX package's ``aov.py``.

The reference has no AOV support (its only output is the beauty pass,
main.cc:42-46); this is a framework extension for denoising and debugging.
The AOV pass reuses the integrator's camera sampling
(ops/integrator.camera_sample: the same PCG4D stream, film jitter and
aperture draws, reference: path_tracer.hh:655-672), so the buffers are
pixel-aligned with the beauty pass, depth of field and motion-blur subframes
included. Its primary rays go through ``trace_ray``, so on the card the ray
query kernels (P1 on binary tables, K1 on wide ones) trace them.

Channels (all averaged over the sample range):
  albedo   (N, 3) primary-hit surface albedo; 0 where the ray misses
  normal   (N, 3) world-space shading normal (TBN row 2), renormalised; 0 on miss
  depth    (N,)   hit distance along the primary ray; mean over hitting samples
  coverage (N,)   fraction of samples whose primary ray hit geometry
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops.integrator import camera_sample, trace_ray
from pathtracing_tpu_torch.utils.vec import Vec3, where3

__all__ = ["aov_samples", "render_aovs"]


def aov_samples(config: RenderConfig, scene, xs, ys, sample_index):
    """One primary-hit AOV sample per lane.

    Returns (albedo Vec3, normal Vec3, depth, hit_mask) with miss lanes
    zeroed (depth 0 on a miss; combine with hit_mask for averages).
    """
    _, _, light, tlas_count, tlas_offset, ray_o, ray_dir = camera_sample(
        config, scene, xs, ys, sample_index
    )
    active = torch.ones_like(xs, dtype=torch.bool)
    info = trace_ray(
        scene, light, tlas_count, tlas_offset, ray_o, ray_dir, 0.0, active
    )
    hit = info.thit > 0
    zero = torch.zeros_like(info.thit)
    zero3 = Vec3(zero, zero, zero)
    albedo = where3(hit, info.albedo, zero3)
    normal = where3(hit, info.tbn.r2, zero3)  # TBN rows = {tangent, bitangent, normal}
    depth = torch.where(hit, info.thit, zero)
    return albedo, normal, depth, hit


def _aov_tile(config: RenderConfig, scene, xs, ys, spp: int):
    """The eight per-lane sums over samples [0, spp), kept on the device and
    added in sample order from 0 (the JAX package's ``lax.scan``)."""
    sums = [torch.zeros(xs.shape, dtype=torch.float32, device=xs.device) for _ in range(8)]
    for sample_index in range(spp):
        si = torch.full(xs.shape, sample_index, dtype=torch.int32, device=xs.device)
        alb, nrm, dep, hit = aov_samples(config, scene, xs, ys, si)
        for acc, v in zip(sums, (*alb, *nrm, dep, hit.to(torch.float32))):
            acc += v
    return sums


def render_aovs(
    config: RenderConfig,
    scene,
    xs: np.ndarray,
    ys: np.ndarray,
    spp: int = 8,
    tile_pixels: int | None = None,
    device=None,
):
    """AOV buffers for an arbitrary pixel list.

    Returns a dict of numpy arrays: albedo (N, 3), normal (N, 3)
    (renormalised mean), depth (N,) (mean over hitting samples; 0 where
    nothing hit), coverage (N,) in [0, 1]. ``device=None`` means CUDA.
    """
    from pathtracing_tpu_torch.render import default_tile_pixels, run_tiled

    device = resolve_device(device)
    if scene.nl8.device != device:
        raise ValueError(f"scene is on {scene.nl8.device}, AOVs asked for {device}")
    if tile_pixels is None:
        tile_pixels = default_tile_pixels(scene, device)
    xs = np.asarray(xs, np.int32)
    ys = np.asarray(ys, np.int32)
    kernel = lambda txs, tys: _aov_tile(config, scene, txs, tys, spp)
    ar, ag, ab, nx, ny, nz, d, h = run_tiled(kernel, xs, ys, tile_pixels, 8, device)
    inv_spp = np.float32(1.0 / spp)
    hits = np.maximum(h, 1.0)
    normal = np.stack([nx, ny, nz], -1)
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.maximum(norm, 1e-20)
    return {
        "albedo": np.stack([ar, ag, ab], -1) * inv_spp,
        "normal": normal.astype(np.float32),
        "depth": (d / hits).astype(np.float32),
        "coverage": (h * inv_spp).astype(np.float32),
    }
