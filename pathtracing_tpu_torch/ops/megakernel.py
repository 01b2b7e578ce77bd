"""The megakernel renderer: whole sun-NEE paths in one kernel per call.

Counterpart of the JAX package's ``ops/megakernel.py``, where
``path_trace_megakernel`` is a persistent-lane XLA while-loop that keeps R
SIMD lanes busy with a service step and a cumsum work queue (TPU lanes step
together). Here ``path_trace_megakernel`` dispatches: CUDA tensors go to the
hand-written kernel K2 (ops/cuda_megakernel.py, csrc/megakernel.cu: one
thread per pixel slot, its samples in order), CPU tensors to
``path_trace_megakernel_plain`` below.

What is kept of the JAX contract: ``n_pixels``, ``spp``, ``sample_base``,
``pixel_base``, ``pixel_order`` (and ``morton_pixel_order``),
``with_stats`` (the luminance-squared plane) and ``return_truncated``. What is
not taken: ``lanes``, ``leaf_every``, ``service_div``, ``hot_k`` and
``return_periods`` schedule the SIMD loop, whose results the JAX package's
own tests prove invariant to them; a CUDA thread leaves its own loop, so
there is nothing for them to schedule (the decision ``ray_query`` and
``wide_ray_query`` record for their walks). ``record=True`` (the gradient
slice) and scenes with area-light tables (the area-light slice) raise
NotImplementedError.

The fold: per pixel, the samples are added in sample order, from 0, in both
versions, so the kernel's sums are deterministic and fold as the plain
version folds (the JAX loop folds in the order its lanes finish items).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.ops.wavefront import path_trace_wavefront_plain
from pathtracing_tpu_torch.utils.vec import Vec3


def _check_supported(scene, record: bool) -> None:
    if record:
        raise NotImplementedError(
            "path_trace_megakernel(record=True): the hit records of the fast "
            "gradients come with the gradient slice of the port"
        )
    if scene.lt_tris is not None:
        raise NotImplementedError(
            "area-light NEE comes with a later slice of the port"
        )
    if scene.wide_rows is None or scene.tri_shade is None:
        raise ValueError(
            "the megakernel walks the wide tables: pack the scene with wide=True"
        )


def _order_tensor(pixel_order, n_pixels: int, device):
    """``pixel_order`` as an int32 tensor on ``device`` after checking that it
    is a permutation of [0, n_pixels) (each slot owns one output pixel), or
    None."""
    if pixel_order is None:
        return None
    order = torch.as_tensor(np.asarray(pixel_order, np.int64)
                            if not isinstance(pixel_order, torch.Tensor) else pixel_order)
    if order.shape != (n_pixels,):
        raise ValueError(f"pixel_order: shape {tuple(order.shape)}, expected ({n_pixels},)")
    seen = torch.zeros(n_pixels, dtype=torch.bool, device=order.device)
    inside = bool(((order >= 0) & (order < n_pixels)).all())
    if inside:
        seen[order.long()] = True
    if not (inside and bool(seen.all())):
        raise ValueError(f"pixel_order is not a permutation of [0, {n_pixels})")
    return order.to(device=device, dtype=torch.int32).contiguous()


def path_trace_megakernel(
    config,
    scene,
    n_pixels: int,
    spp: int,
    sample_base: int = 0,
    pixel_base: int = 0,
    with_stats: bool = False,
    return_truncated: bool = False,
    pixel_order=None,
    record: bool = False,
    device=None,
):
    """Per-pixel radiance sums over samples [sample_base, sample_base + spp)
    for pixels [pixel_base, pixel_base + n_pixels) of a
    ``config.image_width``-wide row-major frame. Returns a Vec3 of (n_pixels,)
    sums; with ``with_stats`` also the (n_pixels,) sums of each sample's
    luminance squared; with ``return_truncated`` also a one-element int32
    tensor: the samples the kernel's step cap abandoned (0 for the plain
    version, which has no cap).

    pixel_order: optional permutation of [0, n_pixels) (numpy or tensor):
    slot i renders pixel pixel_base + pixel_order[i]. The output stays
    indexed by pixel, and the radiance does not change (seeds depend on
    (x, y, sample index) only); the order only changes which pixels a warp
    renders together.

    Needs the wide tables (``wide=True``). ``device=None`` means CUDA and
    raises when there is no card; the scene must lie on the device. On CUDA
    the kernel renders (or the call raises); on the CPU the plain version.
    """
    _check_supported(scene, record)
    device = resolve_device(device)
    if scene.wide_rows.device != device:
        raise ValueError(f"scene is on {scene.wide_rows.device}, render asked for {device}")
    order = _order_tensor(pixel_order, n_pixels, device)
    if device.type == "cuda":
        from pathtracing_tpu_torch.ops.cuda_megakernel import megakernel_cuda

        r, g, b, l2, n_truncated, _ = megakernel_cuda(
            config, scene, n_pixels, spp, sample_base, pixel_base, with_stats, order
        )
    else:
        r, g, b, l2 = path_trace_megakernel_plain(
            config, scene, n_pixels, spp, sample_base, pixel_base, with_stats, order
        )
        n_truncated = torch.zeros(1, dtype=torch.int32, device=device)
    out = (Vec3(r, g, b), l2) if with_stats else (Vec3(r, g, b),)
    if return_truncated:
        out = out + (n_truncated,)
    return out if len(out) > 1 else out[0]


def path_trace_megakernel_plain(
    config,
    scene,
    n_pixels: int,
    spp: int,
    sample_base: int = 0,
    pixel_base: int = 0,
    with_stats: bool = False,
    pixel_order=None,
):
    """The plain PyTorch version of the megakernel, on whatever device the
    scene lies: the wavefront's plain version (the sample-ordered sum of
    ``path_trace_samples``) over the slots' pixels, each slot's sums then put
    at its pixel.

    ``pixel_order``: None or an int32 permutation tensor on the scene's
    device. Returns (r, g, b, l2 or None), (n_pixels,) f32 each, indexed by
    pixel.
    """
    dev = scene.nl8.device
    local = (torch.arange(n_pixels, dtype=torch.int32, device=dev) if pixel_order is None
             else pixel_order)
    pixel = local + pixel_base
    W = config.image_width
    xs = torch.remainder(pixel, W)
    ys = torch.div(pixel, W, rounding_mode="floor")
    sums = path_trace_wavefront_plain(config, scene, xs, ys, spp, sample_base, with_stats)
    if pixel_order is None:
        return sums
    # slot i holds pixel local[i]: put each sum at its pixel
    idx = local.long()
    put = lambda v: None if v is None else torch.empty_like(v).index_copy_(0, idx, v)
    return tuple(put(v) for v in sums)


def morton_pixel_order(width: int, height: int) -> np.ndarray:
    """(W*H,) int32 pixel ids in Morton (Z-curve) order; a ``pixel_order``
    that makes the pixels one warp renders together a compact 2-D tile."""
    idx = np.arange(width * height, dtype=np.int64)
    x = (idx % width).astype(np.uint64)
    y = (idx // width).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = spread(x) | (spread(y) << np.uint64(1))
    return np.argsort(code, kind="stable").astype(np.int32)
