"""The megakernel renderer: whole paths in one kernel per call.

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
``wide_ray_query`` record for their walks). ``record=True`` (the fast
gradients' record pass) runs the kernel's record build K6 on CUDA. A scene
with area-light tables (ops/arealights.py) renders through the kernel's
area-light instances; its record mode raises NotImplementedError, as the JAX
package's does.

The fold: per pixel, the samples are added in sample order, from 0, in both
versions, so the kernel's sums are deterministic and fold as the plain
version folds (the JAX loop folds in the order its lanes finish items).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.ops.arealights import has_lights
from pathtracing_tpu_torch.ops.integrator import path_trace_samples_masked_records
from pathtracing_tpu_torch.ops.wavefront import _wrap_int32, path_trace_wavefront_plain
from pathtracing_tpu_torch.utils.vec import Vec3


def _check_supported(scene, record: bool, spp: int, with_stats: bool,
                     pixel_order) -> None:
    if record and scene.lt_tris is not None:
        raise NotImplementedError(
            "the record mode supports the sun-NEE path only, not area-light "
            "NEE (as in the JAX package)"
        )
    has_lights(scene)  # all five light tables or none
    if record and spp < 1:
        raise ValueError(f"record mode needs spp >= 1, got {spp}")
    if record and with_stats:
        raise ValueError("record mode excludes with_stats")
    if record and pixel_order is not None:
        raise ValueError(
            "record mode indexes records by item; the replay assumes the "
            "identity item -> pixel map (no pixel_order)"
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

    record: the fast gradients' record pass (diff/render.
    make_fast_grad_frame_fn). Also returns the hit topology of every work
    item ``k * n_pixels + slot`` (sample k, sample-major), ``(sums,
    (prim_rec, bounce_recs))`` in the scan's record format
    (``path_trace_samples(record=True)``: dicts of (n_items,) and
    (max_bounces, n_items) tensors), with every row a path never reached
    zero (csrc/path.cuh, ItemRecord). On CUDA the record build of the
    kernel (K6) renders; not with ``with_stats`` or ``pixel_order``.

    Needs the wide tables (``wide=True``). ``device=None`` means CUDA and
    raises when there is no card; the scene must lie on the device. On CUDA
    the kernel renders (or the call raises); on the CPU the plain version.
    """
    _check_supported(scene, record, spp, with_stats, pixel_order)
    device = resolve_device(device)
    if scene.wide_rows.device != device:
        raise ValueError(f"scene is on {scene.wide_rows.device}, render asked for {device}")
    if record:
        if device.type == "cuda":
            from pathtracing_tpu_torch.ops.cuda_megakernel import megakernel_record_cuda

            r, g, b, n_truncated, planes = megakernel_record_cuda(
                config, scene, n_pixels, spp, sample_base, pixel_base)
            records = unpack_records(planes, config.max_bounces, n_pixels * spp)
        else:
            (r, g, b), records = path_trace_megakernel_plain(
                config, scene, n_pixels, spp, sample_base, pixel_base, record=True)
            n_truncated = torch.zeros(1, dtype=torch.int32, device=device)
        out = (Vec3(r, g, b), records)
        return out + (n_truncated,) if return_truncated else out
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
    record: bool = False,
):
    """The plain PyTorch version of the megakernel, on whatever device the
    scene lies: the wavefront's plain version (the sample-ordered sum of
    ``path_trace_samples``) over the slots' pixels, each slot's sums then put
    at its pixel.

    ``pixel_order``: None or an int32 permutation tensor on the scene's
    device. Returns (r, g, b, l2 or None), (n_pixels,) f32 each, indexed by
    pixel. ``record=True`` (no stats, no order) returns ((r, g, b),
    (prim_rec, bounce_recs)): the same sums and the scan's records with every
    row a path never reached set to zero
    (``path_trace_samples_masked_records``), the record build's rule.
    """
    dev = scene.nl8.device
    local = (torch.arange(n_pixels, dtype=torch.int32, device=dev) if pixel_order is None
             else pixel_order)
    pixel = local + pixel_base
    W = config.image_width
    xs = torch.remainder(pixel, W)
    ys = torch.div(pixel, W, rounding_mode="floor")
    if record:
        return _plain_records(config, scene, xs, ys, spp, sample_base)
    sums = path_trace_wavefront_plain(config, scene, xs, ys, spp, sample_base, with_stats)
    if pixel_order is None:
        return sums
    # slot i holds pixel local[i]: put each sum at its pixel
    idx = local.long()
    put = lambda v: None if v is None else torch.empty_like(v).index_copy_(0, idx, v)
    return tuple(put(v) for v in sums)


def _plain_records(config, scene, xs, ys, spp, sample_base):
    """The record mode of the plain version over the slots' pixels (xs, ys):
    the sample-ordered sums and the masked scan records, sample-major."""
    n = xs.shape[0]
    zero = lambda: torch.zeros(n, dtype=torch.float32, device=xs.device)
    r, g, b = zero(), zero(), zero()
    prims, bounces = [], []
    for k in range(spp):
        si = torch.full((n,), _wrap_int32(sample_base + k), dtype=torch.int32,
                        device=xs.device)
        c, (p, rb) = path_trace_samples_masked_records(config, scene, xs, ys, si)
        r, g, b = r + c.x, g + c.y, b + c.z
        prims.append(p)
        bounces.append(rb)
    cat = lambda recs, dim: {key: torch.cat([rec[key] for rec in recs], dim)
                             for key in recs[0]}
    return (r, g, b), (cat(prims, 0), cat(bounces, 1))


def unpack_records(planes, max_bounces: int, n_items: int):
    """The record build's packed planes (ops/cuda_megakernel.RecordPlanes)
    in the scan's record format: (prim_rec, bounce_recs), dicts of
    (n_items,) and (max_bounces, n_items) tensors. ``pk >> 2`` is
    arithmetic, so a miss keeps inst -1; the primary occ is all False."""

    def unpack(pk, prim, occ):
        return {
            "hit": (pk & 1) != 0,
            "inst": pk >> 2,
            "prim": prim,
            "back": (pk & 2) != 0,
            "occ": occ,
        }

    prim_rec = unpack(planes.pk_p, planes.prim_p, torch.zeros_like(planes.pk_p, dtype=torch.bool))
    bounce = unpack(planes.pk_b, planes.prim_b, planes.occ_b != 0)
    return prim_rec, {k: v.view(max_bounces, n_items) for k, v in bounce.items()}


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
