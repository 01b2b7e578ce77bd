"""The wavefront renderer: whole paths for any pixel list.

Counterpart of the JAX package's ``ops/wavefront.py``, where
``path_trace_wavefront`` is an XLA while-loop with path regeneration: one
lane per list entry, and a lane whose path dies respawns its pixel's next
sample at once, so that SIMD lanes that step together stay busy. Here
``path_trace_wavefront`` dispatches: CUDA tensors go to the hand-written
kernel K5 (ops/cuda_wavefront.py, csrc/wavefront.cu: one thread per list
entry, its samples in order, on the binary or the wide tables), CPU tensors
to ``path_trace_wavefront_plain`` below. A CUDA thread leaves its own loop,
so there is nothing to regenerate: the function is the same.

The function (the JAX module's): per entry i, the sums over samples
[sample_base, sample_base + spp) of the reference's path at pixel (xs[i],
ys[i]), the same as summing ``path_trace_samples`` over the range, and with
``with_stats`` the sums of each sample's luminance squared (what adaptive
sampling's statistics pass reads). Duplicate pixels each get their own sums.

The fold: per entry, the samples are added in sample order, from 0, in both
versions (the JAX loop's order as well, since a lane's samples die in
order), so the kernel's sums are deterministic and fold as the plain version
folds. A scene with area-light tables (ops/arealights.py) adds the light
samples, as the scan does; on the card the kernel's area-light instances
render it.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.ops.arealights import has_lights
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.utils.vec import Vec3, c32

_LUM = (c32(0.2126), c32(0.7152), c32(0.0722))


def _wrap_int32(v: int) -> int:
    """An integer as int32 arithmetic wraps it (XLA's add on int32)."""
    return (int(v) + (1 << 31)) % (1 << 32) - (1 << 31)


def _coords(v, device) -> torch.Tensor:
    """A pixel coordinate array (numpy, list or tensor) as a contiguous
    (n,) int32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.int64)))
    if t.dim() != 1:
        raise ValueError(f"pixel coordinates: shape {tuple(t.shape)}, expected (n,)")
    return t.to(device=device, dtype=torch.int32).contiguous()


def path_trace_wavefront(
    config,
    scene,
    xs,
    ys,
    spp: int,
    sample_base: int = 0,
    with_stats: bool = False,
    return_truncated: bool = False,
    device=None,
):
    """Per-entry radiance sums over samples [sample_base, sample_base + spp)
    for pixels (xs[i], ys[i]). Returns a Vec3 of (n,) sums (divide by spp for
    the average); with ``with_stats`` (sums, lum2), lum2 the (n,) sums of each
    sample's luminance squared; with ``return_truncated`` also a one-element
    int32 tensor: the samples the kernel's step cap abandoned (0 for the plain
    version, which has no cap).

    ``xs``, ``ys``: (n,) integer arrays or tensors, moved to the device as
    int32. Binary or wide tables: the kernel walks what ``ray_query`` walks.
    ``device=None`` means CUDA and raises when there is no card; the scene
    must lie on the device. On CUDA the kernel renders (or the call raises);
    on the CPU the plain version.
    """
    has_lights(scene)  # all five light tables or none
    device = resolve_device(device)
    if scene.nl8.device != device:
        raise ValueError(f"scene is on {scene.nl8.device}, render asked for {device}")
    xs, ys = _coords(xs, device), _coords(ys, device)
    if xs.shape != ys.shape:
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)} differ")
    if device.type == "cuda":
        from pathtracing_tpu_torch.ops.cuda_wavefront import wavefront_cuda

        r, g, b, l2, n_truncated, _ = wavefront_cuda(
            config, scene, xs, ys, spp, sample_base, with_stats
        )
    else:
        r, g, b, l2 = path_trace_wavefront_plain(
            config, scene, xs, ys, spp, sample_base, with_stats
        )
        n_truncated = torch.zeros(1, dtype=torch.int32, device=device)
    out = (Vec3(r, g, b), l2) if with_stats else (Vec3(r, g, b),)
    if return_truncated:
        out = out + (n_truncated,)
    return out if len(out) > 1 else out[0]


def path_trace_wavefront_plain(
    config,
    scene,
    xs,
    ys,
    spp: int,
    sample_base: int = 0,
    with_stats: bool = False,
):
    """The plain PyTorch version of the wavefront kernel, on whatever device
    the scene lies: the sample-ordered sum of ``path_trace_samples`` over the
    list (one batch of n lanes per sample), each sample's luminance squared
    summed beside it with ``with_stats``. ``xs``, ``ys``: (n,) int32 tensors
    on the scene's device. Returns (r, g, b, l2 or None), (n,) f32 each."""
    n = xs.shape[0]
    zero = lambda: torch.zeros(n, dtype=torch.float32, device=xs.device)
    r, g, b = zero(), zero(), zero()
    l2 = zero() if with_stats else None
    for j in range(spp):
        si = torch.full((n,), _wrap_int32(sample_base + j), dtype=torch.int32,
                        device=xs.device)
        c = path_trace_samples(config, scene, xs, ys, si)
        # in place: the sums are the only state that outlives a sample
        r += c.x
        g += c.y
        b += c.z
        if with_stats:
            lum = _LUM[0] * c.x + _LUM[1] * c.y + _LUM[2] * c.z
            l2 += lum * lum
    return r, g, b, l2
