"""Variance-guided adaptive sampling; the JAX package's ``adaptive.py``.

The reference renders a fixed SAMPLES_PER_PIXEL everywhere (main.cc:26-38).
This framework extension reallocates a sample budget across pixels by
measured per-pixel variance: a uniform pass estimates the Monte-Carlo
luminance variance, then the remaining budget goes to the noisy pixels
(sample count proportional to the luminance standard deviation, which
minimizes the summed per-pixel variance for a fixed total).

A sample is identified by (x, y, sample_index) alone (reference:
path_tracer.hh:659), so adaptive rendering draws the same radiance values a
uniform render would; it only changes how many consecutive sample indices
each pixel consumes. Partial sums merge with sample ranges exactly as
uniform ones do.

On a CUDA device the statistics pass of a row-major frame on wide tables is
the megakernel K2 with its luminance-squared plane (the JAX package takes
its megakernel there on a TPU); otherwise the tiled scan, or the wavefront
K5 with ``wavefront=True``. The second pass is ``render_pixels`` per bucket
of equal extra counts, from sample ``spp_base`` on.

Sample indices reach ``spp_base + max_extra``; the packed scene must carry
subframes for that many samples (pass the intended spp_total when packing).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.render import render_pixels

__all__ = ["allocate_samples", "render_adaptive", "render_with_variance"]

_LUM = (0.2126, 0.7152, 0.0722)  # Rec.709 (reference: math.hh:437-439)


def render_with_variance(
    config: RenderConfig,
    scene,
    xs: np.ndarray,
    ys: np.ndarray,
    spp: int,
    tile_pixels: int | None = None,
    device=None,
):
    """Uniform render that also returns the per-pixel luminance standard
    error of the mean: the noise map the denoiser's range factor takes.

    Returns (colors (N, 3) f32 averaged, stderr (N,) f32), numpy.
    """
    sums, lum2 = _stats_pass(config, scene, xs, ys, spp, tile_pixels, False, device)
    lum_sum = sums @ np.asarray(_LUM, np.float32)
    var = np.maximum(lum2 - lum_sum * lum_sum / spp, 0.0) / max(spp - 1, 1)
    stderr = np.sqrt(var / spp).astype(np.float32)
    return sums / np.float32(spp), stderr


def _stats_pass(config, scene, xs, ys, spp, tile_pixels, wavefront, device=None):
    """Uniform pass over samples [0, spp): (sums (N, 3), lum2 (N,)) numpy."""
    from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel
    from pathtracing_tpu_torch.ops.wavefront import (
        path_trace_wavefront,
        path_trace_wavefront_plain,
    )
    from pathtracing_tpu_torch.render import (
        _mk_spp_chunk,
        default_tile_pixels,
        megakernel_supported,
        run_tiled,
    )

    if spp < 1:
        raise ValueError("the variance pass needs spp >= 1")
    device = resolve_device(device)
    if scene.nl8.device != device:
        raise ValueError(f"scene is on {scene.nl8.device}, render asked for {device}")
    xs = np.asarray(xs, np.int32)
    ys = np.asarray(ys, np.int32)
    # the base pass is a full-frame row-major render: on the card it goes
    # through the megakernel when the scene has wide tables
    if device.type == "cuda" and megakernel_supported(scene, xs, ys, config.image_width):
        n = len(xs)
        acc = torch.zeros((4, n), dtype=torch.float32, device=device)
        truncated = []
        # the same dispatch cap as render_pixels'
        chunk = _mk_spp_chunk(n, spp, scene, bytes_per_pixel=16)
        for a in range(0, spp, chunk):
            c = min(chunk, spp - a)
            sums, l2, n_trunc = path_trace_megakernel(
                config, scene, n, c, a, with_stats=True, return_truncated=True,
                device=device,
            )
            for k, plane in enumerate((*sums, l2)):
                acc[k].add_(plane)
            truncated.append(n_trunc)
        k = int(torch.cat(truncated).sum())
        if k:
            raise RuntimeError(f"megakernel step cap abandoned {k} samples of the "
                               "variance pass: output would be darkened")
        r, g, b, lum2 = acc.cpu().numpy()
        return np.stack([r, g, b], -1), lum2
    if tile_pixels is None:
        tile_pixels = default_tile_pixels(scene, device)
    if wavefront:
        truncated = []

        def kernel(txs, tys):
            sums, l2, n_trunc = path_trace_wavefront(
                config, scene, txs, tys, spp, with_stats=True, return_truncated=True,
                device=device,
            )
            truncated.append(n_trunc)
            return (*sums, l2)

        r, g, b, lum2 = run_tiled(kernel, xs, ys, tile_pixels, 4, device)
        if int(torch.cat(truncated).sum()):
            raise RuntimeError("wavefront step cap abandoned samples of the variance "
                               "pass: output would be darkened")
    else:
        kernel = lambda txs, tys: path_trace_wavefront_plain(
            config, scene, txs, tys, spp, 0, True)
        r, g, b, lum2 = run_tiled(kernel, xs, ys, tile_pixels, 4, device)
    return np.stack([r, g, b], -1), lum2


def allocate_samples(
    var: np.ndarray,
    budget: int,
    max_extra: int | None = None,
) -> np.ndarray:
    """Distribute ``budget`` extra samples over pixels, about in proportion
    to the luminance standard deviation, quantized to powers of two (so
    pass 2 has at most log2(max_extra) + 1 buckets).

    Returns per-pixel extra counts (int32) with sum <= budget.
    """
    n = len(var)
    if budget <= 0 or n == 0:
        return np.zeros(n, np.int32)
    sigma = np.sqrt(np.maximum(var, 0.0))
    total = sigma.sum()
    if not total > 0:  # flat image (or NaN variance): spread uniformly
        flat = int(budget // n)
        if max_extra is not None:
            flat = min(flat, int(max_extra))
        return np.full(n, 1 << max(flat.bit_length() - 1, 0) if flat else 0,
                       np.int32)
    if max_extra is None:
        # cap any single pixel at 8x its fair share of the budget
        max_extra = max(8 * budget // n, 2)
    raw = sigma * (budget / total)
    raw = np.minimum(raw, max_extra)
    # floor to a power of two (0 stays 0); keeps the set of counts tiny
    alloc = np.zeros(n, np.int64)
    pos = raw >= 1.0
    alloc[pos] = 1 << (np.floor(np.log2(raw[pos])).astype(np.int64))
    # flooring frees budget; promote the highest-variance pixels (doubling,
    # clamped at max_extra) in vectorized passes until the budget is spent
    # or every pixel is at the cap; one final partial fill may make a single
    # count that is not a power of two
    spare = budget - int(alloc.sum())
    order = np.argsort(-sigma, kind="stable")
    while spare > 0:
        inc = np.minimum(np.where(alloc > 0, alloc, 1), max_extra - alloc)
        live = order[inc[order] > 0]  # promotable, by descending sigma
        if live.size == 0:
            break
        incs = inc[live]
        c = np.cumsum(incs)
        k = int(np.searchsorted(c, spare, side="right"))
        if k == 0:
            # even the best candidate's doubling exceeds the remaining
            # budget: partial fill (spare < incs[0] <= its cap headroom)
            alloc[live[0]] += spare
            break
        alloc[live[:k]] += incs[:k]
        spare -= int(c[k - 1])
    return alloc.astype(np.int32)


def render_adaptive(
    config: RenderConfig,
    scene,
    xs: np.ndarray,
    ys: np.ndarray,
    spp_base: int,
    spp_total: int,
    tile_pixels: int | None = None,
    wavefront: bool = False,
    alloc: np.ndarray | None = None,
    device=None,
    timings: dict | None = None,
):
    """Two-pass adaptive render of a pixel list.

    Pass 1 renders ``spp_base`` samples everywhere and measures variance;
    pass 2 spends the remaining ``(spp_total - spp_base) * N`` samples where
    the variance is. Returns (colors (N, 3) f32 averaged, n_samples (N,)
    int32), numpy. ``alloc`` overrides the variance-guided allocation with
    explicit per-pixel extra counts (pass 2 renders one bucket per distinct
    nonzero count). ``device=None`` means CUDA. ``timings``: a dict that,
    when given, receives each pass's host seconds (``pass1_s``,
    ``pass2_s``; each ends when its sums are on the host).
    """
    import time

    from pathtracing_tpu_torch.render import default_tile_pixels

    if spp_base < 1:
        raise ValueError("spp_base must be >= 1")
    if spp_total < spp_base:
        raise ValueError("spp_total must be >= spp_base")
    device = resolve_device(device)
    if tile_pixels is None:
        tile_pixels = default_tile_pixels(scene, device)
    n = len(xs)
    xs = np.asarray(xs, np.int32)
    ys = np.asarray(ys, np.int32)

    # ---- pass 1: uniform + variance ----
    t0 = time.perf_counter()
    sums, lum2 = _stats_pass(
        config, scene, xs, ys, spp_base, tile_pixels, wavefront, device
    )
    t1 = time.perf_counter()

    counts = np.full(n, spp_base, np.int64)

    if alloc is None:
        budget = (spp_total - spp_base) * n
        if budget > 0:
            lum_sum = sums @ np.asarray(_LUM, np.float32)
            # unbiased per-pixel sample variance of luminance
            var = (lum2 - lum_sum * lum_sum / spp_base) / max(spp_base - 1, 1)
            # never run a pixel past the motion-blur subframes the scene was
            # packed for: extra sample indices live in [spp_base, spp_base +
            # max_extra), and a subframe row past the table reads its last
            packed_spp = (
                scene.sf_cam.shape[0] * config.samples_per_motion_blur_step
            )
            max_extra = max(packed_spp - spp_base, 0)
            default_cap = max(8 * budget // n, 2)
            alloc = allocate_samples(
                var, budget, max_extra=min(default_cap, max_extra)
            )
        else:
            alloc = np.zeros(n, np.int32)

    # ---- pass 2: per-bucket extra samples (raw sums, the same RNG stream)
    for s in np.unique(alloc):
        s = int(s)
        if s == 0:
            continue
        sel = np.nonzero(alloc == s)[0]
        extra = render_pixels(
            config, scene, xs[sel], ys[sel], spp=s,
            tile_pixels=tile_pixels,
            sample_base=spp_base, average=False, wavefront=wavefront, device=device,
        )
        sums[sel] += extra
        counts[sel] += s
    if timings is not None:
        timings.update(pass1_s=t1 - t0, pass2_s=time.perf_counter() - t1)

    return sums / counts[:, None].astype(np.float32), counts.astype(np.int32)
