"""``render.render_pixels`` over the row-major list of every pixel, the
request's samples [sample_base, sample_base + spp) averaged by the
megakernel (K2), then ``render.to_bgra``: the CLI's ``--sample-range``
route."""

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def _pixels(width: int, height: int):
    idx = np.arange(width * height, dtype=np.int32)
    return idx % width, idx // width


def render(cfg, tables, req, route, device):
    from pathtracing_tpu_torch.render import render_pixels, to_bgra

    W, H = cfg.image_width, cfg.image_height
    xs, ys = _pixels(W, H)
    colors = render_pixels(cfg, tables, xs, ys, spp=req.spp, sample_base=req.sample_base,
                           average=True, device=device).reshape(H, W, 3)
    return colors, to_bgra(colors, device=device)


def counter(route):
    from pathtracing_tpu_torch.ops import cuda_megakernel

    return cuda_megakernel
