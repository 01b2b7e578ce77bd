"""ACES-fit tonemap + sRGB OETF (reference: path_tracer.hh:747-771)."""

from __future__ import annotations

import torch

from pathtracing_tpu_torch.utils.vec import Vec3, clamp


def tonemap(color: Vec3):
    """Returns (b, g, r, a) uint8 channels — BGRA order like the reference."""
    c = (color * (color * 2.51 + 0.03)) / (color * (color * 2.43 + 0.59) + 0.14)

    def srgb(x):
        return torch.where(
            x < 0.0031308,
            x * 12.92,
            torch.pow(x, 1.0 / 2.4) * 1.055 - 0.055,
        )

    c = Vec3(srgb(c.x), srgb(c.y), srgb(c.z))
    c = Vec3(
        clamp(c.x, 0.0, 1.0), clamp(c.y, 0.0, 1.0), clamp(c.z, 0.0, 1.0)
    )

    def quant(x):
        # C round() = half away from zero; x in [0,1] so floor(x*255 + 0.5)
        return torch.floor(x * 255.0 + 0.5).to(torch.uint8)

    a = torch.full_like(c.x, 255, dtype=torch.uint8)
    return quant(c.z), quant(c.y), quant(c.x), a
