"""AOV-guided joint bilateral denoiser; the JAX package's ``denoise.py``.

Each pixel averages its (2r+1)^2 neighbourhood with weights from the
primary-hit AOV buffers (aov.py): neighbours contribute only where albedo,
shading normal and depth agree, so geometric and material edges survive
while flat-region noise averages out; with a per-pixel noise map
(adaptive.render_with_variance's standard error) a range factor also keeps
illumination edges the guides cannot see. No reference equivalent (the
reference writes raw accumulations, main.cc:42-46): a fast-preview
workflow of low spp + AOVs + denoise.

``joint_bilateral_denoise`` is the entry point, with the JAX package's
signature and defaults. On a CUDA device it runs the hand-written kernel K8
(ops/cuda_denoise.py, csrc/denoise.cu: one thread per pixel); on the CPU
``denoise_plain``, its plain version, which follows the JAX ``_denoise``
operation by operation (``jnp.pad(mode="edge")`` as clamped indexing).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.utils.vec import c32

__all__ = ["denoise", "denoise_plain", "joint_bilateral_denoise"]

_LUM = (c32(0.2126), c32(0.7152), c32(0.0722))  # Rec.709 (reference: math.hh:437-439)
# sigma_spatial, sigma_albedo, sigma_normal, sigma_depth, k_noise
DEFAULT_SIGMAS = (2.0, 0.1, 0.05, 0.05, 2.0)


def denoise_plain(colors, albedo, normal, depth, coverage, noise, radius: int = 2,
                  sigmas=DEFAULT_SIGMAS):
    """The plain PyTorch version of K8, on the tensors' device: colors,
    albedo, normal (H, W, 3), depth, coverage, noise (H, W) float32 (noise
    +inf: no range factor). The taps dy outer, dx inner; the six weight
    factors and the sums in the JAX ``_denoise``'s order. Returns (H, W, 3)
    float32."""
    H, W = depth.shape
    dev = colors.device
    s_sp, s_al, s_no, s_de, k = (torch.tensor(c32(v), dtype=torch.float32, device=dev)
                                 for v in sigmas)
    lum = _LUM[0] * colors[..., 0] + _LUM[1] * colors[..., 1] + _LUM[2] * colors[..., 2]
    # depth similarity is relative to the local scale
    z_scale = torch.clamp(torch.abs(depth), min=c32(1e-3))
    two_ss = 2.0 * s_sp * s_sp
    two_sa = 2.0 * s_al * s_al
    sn = torch.clamp(s_no, min=c32(1e-6))
    two_sd = 2.0 * s_de * s_de
    ch = lambda a: (a[..., 0], a[..., 1], a[..., 2])
    acc = [torch.zeros_like(depth) for _ in range(3)]
    wsum = torch.zeros_like(depth)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    for dy in range(-radius, radius + 1):
        rows = torch.clamp(ys + dy, 0, H - 1)
        for dx in range(-radius, radius + 1):
            cols = torch.clamp(xs + dx, 0, W - 1)
            take = lambda a: a.index_select(0, rows).index_select(1, cols)
            w = torch.exp(torch.tensor(float(-(dx * dx + dy * dy)), device=dev) / two_ss)
            da = [s - c for s, c in zip(ch(take(albedo)), ch(albedo))]
            w = w * torch.exp(-((da[0] * da[0] + da[1] * da[1]) + da[2] * da[2]) / two_sa)
            sn3, n3 = ch(take(normal)), ch(normal)
            ndot = (sn3[0] * n3[0] + sn3[1] * n3[1]) + sn3[2] * n3[2]
            w = w * torch.exp(-(1.0 - ndot) / sn)
            dz = (take(depth) - depth) / z_scale
            w = w * torch.exp(-(dz * dz) / two_sd)
            # sky <-> surface boundaries: only mix alike coverage
            w = w * torch.exp(-8.0 * torch.abs(take(coverage) - coverage))
            # the noise-scaled range factor: neighbours whose luminance
            # differs by much more than the noise are real illumination edges
            sig = k * torch.clamp(torch.maximum(take(noise), noise), min=c32(1e-20))
            dl = (take(lum) - lum) / sig
            w = w * torch.exp(-0.5 * dl * dl)
            for a, c in zip(acc, ch(take(colors))):
                a += c * w
            wsum += w
    d = torch.clamp(wsum, min=c32(1e-20))
    return torch.stack([a / d for a in acc], -1)


def denoise(colors, albedo, normal, depth, coverage, noise, radius: int = 2,
            sigmas=DEFAULT_SIGMAS):
    """K8 on CUDA tensors (ops/cuda_denoise.denoise_cuda: the kernel or a
    raise), ``denoise_plain`` on CPU tensors; arguments as
    ``denoise_plain``'s."""
    if colors.is_cuda:
        from pathtracing_tpu_torch.ops.cuda_denoise import denoise_cuda

        return denoise_cuda(colors, albedo, normal, depth, coverage, noise, radius, sigmas)
    return denoise_plain(colors, albedo, normal, depth, coverage, noise, radius, sigmas)


def joint_bilateral_denoise(
    colors: np.ndarray,
    aovs: dict,
    noise: np.ndarray | None = None,
    radius: int = 2,
    sigma_spatial: float = 2.0,
    sigma_albedo: float = 0.1,
    sigma_normal: float = 0.05,
    sigma_depth: float = 0.05,
    k_noise: float = 2.0,
    device=None,
):
    """Denoise an (H, W, 3) radiance image using its AOV buffers.

    aovs: dict with 'albedo' (H, W, 3), 'normal' (H, W, 3), 'depth' (H, W),
    'coverage' (H, W) — render_aovs' buffers reshaped to the frame. noise:
    optional (H, W) per-pixel luminance standard error of the pixel mean
    (adaptive.render_with_variance returns it); None disables the range
    factor (+inf). ``device=None`` means CUDA (K8) and raises when there is
    no card; "cpu" runs the plain version. Returns (H, W, 3) float32 numpy.
    """
    device = resolve_device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    c = up(colors)
    nz = (torch.full(c.shape[:2], float("inf"), dtype=torch.float32, device=device)
          if noise is None else up(noise))
    out = denoise(
        c, up(aovs["albedo"]), up(aovs["normal"]), up(aovs["depth"]), up(aovs["coverage"]),
        nz, int(radius), (sigma_spatial, sigma_albedo, sigma_normal, sigma_depth, k_noise),
    )
    return out.cpu().numpy()
