"""The joint bilateral denoiser's kernel (K8): binding and wrapper.

``denoise_cuda`` runs the hand-written kernel in ``csrc/denoise.cu`` (one
thread per pixel, its (2r+1)^2 taps in the plain version's order; see the
note at the top of that file). It is the counterpart of the JAX package's
``denoise._denoise``; ``denoise.denoise`` dispatches to it for CUDA tensors,
and ``denoise.denoise_plain`` is its plain version.

There is no second path to give way to: a build or launch failure, or a
tensor the kernel does not take (CPU tensors among them), raises.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops.cuda_build import CSRC, KernelLibrary, check_tensor as _check
from pathtracing_tpu_torch.utils.vec import c32

SOURCE = CSRC / "denoise.cu"

_p, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
LIBRARY = KernelLibrary(
    SOURCE,
    symbols={
        "pt_denoise": ([_p] * 6 + [_i] * 3 + [_f] * 5 + [_p, _p], _i),
    },
)

# Launches of the kernel since the last reset: incremented where the kernel
# is launched and nowhere else.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def denoise_cuda(colors, albedo, normal, depth, coverage, noise, radius: int, sigmas):
    """K8 on contiguous float32 CUDA tensors: colors, albedo, normal (H, W,
    3), depth, coverage, noise (H, W); ``sigmas`` (sigma_spatial,
    sigma_albedo, sigma_normal, sigma_depth, k_noise). Returns (H, W, 3)
    float32. Launches on PyTorch's current stream and does not synchronise."""
    global launches
    device = colors.device
    if device.type != "cuda":
        raise ValueError(f"denoise_cuda needs CUDA tensors, got {device}")
    if depth.dim() != 2:
        raise ValueError(f"depth: shape {tuple(depth.shape)}, expected (H, W)")
    H, W = depth.shape
    f32 = torch.float32
    for name, t in (("colors", colors), ("albedo", albedo), ("normal", normal)):
        _check(name, t, f32, (H, W, 3), device)
    for name, t in (("depth", depth), ("coverage", coverage), ("noise", noise)):
        _check(name, t, f32, (H, W), device)
    if radius < 0:
        raise ValueError(f"radius={radius}: must be >= 0")
    if H * W * 3 >= 1 << 31:
        raise ValueError(f"{H}x{W}: too many pixels for the kernel's int32 rows")
    out = torch.empty((H, W, 3), dtype=f32, device=device)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        err = lib.pt_denoise(
            colors.data_ptr(), albedo.data_ptr(), normal.data_ptr(), depth.data_ptr(),
            coverage.data_ptr(), noise.data_ptr(), H, W, int(radius),
            *(c32(s) for s in sigmas), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"denoise launch refused: {err}")
    if H * W > 0:
        launches += 1
    return out
