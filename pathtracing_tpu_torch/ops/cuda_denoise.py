"""The joint bilateral denoiser's kernel (K8): binding and wrapper.

``denoise_cuda`` runs the hand-written kernels of ``csrc/denoise.cu`` (see
the note at the top of that file). The design for the card, "tile", stages
each block's 32 x 8 tile with its halo in shared memory as packed 16-byte
records, takes the spatial factor from a table computed once a block, runs
one pixel a thread and skips a factor whose exponent is exactly +-0 (the
same bits). It is bound by its bit-equal arithmetic: accurate ``expf`` and
IEEE division. A radius whose tile and halo do not fit the shared memory a
block may use (r >= 24 on an H100) goes to the first design, "first" (one
thread a pixel, its neighbours read from device memory), a counted path of
its own. Both keep the plain version's bits (``--fmad=false``, IEEE
division, accurate ``expf``, the plain version's order of taps and sums).
Both are the counterpart of the JAX package's ``denoise._denoise``;
``denoise.denoise`` dispatches to them for CUDA tensors, and
``denoise.denoise_plain`` is their plain version.

There is no second path to give way to: a build or launch failure, or a
tensor the kernel does not take (CPU tensors among them), raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pathtracing_tpu_torch.ops.cuda_build import CSRC, KernelLibrary, check_tensor as _check
from pathtracing_tpu_torch.utils.vec import c32

SOURCE = CSRC / "denoise.cu"

_p, _f, _i, _ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary(
    SOURCE,
    symbols={
        "pt_denoise": ([_p] * 6 + [_i] * 3 + [_f] * 5 + [_p, _i, _p], _i),
        "pt_denoise_smem": ([_i, _i], _ll),
        "pt_denoise_smem_limit": ([], _ll),
    },
)

# The kernel's designs, in the order of csrc/denoise.cu's C interface:
# "first" (one thread a pixel, neighbours from device memory) and "tile"
# (the tile and its halo staged in shared memory; a radius whose tile does
# not fit a block's shared memory takes the first design).
DESIGNS = ("first", "tile")

# Launches of the kernels since the last reset: incremented where a kernel
# is launched and nowhere else; ``launches_by_design`` splits the count.
launches = 0
launches_by_design = dict.fromkeys(DESIGNS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_design:
        launches_by_design[k] = 0


def smem_bytes(design: str, radius: int) -> int:
    """Dynamic shared memory a block of ``design`` takes at ``radius``."""
    return int(LIBRARY.load().pt_denoise_smem(DESIGNS.index(design), int(radius)))


@functools.lru_cache(maxsize=None)
def smem_limit(index: int) -> int:
    """The most dynamic shared memory a block may take on CUDA device
    ``index``."""
    with torch.cuda.device(index):
        limit = int(LIBRARY.load().pt_denoise_smem_limit())
    if limit < 0:
        raise RuntimeError("denoise: could not read the device's shared memory limit")
    return limit


def design_for(radius: int) -> str:
    """The design a call at ``radius`` takes on the current device: the tile
    design where its tile and halo fit the shared memory a block may use,
    else the first design."""
    fits = smem_bytes("tile", radius) <= smem_limit(torch.cuda.current_device())
    return "tile" if fits else "first"


def denoise_cuda(colors, albedo, normal, depth, coverage, noise, radius: int, sigmas,
                 _design: str | None = None):
    """K8 on contiguous float32 CUDA tensors: colors, albedo, normal (H, W,
    3), depth, coverage, noise (H, W); ``sigmas`` (sigma_spatial,
    sigma_albedo, sigma_normal, sigma_depth, k_noise). Returns (H, W, 3)
    float32. Launches on PyTorch's current stream and does not synchronise.
    ``_design``: None (``design_for(radius)``) or one of ``DESIGNS``, an
    instrument for chip_smoke.py."""
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
    if _design is not None and _design not in DESIGNS:
        raise ValueError(f"_design={_design!r}: None or one of {DESIGNS}")
    out = torch.empty((H, W, 3), dtype=f32, device=device)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        design = design_for(radius) if _design is None else _design
        err = lib.pt_denoise(
            colors.data_ptr(), albedo.data_ptr(), normal.data_ptr(), depth.data_ptr(),
            coverage.data_ptr(), noise.data_ptr(), H, W, int(radius),
            *(c32(s) for s in sigmas), out.data_ptr(), DESIGNS.index(design),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"denoise launch refused ({design}, radius {radius}): {err}")
    if H * W > 0:
        launches += 1
        launches_by_design[design] += 1
    return out
