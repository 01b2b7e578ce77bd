"""pathtracing_tpu_torch — the PyTorch/CUDA port of ``pathtracing_tpu``.

Same sub-package layout and function names as the JAX package, PyTorch
idiom inside: plain functions on tensors, NamedTuples of tensors, an
explicit ``device`` argument on every entry point.  The package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of the JAX package.

Layering:
  utils/   SoA vec math, golden-file IO, host matrix math
  io/      BMP output, mesh handles
  accel/   flat BVH buffer types
  scene/   host scene types, device packing, golden-scene construction
  ops/     rng, ray query (plain version + the CUDA kernel wrapper), camera,
           samplers, bsdf, sky, integrator, tonemap
  csrc/    hand-written CUDA sources, built at first use
  render.py  tiled frame rendering

Device policy: ``device=None`` on an entry point means CUDA; when no CUDA
device is present the call raises.  The CPU is used only on request
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "TESTING",
    "PRODUCTION",
    "render_frame",
    "render_pixels",
    "write_bmp",
    "resolve_device",
]


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` means CUDA and raises
    when there is no card — a render never drops to the CPU silently."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU on purpose"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested and none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def __getattr__(name):
    """Lazy top-level API (keeps ``import pathtracing_tpu_torch`` light)."""
    if name in ("RenderConfig", "TESTING", "PRODUCTION"):
        from pathtracing_tpu_torch import config

        return getattr(config, name)
    if name in ("render_frame", "render_pixels"):
        from pathtracing_tpu_torch import render

        return getattr(render, name)
    if name == "write_bmp":
        from pathtracing_tpu_torch.io.bmp import write_bmp

        return write_bmp
    raise AttributeError(name)
