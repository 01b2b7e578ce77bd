"""Device selection for the command line (the JAX package's
``utils/platform.ensure_backend``).

The JAX package probes its TPU in a subprocess and drops to the CPU when
the TPU does not answer. The port has no fallback: it renders on the CUDA
device, raises when there is none, and runs on the CPU only when the caller
asks for it (``--device cpu``).
"""

from __future__ import annotations

import torch

from pathtracing_tpu_torch import resolve_device


def ensure_backend(device: str | None = None) -> torch.device:
    """The device a command renders on: ``None`` or "cuda" is the CUDA
    device (RuntimeError when there is none), "cpu" the CPU."""
    return resolve_device(device)
