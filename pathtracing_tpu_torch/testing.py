"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

The tests feed the same numpy inputs to a JAX function and to its
counterpart here (``device="cpu"``); these helpers move arrays in and out
of the port's SoA types. Imports no JAX. Importing this module pins PyTorch
to one thread: the test suite runs several worker processes side by side.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pathtracing_tpu_torch.utils.goldenio import load_golden
from pathtracing_tpu_torch.utils.vec import Vec3

torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"


def golden(name: str) -> dict[str, np.ndarray]:
    """Load ``tests/golden/<name>`` (the oracle's dumps are committed)."""
    return load_golden(str(GOLDEN_DIR / name))


def t(a, dtype=None) -> torch.Tensor:
    """numpy array -> CPU tensor (a copy; uint32 goes to its int32 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


def vec3_t(a) -> Vec3:
    """(N, 3) numpy -> Vec3 of CPU tensors."""
    return Vec3(*(t(a[:, i]) for i in range(3)))


def n(x) -> np.ndarray:
    """tensor (or anything array-like, e.g. a JAX array) -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stack(components) -> np.ndarray:
    """A Vec (or any tuple of same-shape tensors/arrays) -> (N, k) numpy."""
    return np.stack([n(c) for c in components], axis=-1)


def rel_err(got, ref, eps) -> np.ndarray:
    return np.abs(got - ref) / (np.abs(ref) + eps)
