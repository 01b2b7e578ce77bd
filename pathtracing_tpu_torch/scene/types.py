"""Host-side scene data model (reference: scene.hh:7-34, bvh.hh:69-79).

The handles the device packer reads.  The ``Scene`` container of the JAX
package belongs to the host pipeline (loader, animation) and comes with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pathtracing_tpu_torch.accel.types import BvhHandle
from pathtracing_tpu_torch.io.obj import MeshHandle
from pathtracing_tpu_torch.utils.hostmath import inverse4

f32 = np.float32


@dataclasses.dataclass
class TlasInstance:
    """reference: bvh.hh:73-79 — inv_transform must be inverse4(transform)."""

    blas: BvhHandle
    mesh: MeshHandle
    transform: np.ndarray  # (4,4) f32 row-major
    inv_transform: np.ndarray

    @classmethod
    def create(cls, blas, mesh, transform):
        return cls(blas, mesh, transform.astype(f32), inverse4(transform))


@dataclasses.dataclass
class Camera:
    """reference: scene.hh:7-17."""

    orientation: np.ndarray  # (3,3) f32
    position: np.ndarray  # (3,) f32
    aspect_ratio: float
    inv_focal_length: float
    focal_distance: float
    aperture_angle: float
    aperture_polygon: int
    aperture_radius: float


@dataclasses.dataclass
class DirectionalLight:
    """reference: scene.hh:19-24."""

    direction: np.ndarray  # (3,) f32 unit
    color: np.ndarray  # (3,) f32
    cos_solid_angle: float


@dataclasses.dataclass
class Subframe:
    """Per-motion-blur-step state (reference: scene.hh:26-34)."""

    tlas: BvhHandle
    cam: Camera
    light: DirectionalLight
