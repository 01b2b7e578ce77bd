"""Host-side scene data model (reference: scene.hh:7-65, bvh.hh:69-79)."""

from __future__ import annotations

import dataclasses

import numpy as np

from pathtracing_tpu_torch.accel.types import BvhBuffers, BvhHandle
from pathtracing_tpu_torch.io.obj import MeshBuffers, MeshHandle
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


@dataclasses.dataclass
class Scene:
    """reference: scene.hh:40-65."""

    mesh_buf: MeshBuffers = dataclasses.field(default_factory=MeshBuffers)
    bvh_buf: BvhBuffers = dataclasses.field(default_factory=BvhBuffers)
    meshes: dict = dataclasses.field(default_factory=dict)  # name -> (mesh, blas)
    instances: list = dataclasses.field(default_factory=list)
    static_instance_count: int = 0
    subframes: list = dataclasses.field(default_factory=list)
    # per-frame bookkeeping mirrored from the reference's subframe_entries
    # (scene.cc:651-676), consumed by the chunked packer
    # (accel/chunks.build_frame_tail_chunked): absolute instance id ranges
    # of each subframe's dynamic additions, and the frame-static span
    # (logo/buddha) shared by every subframe.
    subframe_entries: list = dataclasses.field(default_factory=list)
    frame_static_end: int = 0
