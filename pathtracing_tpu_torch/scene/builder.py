"""Public scene-construction API (the JAX package's ``scene/builder.py``).

The reference hard-codes its one scene (scene.cc); this builder is the
user-facing way to compose arbitrary scenes for the renderer:

    from pathtracing_tpu_torch.scene.builder import SceneBuilder
    b = SceneBuilder()
    b.add_mesh("dragon", "data/dragon.obj")
    b.add_instance("dragon", pos=(0, 0, 0), pitch_yaw_roll=(0, 45, 0))
    b.set_camera(position=(0, 2, 8), pitch_yaw_roll=(10, 0, 0), fov=60)
    b.set_light(direction=(0, 1, 1), color=(4, 4, 4))
    scene, device_scene = b.build(config)                 # on the card
    scene, device_scene = b.build(config, device="cpu")   # on the CPU

Meshes load and BVHs build on the host (numpy, or the native C++ loader and
builders of ``io/native_loader`` / ``accel/native``); ``build`` then packs
the tables onto ``device`` through ``scene/device.pack_scene``.
"""

from __future__ import annotations

import time

import numpy as np

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.accel.builder_py import build_blas, build_tlas
from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.io.obj import load_mesh
from pathtracing_tpu_torch.scene.device import attach_wide, pack_scene
from pathtracing_tpu_torch.scene.loader import make_transform
from pathtracing_tpu_torch.scene.types import (
    Camera,
    DirectionalLight,
    Scene,
    Subframe,
    TlasInstance,
)
from pathtracing_tpu_torch.utils.hostmath import extract_m4m3, rotation_euler

f32 = np.float32


class SceneBuilder:
    def __init__(self):
        self.scene = Scene()
        self._camera: Camera | None = None
        self._light: DirectionalLight | None = None
        # host seconds per stage: load and blas summed over add_mesh, tlas,
        # binary_pack and wide_pack of the last build
        self.seconds: dict[str, float] = {}

    def _lap(self, stage: str, t0: float) -> float:
        now = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + now - t0
        return now

    def add_mesh(self, name: str, obj_path: str) -> None:
        t0 = time.perf_counter()
        m = load_mesh(self.scene.mesh_buf, obj_path)
        t0 = self._lap("load", t0)
        blas = build_blas(m, self.scene.mesh_buf.arrays(), self.scene.bvh_buf)
        self._lap("blas", t0)
        self.scene.meshes[name] = (m, blas)

    def add_instance(
        self,
        name: str,
        pos=(0, 0, 0),
        pitch_yaw_roll=(0, 0, 0),
        scale=(1, 1, 1),
        transform: np.ndarray | None = None,
    ) -> None:
        if transform is None:
            transform = make_transform(pos, pitch_yaw_roll, scale)
        m, blas = self.scene.meshes[name]
        self.scene.instances.append(TlasInstance.create(blas, m, transform))

    def set_camera(
        self,
        position,
        pitch_yaw_roll=(0, 0, 0),
        fov: float = 60.0,
        focal_distance: float = 2.0,
        aperture_radius: float = 0.0,
        aperture_polygon: int = 6,
        aperture_angle: float = float(np.pi / 16),
        aspect_ratio: float | None = None,
    ) -> None:
        self._camera = Camera(
            orientation=extract_m4m3(
                rotation_euler(
                    (np.asarray(pitch_yaw_roll, f32) * f32(np.pi) / f32(180.0)).astype(f32)
                )
            ),
            position=np.asarray(position, f32),
            aspect_ratio=aspect_ratio if aspect_ratio is not None else 16 / 9,
            inv_focal_length=float(f32(np.tan(f32(fov * np.pi / 360.0)))),
            focal_distance=focal_distance,
            aperture_angle=aperture_angle,
            aperture_polygon=aperture_polygon,
            aperture_radius=aperture_radius,
        )

    def set_light(
        self, direction, color=(4, 4, 4), solid_angle_deg: float = 4.0
    ) -> None:
        d = np.asarray(direction, f32)
        d = (d / f32(np.sqrt(np.dot(d, d)))).astype(f32)
        self._light = DirectionalLight(
            direction=d,
            color=np.asarray(color, f32),
            cos_solid_angle=float(
                f32(np.cos(f32(solid_angle_deg * np.pi / 180.0)))
            ),
        )

    def build(self, config: RenderConfig = TESTING, emissive_nee: bool = False,
              wide: bool | None = None, device=None):
        """Builds the TLAS + subframes and returns (Scene, SceneDevice).

        ``device=None`` means CUDA and raises when there is none;
        ``device="cpu"`` packs on the CPU. wide=None attaches the wide-BVH
        mega-table (the megakernel's tables) when the device is CUDA;
        True/False force it. emissive_nee=True also packs the area-light
        NEE tables (ops/arealights.py), as the JAX package's does."""
        device = resolve_device(device)
        s = self.scene
        if not s.instances:
            raise ValueError("no instances added")
        if self._camera is None:
            raise ValueError("set_camera was not called")
        if self._light is None:
            self.set_light((0, 1, 1))

        cam = self._camera
        if cam.aspect_ratio == 16 / 9:
            cam = Camera(**{**cam.__dict__, "aspect_ratio": config.image_width / float(config.image_height)})

        for stage in ("tlas", "binary_pack", "wide_pack"):
            self.seconds.pop(stage, None)
        t0 = time.perf_counter()
        tlas = build_tlas(
            s.instances,
            list(range(len(s.instances))),
            s.bvh_buf.nodes,
            s.bvh_buf,
        )
        s.subframes = [
            Subframe(tlas, cam, self._light)
            for _ in range(config.subframe_count)
        ]
        s.static_instance_count = len(s.instances)
        t0 = self._lap("tlas", t0)
        args = (s.mesh_buf.arrays(), s.bvh_buf.nodes, s.bvh_buf.links, s.instances,
                s.subframes)
        scene_device = pack_scene(*args, emissive_nee=emissive_nee, device=device)
        t0 = self._lap("binary_pack", t0)
        if wide is None:
            wide = device.type == "cuda"
        if wide:
            scene_device = attach_wide(scene_device, *args)
            self._lap("wide_pack", t0)
        return s, scene_device


def rebuild_static_tlas(scene, config: RenderConfig, cam=None, light=None, device=None):
    """Re-pack a builder-produced static scene after editing its instances
    (moved/added/removed): truncates the TLAS region of the shared BVH
    buffers (the builder appends the TLAS after all BLASes — the reference's
    pop_bvh, bvh.cc:286-292), rebuilds one TLAS over ``scene.instances``,
    and returns a fresh SceneDevice (binary tables) on ``device`` (None:
    CUDA, raising when there is none). Camera/light default to the scene's
    current subframe values.
    """
    device = resolve_device(device)
    cam = cam or scene.subframes[0].cam
    light = light or scene.subframes[0].light
    blas_len = scene.subframes[0].tlas.node_offset
    scene.bvh_buf.nodes = scene.bvh_buf.nodes[:blas_len]
    scene.bvh_buf.links = scene.bvh_buf.links[: 8 * blas_len]
    tlas = build_tlas(
        scene.instances,
        list(range(len(scene.instances))),
        scene.bvh_buf.nodes,
        scene.bvh_buf,
    )
    scene.subframes = [
        Subframe(tlas, cam, light) for _ in range(config.subframe_count)
    ]
    return pack_scene(
        scene.mesh_buf.arrays(),
        scene.bvh_buf.nodes,
        scene.bvh_buf.links,
        scene.instances,
        scene.subframes,
        device=device,
    )
