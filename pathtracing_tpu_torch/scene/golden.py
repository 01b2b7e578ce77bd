"""Golden test scene: a SceneDevice built directly from the oracle's dumps.

``scene.gold`` (written by tools/oracle/harness.cc) holds the flat mesh,
BVH, instance, camera and light buffers of the golden scene; ``motion.gold``
holds a variant with distinct subframes (moving teapot, moving sun; prefix
``mb_``). Building from the dump isolates device code from the host pipeline.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.accel.types import BvhHandle
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.io.obj import MeshHandle
from pathtracing_tpu_torch.scene.device import (
    SceneDevice,
    _instance_rows,
    pack_nl8,
    pack_scene,
    pack_tri_tables,
    pack_vattr,
    to_device,
)
from pathtracing_tpu_torch.scene.types import Camera, DirectionalLight, Subframe

f32 = np.float32


class _GoldenInstance:
    def __init__(self, fu, ff):
        self.blas = BvhHandle(node_count=int(fu[0]), node_offset=int(fu[1]))
        self.mesh = MeshHandle(
            vertex_count=int(fu[2]),
            triangle_count=int(fu[3]),
            index_offset=int(fu[4]),
            base_vertex_offset=int(fu[5]),
        )
        self.transform = ff[:16].reshape(4, 4).astype(f32)
        self.inv_transform = ff[16:32].reshape(4, 4).astype(f32)


def camera_from_golden(g) -> Camera:
    c = g["camera"]
    return Camera(
        orientation=c[0:9].reshape(3, 3),
        position=c[9:12],
        aspect_ratio=float(c[12]),
        inv_focal_length=float(c[13]),
        focal_distance=float(c[14]),
        aperture_angle=float(c[15]),
        aperture_polygon=int(c[16]),
        aperture_radius=float(c[17]),
    )


def light_from_golden(g) -> DirectionalLight:
    l = g["light"]
    return DirectionalLight(
        direction=l[0:3], color=l[3:6], cos_solid_angle=float(l[6])
    )


def scene_device_from_golden(g, config=TESTING, device=None) -> SceneDevice:
    """The golden scene with ``config.subframe_count`` identical subframes.

    Build it with the config it is rendered with: ``camera_sample`` indexes
    the subframe rows by ``sample_index // samples_per_motion_blur_step``.
    """
    instances = [
        _GoldenInstance(g["instances_u"][i], g["instances_f"][i])
        for i in range(len(g["instances_u"]))
    ]
    tlas = BvhHandle(node_count=int(g["tlas"][0]), node_offset=int(g["tlas"][1]))
    cam = camera_from_golden(g)
    light = light_from_golden(g)
    subframes = [Subframe(tlas, cam, light) for _ in range(config.subframe_count)]
    mesh_arrays = (
        g["indices"],
        g["pos"],
        g["normal"],
        g["albedo"],
        g["material"],
    )
    return pack_scene(
        mesh_arrays, g["nodes"], g["links"], instances, subframes, device=device
    )


def scene_device_from_motion_golden(g, device=None) -> SceneDevice:
    """Build a SceneDevice from the harness 'motion' dump (distinct
    subframes: moving teapot + moving sun; prefix mb_)."""
    device = resolve_device(device)
    instances = [
        _GoldenInstance(g["mb_instances_u"][i], g["mb_instances_f"][i])
        for i in range(len(g["mb_instances_u"]))
    ]
    inst_f, inst_u = _instance_rows(instances)
    segments = [(i.blas.node_offset, i.blas.node_count) for i in instances]
    segments += [(int(o), int(c)) for c, o in g["mb_sf_tlas"]]
    tri_pos, tri_idx = pack_tri_tables(
        g["mb_indices"], g["mb_pos"], [i.mesh for i in instances]
    )
    dev = lambda a: to_device(a, device)
    return SceneDevice(
        nl8=dev(pack_nl8(g["mb_nodes"], g["mb_links"], segments)),
        tri_pos=dev(tri_pos),
        tri_idx=dev(tri_idx),
        inst_f=dev(inst_f),
        inst_u=dev(inst_u),
        vattr=dev(pack_vattr(g["mb_normal"], g["mb_albedo"], g["mb_material"])),
        sf_tlas_count=dev(g["mb_sf_tlas"][:, 0].astype(np.int32)),
        sf_tlas_offset=dev(g["mb_sf_tlas"][:, 1].astype(np.int32)),
        sf_cam=dev(g["mb_sf_cam"]),
        sf_light=dev(g["mb_sf_light"]),
    )
