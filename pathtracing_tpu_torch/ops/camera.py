"""Thin-lens camera ray generation (reference: path_tracer.hh:429-450)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.ops.samplers import sample_regular_polygon
from pathtracing_tpu_torch.utils.vec import Mat3, Vec2, Vec3, normalize3, where2

Array = Any


class CameraParams(NamedTuple):
    """Per-ray camera parameters (gathered from the subframe table)."""

    orientation: Mat3
    position: Vec3
    aspect_ratio: Array
    inv_focal_length: Array
    focal_distance: Array
    aperture_angle: Array
    aperture_polygon: Array  # float
    aperture_radius: Array


def camera_from_table(sf_cam: Array, idx: Array) -> CameraParams:
    """Gather per-ray camera rows from the (S,18) subframe table."""
    c = sf_cam[idx]  # (R, 18)
    return CameraParams(
        orientation=Mat3(
            Vec3(c[:, 0], c[:, 1], c[:, 2]),
            Vec3(c[:, 3], c[:, 4], c[:, 5]),
            Vec3(c[:, 6], c[:, 7], c[:, 8]),
        ),
        position=Vec3(c[:, 9], c[:, 10], c[:, 11]),
        aspect_ratio=c[:, 12],
        inv_focal_length=c[:, 13],
        focal_distance=c[:, 14],
        aperture_angle=c[:, 15],
        aperture_polygon=c[:, 16],
        aperture_radius=c[:, 17],
    )


def get_camera_ray(
    cam: CameraParams,
    u: Vec2,
    coord: Vec2,
    image_width: int,
    image_height: int,
):
    """Returns (dir Vec3, origin Vec3) in world space
    (reference: path_tracer.hh:429-450)."""
    uv = Vec2(
        coord.x / image_width * 2.0 - 1.0,
        coord.y / image_height * 2.0 - 1.0,
    )
    uv = Vec2(uv.x * cam.aspect_ratio, -uv.y)

    poly = sample_regular_polygon(u, cam.aperture_angle, cam.aperture_polygon)
    zero = torch.zeros_like(uv.x)
    aperture = where2(
        cam.aperture_polygon > 3,
        poly * cam.aperture_radius,
        Vec2(zero, zero),
    )

    origin = Vec3(aperture.x, aperture.y, zero)
    d = Vec3(
        uv.x * cam.inv_focal_length,
        uv.y * cam.inv_focal_length,
        torch.full_like(uv.x, -1.0),
    ) * cam.focal_distance
    d = normalize3(d - origin)

    d = cam.orientation.mul_vec(d)  # mul_m3v3(orientation, dir)
    origin = cam.orientation.mul_vec(origin) + cam.position
    return d, origin
