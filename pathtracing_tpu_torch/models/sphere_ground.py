"""Dense smooth sphere over a gray ground plane (procedural).

The pose-optimization scene: a UV sphere with exact radial per-vertex
normals and a smooth warm albedo, so both normal AND albedo interpolation
carry gradient signal when the instance moves (examples/inverse_pose.py).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.models import _register
from pathtracing_tpu_torch.scene.builder import SceneBuilder

f32 = np.float32


def write_sphere_obj(path: str, n_u: int = 48, n_v: int = 24) -> None:
    """Dense unit UV sphere with exact radial per-vertex normals."""
    vs = []
    for j in range(n_v + 1):
        theta = np.pi * j / n_v
        for i in range(n_u):
            phi = 2 * np.pi * i / n_u
            vs.append((
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            ))
    faces = []
    idx = lambda j, i: j * n_u + (i % n_u) + 1
    for j in range(n_v):
        for i in range(n_u):
            a, b = idx(j, i), idx(j, i + 1)
            c, d = idx(j + 1, i + 1), idx(j + 1, i)
            if j > 0:
                faces.append((a, b, c))
            if j < n_v - 1:
                faces.append((a, c, d))
    with open(path, "w") as f:
        f.write("mtllib sphere.mtl\nusemtl body\n")
        for v in vs:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for v in vs:  # normals are the positions (unit sphere)
            f.write(f"vn {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
    with open(os.path.join(os.path.dirname(path), "sphere.mtl"), "w") as f:
        f.write("newmtl body\nKd 0.75 0.45 0.25\nPr 0.45\nPm 0.0\n")


def write_ground_obj(path: str, half: float = 30.0) -> None:
    with open(path, "w") as f:
        f.write("mtllib ground.mtl\nusemtl g\n")
        for x, z in ((-half, -half), (half, -half), (half, half), (-half, half)):
            f.write(f"v {x} 0 {z}\n")
        f.write("vn 0 1 0\n")
        f.write("f 1//1 2//1 3//1\nf 1//1 3//1 4//1\n")
    with open(os.path.join(os.path.dirname(path), "ground.mtl"), "w") as f:
        f.write("newmtl g\nKd 0.55 0.55 0.55\nPr 0.9\nPm 0.0\n")


@_register("sphere_ground")
def build(
    config: RenderConfig = TESTING,
    sphere_pos=(0.0, 1.0, 0.0),
    asset_dir: str | None = None,
    wide: bool | None = None,
    device=None,
):
    """Returns (Scene, SceneDevice) on ``device`` (None: CUDA). The sphere is
    instance index 1."""
    asset_dir = asset_dir or tempfile.mkdtemp(prefix="sphere_ground_")
    sphere_path = os.path.join(asset_dir, "sphere.obj")
    ground_path = os.path.join(asset_dir, "ground.obj")
    if not os.path.exists(sphere_path):
        write_sphere_obj(sphere_path)
    if not os.path.exists(ground_path):
        write_ground_obj(ground_path)

    b = SceneBuilder()
    b.add_mesh("ground", ground_path)
    b.add_mesh("sphere", sphere_path)
    b.add_instance("ground")
    b.add_instance("sphere", pos=tuple(sphere_pos))
    b.set_camera(position=(0, 2.2, 6.0), pitch_yaw_roll=(10, 0, 0), fov=50)
    b.set_light(direction=(0.45, 1.0, 0.35), color=(4, 4, 4))
    return b.build(config, wide=wide, device=device)
