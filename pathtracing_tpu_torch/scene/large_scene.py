"""The large procedural scene: a scene at the reference's scale, built from
files by the port's own host pipeline (``SceneBuilder``).

The generated terrain at n x n vertices (``assets.write_terrain_obj``, its
water plane transmissive), plus ``INSTANCES`` placements (the reference's
OBJECT_COUNT, scene/loader.py), half pine, half bunny, at seeded
(x, _height(x, z), z) inside the terrain's extent with a seeded yaw; a
camera looking down onto the terrain and the sun of sphere_ground. The pine
and the bunny are written with vertex normals and slashed faces, which the
native loader reads as the Python one does (the committed substitutes' bare
faces load natively as slivers). At n = 512: 522,994 triangles; tables of
280 MB (binary) and 230 MB (w8), 5-6x an H100's 50 MB L2.

    from pathtracing_tpu_torch.scene import large_scene
    scene, dev, seconds = large_scene.build("build/large_scene", PRODUCTION)
"""

from __future__ import annotations

import os
import time

import numpy as np

from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.scene import assets
from pathtracing_tpu_torch.scene.builder import SceneBuilder

TERRAIN_N = 512
INSTANCES = 1024
SEED = 7
EXTENT = 130.0  # write_terrain_obj's default extent
CAMERA = {"position": (0.0, 90.0, 100.0), "pitch_yaw_roll": (55.0, 0.0, 0.0), "fov": 50.0}
SUN = {"direction": (0.45, 1.0, 0.35), "color": (4, 4, 4)}


def placements(count=INSTANCES, seed=SEED, extent=EXTENT):
    """[(mesh name, (x, y, z), yaw in degrees)] of the instances."""
    rs = np.random.default_rng(seed)
    xz = rs.uniform(-0.9 * extent, 0.9 * extent, (count, 2)).astype(np.float32)
    yaw = rs.uniform(0.0, 360.0, count).astype(np.float32)
    y = assets._height(xz[:, 0], xz[:, 1])
    return [("pine_tree" if i % 2 == 0 else "bunny",
             (float(xz[i, 0]), float(y[i]), float(xz[i, 1])), float(yaw[i]))
            for i in range(count)]


def write_files(asset_dir, n=TERRAIN_N) -> dict:
    """Writes the scene's OBJ files under ``asset_dir`` (the terrain unless
    it is there); returns name -> path."""
    os.makedirs(asset_dir, exist_ok=True)
    paths = {name: os.path.join(str(asset_dir), f"{name}.obj")
             for name in ("bunny", "pine_tree")}
    assets.write_bunny_obj(paths["bunny"], normals=True)
    assets.write_pine_obj(paths["pine_tree"], normals=True)
    paths["terrain"] = os.path.join(str(asset_dir), f"terrain_n{n}.obj")
    if not os.path.exists(paths["terrain"]):
        assets.write_terrain_obj(paths["terrain"], n=n)
    return paths


def describe(b, paths, places) -> None:
    """The scene through a SceneBuilder (either package's): meshes, the
    terrain instance, the placements, camera and sun."""
    for name in ("terrain", "pine_tree", "bunny"):
        b.add_mesh(name, paths[name])
    b.add_instance("terrain")
    for name, pos, yaw in places:
        b.add_instance(name, pos=pos, pitch_yaw_roll=(0.0, yaw, 0.0))
    b.set_camera(**CAMERA)
    b.set_light(**SUN)


def build(asset_dir, config: RenderConfig = TESTING, n=TERRAIN_N, count=INSTANCES,
          seed=SEED, wide: bool | None = None, device=None):
    """Writes, loads, builds and packs the scene -> (Scene, SceneDevice,
    {stage: host seconds}): write, then SceneBuilder's load, blas, tlas,
    binary_pack and wide_pack. ``wide`` and ``device`` as in
    ``SceneBuilder.build`` (None: CUDA, with the wide tables)."""
    t0 = time.perf_counter()
    paths = write_files(asset_dir, n)
    write = time.perf_counter() - t0
    b = SceneBuilder()
    describe(b, paths, placements(count, seed))
    s, dev = b.build(config, wide=wide, device=device)
    return s, dev, {"write": write, **b.seconds}
