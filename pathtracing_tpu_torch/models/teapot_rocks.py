"""Teapot + five rocks on a ground slab — the golden-test scene family.

Mirrors the layout of the oracle golden scene (tools/oracle/harness.cc
build_golden_scene / tests/golden_scene.build_golden_scene_host) but built
through the public SceneBuilder, from the reference's meshes (``teapot``,
``rock0``..``rock4`` in ``data_dir`` or ``$PT_DATA_DIR``; stand-ins from
``scene/standins.write_standins`` serve too).
"""

from __future__ import annotations

import os
import tempfile

from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.models import _register
from pathtracing_tpu_torch.scene.builder import SceneBuilder
from pathtracing_tpu_torch.scene.loader import data_dir_or_env


def write_ground_obj(path: str, half: float = 60.0) -> None:
    with open(path, "w") as f:
        f.write("mtllib tr_ground.mtl\nusemtl g\n")
        for x, z in ((-half, -half), (half, -half), (half, half), (-half, half)):
            f.write(f"v {x} 0 {z}\n")
        f.write("vn 0 1 0\n")
        f.write("f 1//1 2//1 3//1\nf 1//1 3//1 4//1\n")
    with open(os.path.join(os.path.dirname(path), "tr_ground.mtl"), "w") as f:
        f.write("newmtl g\nKd 0.35 0.4 0.3\nPr 0.85\nPm 0.0\n")


@_register("teapot_rocks")
def build(
    config: RenderConfig = TESTING,
    data_dir: str | None = None,
    asset_dir: str | None = None,
    wide: bool | None = None,
    device=None,
):
    """Returns (Scene, SceneDevice) on ``device`` (None: CUDA); ``wide`` as
    in ``SceneBuilder.build`` (None: the wide tables on a CUDA device)."""
    data_dir = data_dir_or_env(data_dir)
    asset_dir = asset_dir or tempfile.mkdtemp(prefix="teapot_rocks_")
    ground_path = os.path.join(asset_dir, "tr_ground.obj")
    if not os.path.exists(ground_path):
        write_ground_obj(ground_path)

    b = SceneBuilder()
    b.add_mesh("ground", ground_path)
    b.add_mesh("teapot", os.path.join(data_dir, "teapot.obj"))
    for i in range(5):
        b.add_mesh(f"rock{i}", os.path.join(data_dir, f"rock{i}.obj"))
    b.add_instance("ground")
    b.add_instance("teapot", pos=(0, 0, 0), pitch_yaw_roll=(0, 25, 0))
    rocks = [
        ((6.5, 0, -4.0), 55.0, 1.0),
        ((-5.5, 0, -6.0), 120.0, 1.4),
        ((-7.0, 0, 3.5), 200.0, 0.9),
        ((4.5, 0, 6.0), 310.0, 1.1),
        ((9.0, 0, 2.0), 20.0, 0.7),
    ]
    for i, (pos, yaw, s) in enumerate(rocks):
        b.add_instance(
            f"rock{i}", pos=pos, pitch_yaw_roll=(0, yaw, 0), scale=(s, s, s)
        )
    b.set_camera(
        position=(0, 6.5, 16.0), pitch_yaw_roll=(16, 0, 0), fov=55
    )
    b.set_light(direction=(0.4, 1.0, 0.3), color=(4, 4, 4))
    return b.build(config, wide=wide, device=device)
