"""Procedural Cornell box with an emissive ceiling panel.

Exercises the EMISSIVE-SURFACE light path with no sun and no sky: the
material baking turns ``Ke`` into a per-vertex emission scalar
(emission = max component of Ke / max(Kd, Ke), reference: mesh.cc:241-252)
and the integrator adds ``albedo x emission`` at every hit — so an emitter
with Kd = Ke = L radiates L via BSDF sampling alone (the reference's NEE
targets only the directional sun, which this scene sets to black).

Geometry is the classic box: 2x2x2 interior, red left / green right wall,
two rotated blocks, a ceiling light panel. Camera looks down -z through
the open front face.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.models import _register
from pathtracing_tpu_torch.scene.builder import SceneBuilder

f32 = np.float32

_MTL = """newmtl white
Kd 0.73 0.73 0.73
Pr 1.0
newmtl red
Kd 0.65 0.05 0.05
Pr 1.0
newmtl green
Kd 0.12 0.45 0.15
Pr 1.0
newmtl light
Kd 17 12 4
Ke 17 12 4
Pr 1.0
"""


class _ObjWriter:
    def __init__(self, f):
        self.f = f
        self.nv = 0
        self.nn = 0

    def quad(self, v0, v1, v2, v3, n):
        """Two triangles, one shared face normal, CCW as passed."""
        for v in (v0, v1, v2, v3):
            self.f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        self.f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        self.nn += 1
        a = self.nv + 1
        k = self.nn
        self.f.write(f"f {a}//{k} {a+1}//{k} {a+2}//{k}\n")
        self.f.write(f"f {a}//{k} {a+2}//{k} {a+3}//{k}\n")
        self.nv += 4

    def block(self, cx, cz, w, h, d, angle_deg):
        """Axis-aligned box of size (w, h, d) sitting on y=0, rotated by
        angle about +y, centered at (cx, cz)."""
        ca, sa = np.cos(np.radians(angle_deg)), np.sin(np.radians(angle_deg))

        def rot(p):
            x, y, z = p
            return (cx + ca * x + sa * z, y, cz - sa * x + ca * z)

        hw, hd = w / 2, d / 2
        corners = {
            (sx, sy, sz): rot((sx * hw, (sy + 1) / 2 * h, sz * hd))
            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
        }
        c = corners
        rn = lambda n: (ca * n[0] + sa * n[2], n[1], -sa * n[0] + ca * n[2])
        # outward faces (viewed from outside, CCW)
        self.quad(c[(-1, 1, 1)], c[(1, 1, 1)], c[(1, 1, -1)], c[(-1, 1, -1)], rn((0, 1, 0)))
        self.quad(c[(-1, -1, -1)], c[(1, -1, -1)], c[(1, 1, -1)], c[(-1, 1, -1)], rn((0, 0, -1)))
        self.quad(c[(-1, -1, 1)], c[(1, -1, 1)], c[(1, 1, 1)], c[(-1, 1, 1)], rn((0, 0, 1)))
        self.quad(c[(-1, -1, -1)], c[(-1, -1, 1)], c[(-1, 1, 1)], c[(-1, 1, -1)], rn((-1, 0, 0)))
        self.quad(c[(1, -1, 1)], c[(1, -1, -1)], c[(1, 1, -1)], c[(1, 1, 1)], rn((1, 0, 0)))


def write_cornell_obj(path: str) -> None:
    with open(path, "w") as f:
        f.write("mtllib cornell.mtl\n")
        w = _ObjWriter(f)
        f.write("usemtl white\n")
        # floor (y=0, normal up), ceiling (y=2, normal down), back (z=-1)
        w.quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1), (0, 1, 0))
        w.quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), (0, -1, 0))
        w.quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), (0, 0, 1))
        # blocks: tall left-back, short right-front
        w.block(-0.35, -0.35, 0.6, 1.2, 0.6, 16.5)
        w.block(0.37, 0.32, 0.6, 0.6, 0.6, -18.0)
        f.write("usemtl red\n")
        w.quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (1, 0, 0))
        f.write("usemtl green\n")
        w.quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1), (-1, 0, 0))
        f.write("usemtl light\n")
        w.quad(
            (-0.25, 1.998, 0.25), (0.25, 1.998, 0.25),
            (0.25, 1.998, -0.25), (-0.25, 1.998, -0.25), (0, -1, 0),
        )
    with open(os.path.join(os.path.dirname(path), "cornell.mtl"), "w") as f:
        f.write(_MTL)


@_register("cornell_box")
def build(
    config: RenderConfig = TESTING,
    asset_dir: str | None = None,
    emissive_nee: bool = True,
    wide: bool | None = None,
    device=None,
):
    """Returns (Scene, SceneDevice) on ``device`` (None: CUDA).
    emissive_nee=True (default) asks for the area-light tables so the
    integrator importance-samples the ceiling panel
    (ops/arealights.py). False gives the reference-style BSDF-only estimator (identical mean, far
    higher variance)."""
    asset_dir = asset_dir or tempfile.mkdtemp(prefix="cornell_")
    obj_path = os.path.join(asset_dir, "cornell.obj")
    if not os.path.exists(obj_path):
        write_cornell_obj(obj_path)
    b = SceneBuilder()
    b.add_mesh("cornell", obj_path)
    b.add_instance("cornell")
    b.set_camera(position=(0, 1.0, 3.6), pitch_yaw_roll=(0, 0, 0), fov=40)
    # no sun: the ceiling panel is the only light (sky goes black too —
    # both the in-scatter and the sun-disk miss shading scale by the color)
    b.set_light(direction=(0, 1, 0), color=(0, 0, 0))
    return b.build(config, emissive_nee=emissive_nee, wide=wide, device=device)
