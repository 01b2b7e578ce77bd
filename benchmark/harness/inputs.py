"""The benchmark's inputs: the OBJ and MTL files both the program and the
plain reference read.

The reference renderer's animated scene reads 18 meshes; three of the
reference's own (terrain, bunny, pine tree) were never published with it,
so the scene is rendered from stand-ins: a generated heightfield terrain
with a water plane, pine-like trees for the five tree meshes and a
bunny-sized blob for every other mesh, each with smooth vertex normals and
"f a//a" faces. The Cornell box is the classic box with an emissive
ceiling panel. The writers are frozen here, so that the inputs of a cell
stay the same bytes whatever the program does later.

    write_animation_meshes(dir)   # 18 OBJ files + their MTL files
    write_cornell(dir)            # cornell.obj + cornell.mtl
"""

from __future__ import annotations

import os

import numpy as np

f32 = np.float32

# the animated scene's meshes, in the order the scene loads them
# (reference: scene.cc:139-182)
MESH_ORDER = (
    "terrain", "leaf_tree", "maple_tree", "pine_tree", "tropical_tree",
    "willow_tree", "rock0", "rock1", "rock2", "rock3", "rock4", "armadillo",
    "buddha", "bunny", "dragon", "teapot", "end", "logo",
)
TREES = ("leaf_tree", "maple_tree", "pine_tree", "tropical_tree", "willow_tree")


def _height(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Deterministic terrain shaped to the animation's implied landmarks
    (the hard-coded camera/creature track, reference: scene.cc:319-627):
    a ~30-unit mountain under the buddha statue (-39, 30, 40), a ~13-unit
    plateau under the teapot start (40, 14, 14), mid hills on the armadillo
    path (~35, 10, 52), low coast for the dragon walk (x < -70) and the
    bunny beach (~43, 5, -84). Gradients span -10..28
    (reference: scene.cc:141-152)."""

    def bump(cx, cz, r, a):
        return a * np.exp(-(((x - cx) ** 2 + (z - cz) ** 2) / (r * r)))

    base = (
        2.5 * np.sin(x * 0.045 + 1.7) * np.cos(z * 0.039 - 0.6)
        + 1.5 * np.sin(x * 0.11 - 0.9) * np.sin(z * 0.13 + 2.2)
        + 1.0 * np.cos(x * 0.23 + z * 0.19)
        + 2.0
    )
    h = (
        base
        + bump(-39, 40, 30, 26.5)   # buddha mountain
        + bump(46, 16, 20, 11.0)    # teapot plateau
        + bump(32, 56, 16, 6.0)     # armadillo hills
        + bump(-20, -35, 50, 7.0)   # central highland
        + bump(70, 85, 40, 12.0)    # far corner ridge
        + bump(-60, -90, 45, 10.0)
        + bump(43, -84, 30, 2.0)    # bunny beach shelf
        + bump(-78, 48, 22, 5.0)    # dragon walk shelf
        - bump(-95, 80, 28, 9.0)    # dragon coast water
        - bump(95, -25, 40, 8.0)    # eastern bay
    )
    return h.astype(f32)


WATER_LEVEL = -1.5


def write_terrain_obj(path: str, n: int = 160, extent: float = 130.0) -> None:
    xs = np.linspace(-extent, extent, n, dtype=f32)
    zs = np.linspace(-extent, extent, n, dtype=f32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = _height(X, Z)

    lines = ["mtllib terrain.mtl"]
    for i in range(n):
        for j in range(n):
            lines.append(f"v {X[i,j]:.4f} {Y[i,j]:.4f} {Z[i,j]:.4f}")
    # per-vertex normals from central differences
    gx = np.gradient(Y, xs, axis=0)
    gz = np.gradient(Y, zs, axis=1)
    ln = np.sqrt(gx * gx + 1.0 + gz * gz)
    for i in range(n):
        for j in range(n):
            lines.append(
                f"vn {-gx[i,j]/ln[i,j]:.4f} {1.0/ln[i,j]:.4f} {-gz[i,j]/ln[i,j]:.4f}"
            )
    lines.append("usemtl ground")
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j + 1
            b = (i + 1) * n + j + 1
            c = (i + 1) * n + j + 2
            d = i * n + j + 2
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
            lines.append(f"f {a}//{a} {c}//{c} {d}//{d}")

    # water plane at WATER_LEVEL (transmissive => material.z != 0)
    base = n * n
    w = extent
    for k, (px, pz) in enumerate(
        [(-w, -w), (w, -w), (w, w), (-w, w)]
    ):
        lines.append(f"v {px:.1f} {WATER_LEVEL} {pz:.1f}")
    base_n = n * n
    lines.append("vn 0 1 0")
    wn = base_n + 1
    lines.append("usemtl water")
    lines.append(f"f {base+1}//{wn} {base+2}//{wn} {base+3}//{wn}")
    lines.append(f"f {base+1}//{wn} {base+3}//{wn} {base+4}//{wn}")

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(os.path.dirname(path), "terrain.mtl"), "w") as f:
        f.write(
            "newmtl ground\nKd 0.5 0.5 0.5\nPr 1.0\nPm 0.0\n"
            "newmtl water\nKd 0.2 0.35 0.45\nPr 0.05\nPm 0.0\nTf 0.9 0.95 1.0\n"
        )


def _uv_sphere(cx, cy, cz, rx, ry, rz, nu=12, nv=8):
    verts = []
    faces = []
    for i in range(nv + 1):
        theta = np.pi * i / nv
        for j in range(nu):
            phi = 2 * np.pi * j / nu
            verts.append(
                (
                    cx + rx * np.sin(theta) * np.cos(phi),
                    cy + ry * np.cos(theta),
                    cz + rz * np.sin(theta) * np.sin(phi),
                )
            )
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            c = (i + 1) * nu + (j + 1) % nu
            d = (i + 1) * nu + j
            faces.append((a, b, c))
            faces.append((a, c, d))
    return verts, faces


def _vertex_normals(verts, faces) -> np.ndarray:
    """Smooth unit normals of one part's vertices: the sum of the normals of
    the faces around each (their areas as weights), turned away from the
    part's centre; a vertex whose faces are all degenerate takes the
    direction from the centre."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    centre = v.mean(0)
    if np.sum(fn * (v[f].mean(1) - centre)) < 0:
        fn = -fn
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, f[:, k], fn)
    acc = np.where(np.linalg.norm(acc, axis=1, keepdims=True) > 1e-12, acc, v - centre)
    return acc / np.linalg.norm(acc, axis=1, keepdims=True)


def _write_obj(path, mtl_name, mtl_text, parts, normals=False):
    """parts: list of (material, verts, faces). ``normals=True`` also writes
    smooth vertex normals and faces as "f a//a b//b c//c", which every loader
    of the repo reads alike; the default writes the bare "f a b c" faces of
    the committed assets, which the native loader reads the reference's way
    (a corner's following numbers as its texture and normal indices)."""
    lines = [f"mtllib {mtl_name}"]
    offset = 0
    vchunks = []
    for material, verts, faces in parts:
        vchunks.append((material, verts, faces, offset))
        offset += len(verts)
    for _, verts, _, _ in vchunks:
        for v in verts:
            lines.append(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}")
    if normals:
        for _, verts, faces, _ in vchunks:
            for nv in _vertex_normals(verts, faces):
                lines.append(f"vn {nv[0]:.4f} {nv[1]:.4f} {nv[2]:.4f}")
    for material, verts, faces, off in vchunks:
        lines.append(f"usemtl {material}")
        for fidx in faces:
            a, b, c = (fidx[0] + off + 1, fidx[1] + off + 1, fidx[2] + off + 1)
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}" if normals else f"f {a} {b} {c}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(os.path.dirname(path), mtl_name), "w") as f:
        f.write(mtl_text)


def write_bunny_obj(path: str, normals: bool = False) -> None:
    """Bunny-scaled blob (~1.2 units tall like the Stanford bunny usage);
    ``normals`` as in ``_write_obj``."""
    body_v, body_f = _uv_sphere(0, 0.45, 0, 0.55, 0.45, 0.45, 16, 10)
    head_v, head_f = _uv_sphere(0.35, 0.85, 0, 0.3, 0.28, 0.28, 12, 8)
    ear1_v, ear1_f = _uv_sphere(0.32, 1.25, -0.12, 0.08, 0.3, 0.06, 8, 6)
    ear2_v, ear2_f = _uv_sphere(0.32, 1.25, 0.12, 0.08, 0.3, 0.06, 8, 6)
    _write_obj(
        path,
        "bunny.mtl",
        "newmtl fur\nKd 0.73 0.70 0.65\nPr 0.9\nPm 0.0\n",
        [
            ("fur", body_v, body_f),
            ("fur", head_v, head_f),
            ("fur", ear1_v, ear1_f),
            ("fur", ear2_v, ear2_f),
        ],
        normals,
    )


def _cone(cx, cy, cz, r, h, n=10):
    verts = [(cx, cy + h, cz)]
    for j in range(n):
        phi = 2 * np.pi * j / n
        verts.append((cx + r * np.cos(phi), cy, cz + r * np.sin(phi)))
    faces = []
    for j in range(n):
        faces.append((0, 1 + (j + 1) % n, 1 + j))
    return verts, faces


def _cylinder(cx, cy, cz, r, h, n=8):
    verts = []
    for j in range(n):
        phi = 2 * np.pi * j / n
        verts.append((cx + r * np.cos(phi), cy, cz + r * np.sin(phi)))
    for j in range(n):
        phi = 2 * np.pi * j / n
        verts.append((cx + r * np.cos(phi), cy + h, cz + r * np.sin(phi)))
    faces = []
    for j in range(n):
        a, b = j, (j + 1) % n
        faces.append((a, b, n + b))
        faces.append((a, n + b, n + a))
    return verts, faces


def write_pine_obj(path: str, normals: bool = False) -> None:
    """Conical pine ~9 units tall (tree meshes are ~8-10 units); ``normals``
    as in ``_write_obj``."""
    trunk_v, trunk_f = _cylinder(0, 0, 0, 0.35, 3.0)
    c1_v, c1_f = _cone(0, 2.0, 0, 2.6, 4.0)
    c2_v, c2_f = _cone(0, 4.2, 0, 2.0, 3.2)
    c3_v, c3_f = _cone(0, 6.2, 0, 1.3, 2.6)
    _write_obj(
        path,
        "pine_tree.mtl",
        "newmtl bark\nKd 0.30 0.20 0.12\nPr 1.0\n"
        "newmtl needles\nKd 0.08 0.22 0.10\nPr 1.0\n",
        [
            ("bark", trunk_v, trunk_f),
            ("needles", c1_v, c1_f),
            ("needles", c2_v, c2_f),
            ("needles", c3_v, c3_f),
        ],
        normals,
    )


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


def _done(data_dir, names) -> bool:
    return all(os.path.exists(os.path.join(data_dir, f"{n}.obj")) for n in names)


def write_animation_meshes(data_dir) -> str:
    """The 18 meshes of the animated scene in ``data_dir`` (written once:
    a folder that has them all is left as it is). Returns the folder."""
    data_dir = str(data_dir)
    if _done(data_dir, MESH_ORDER):
        return data_dir
    os.makedirs(data_dir, exist_ok=True)
    for name in MESH_ORDER:
        path = os.path.join(data_dir, f"{name}.obj")
        if name == "terrain":
            write_terrain_obj(path)
        elif name in TREES:
            write_pine_obj(path, normals=True)
        else:
            write_bunny_obj(path, normals=True)
    return data_dir


def write_cornell(data_dir) -> str:
    """cornell.obj and cornell.mtl in ``data_dir`` (written once). Returns
    the OBJ's path."""
    data_dir = str(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "cornell.obj")
    if not os.path.exists(path):
        write_cornell_obj(path)
    return path
