"""OBJ/MTL loading into flat mesh buffers (reference: mesh.cc:110-265),
in plain Python: triangles only, per-vertex material baking, vertex dedup by
(pos, tex, normal, material) in first-seen order, the reference's emission
and transmission scalarization (mesh.cc:241-252).

  indices  (K,)  uint32 — 3 per triangle, relative to base_vertex_offset
  pos      (V,3) float32
  normal   (V,3) float32
  albedo   (V,4) float32 — xyz=RGB, w=alpha
  material (V,4) float32 — x=roughness y=metallic z=transmission w=emission
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

f32 = np.float32


@dataclasses.dataclass
class MeshHandle:
    """reference: mesh.hh:18-28."""

    vertex_count: int
    triangle_count: int
    index_offset: int
    base_vertex_offset: int


@dataclasses.dataclass
class MeshBuffers:
    """Shared append-only buffers for all meshes (reference: mesh.hh:32-44)."""

    indices: list = dataclasses.field(default_factory=list)
    pos: list = dataclasses.field(default_factory=list)
    normal: list = dataclasses.field(default_factory=list)
    albedo: list = dataclasses.field(default_factory=list)
    material: list = dataclasses.field(default_factory=list)

    def arrays(self):
        """Concatenate to flat numpy arrays."""
        return (
            np.concatenate(self.indices).astype(np.uint32)
            if self.indices
            else np.zeros((0,), np.uint32),
            _cat(self.pos, 3),
            _cat(self.normal, 3),
            _cat(self.albedo, 4),
            _cat(self.material, 4),
        )

    @property
    def index_count(self) -> int:
        return sum(len(i) for i in self.indices)

    @property
    def vertex_count(self) -> int:
        return sum(len(p) for p in self.pos)


def _cat(chunks, width):
    if not chunks:
        return np.zeros((0, width), f32)
    return np.concatenate(chunks).astype(f32).reshape(-1, width)


@dataclasses.dataclass
class _MtlMaterial:
    """Defaults per reference: mesh.cc:10-19."""

    name: str = ""
    albedo: tuple = (1.0, 1.0, 1.0)
    alpha: float = 0.0
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 1.0
    metallicness: float = 0.0
    transmission: tuple = (0.0, 0.0, 0.0)


def _parse_floats(parts, n):
    vals = [f32(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(f32(0))
    return vals


def load_mtl(materials: list, mtl_file: str) -> None:
    """reference: mesh.cc:56-108."""
    with open(mtl_file, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    mat = None
    for line in text.split("\n"):
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "newmtl":
            mat = _MtlMaterial(name=parts[1] if len(parts) > 1 else "")
            materials.append(mat)
        elif mat is None:
            continue
        elif cmd == "Kd":
            mat.albedo = tuple(_parse_floats(parts[1:], 3))
        elif cmd == "Ke":
            mat.emission = tuple(_parse_floats(parts[1:], 3))
        elif cmd == "d":
            mat.alpha = _parse_floats(parts[1:], 1)[0]
        elif cmd == "Pr":
            mat.roughness = _parse_floats(parts[1:], 1)[0]
        elif cmd == "Pm":
            mat.metallicness = _parse_floats(parts[1:], 1)[0]
        elif cmd == "Tf":
            mat.transmission = tuple(_parse_floats(parts[1:], 3))


def _bake_material(mat: _MtlMaterial):
    """Albedo/material vertex attributes (reference: mesh.cc:234-253)."""
    albedo = np.array(
        [mat.albedo[0], mat.albedo[1], mat.albedo[2], mat.alpha], f32
    )
    emission = np.array(mat.emission, f32)
    alb3 = np.array(mat.albedo, f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        scaled = emission / np.maximum(alb3, emission)
    scaled = np.fmax(scaled, f32(0))  # fmax: NaN -> 0 like C fmax
    scaled[emission == 0] = 0
    tf = np.array(mat.transmission, f32)
    material = np.array(
        [mat.roughness, mat.metallicness, tf.max(), f32(scaled.max())], f32
    )
    return albedo, material


def _parse_face_vertex(token: str):
    """One 'p/t/n' group; missing entries become -1 (strtol 0 - 1)."""
    p, t, n = -1, -1, -1
    parts = token.split("/")
    if len(parts) >= 1 and parts[0]:
        p = int(parts[0]) - 1
    if len(parts) >= 2 and parts[1]:
        t = int(parts[1]) - 1
    if len(parts) >= 3 and parts[2]:
        n = int(parts[2]) - 1
    return p, t, n


def load_mesh(mb: MeshBuffers, obj_file: str) -> MeshHandle:
    index_offset = mb.index_count
    base_vertex_offset = mb.vertex_count

    positions: list = []
    normals: list = []
    materials: list = [_MtlMaterial()]  # default material at index 0
    face_groups: list = []  # (pos_idx, tex_idx, normal_idx, material_idx)

    prefix = os.path.dirname(obj_file)
    active_material = 0

    with open(obj_file, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")

    for line in text.split("\n"):
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0]
        if cmd == "v":
            positions.append(_parse_floats(parts[1:], 3))
        elif cmd == "vn":
            n = np.array(_parse_floats(parts[1:], 3), f32)
            # normalize with C's exact op order: sqrt(x*x + y*y + z*z) then
            # per-component division (reference: math.hh:94,106,110).
            length = f32(np.sqrt(f32(f32(n[0] * n[0] + n[1] * n[1]) + n[2] * n[2])))
            normals.append((n / length).astype(f32))
        elif cmd == "vt":
            pass  # parsed for dedup keys only; texcoords unused downstream
        elif cmd == "f":
            # The reference reads exactly 3 face vertices and ignores the
            # rest of the line (mesh.cc:185-198) — replicate, no fan split.
            for tok in parts[1:4]:
                p, t, n = _parse_face_vertex(tok)
                face_groups.append((p, t, n, active_material))
        elif cmd == "usemtl":
            name = parts[1] if len(parts) > 1 else ""
            for i, m in enumerate(materials):
                if m.name == name:
                    active_material = i
                    break
        elif cmd == "mtllib" and len(parts) > 1:
            load_mtl(materials, os.path.join(prefix, parts[1]))

    positions_np = np.array(positions, f32) if positions else np.zeros((0, 3), f32)
    normals_np = np.stack(normals).astype(f32) if normals else np.zeros((0, 3), f32)

    baked = [_bake_material(m) for m in materials]

    # Vertex dedup in first-seen order (reference: mesh.cc:218-262).
    ig_to_index: dict = {}
    out_indices = np.empty(len(face_groups), np.uint32)
    out_pos: list = []
    out_normal: list = []
    out_albedo: list = []
    out_material: list = []
    zero3 = np.zeros(3, f32)
    zero4 = np.zeros(4, f32)
    for i, ig in enumerate(face_groups):
        idx = ig_to_index.get(ig)
        if idx is None:
            idx = len(ig_to_index)
            ig_to_index[ig] = idx
            p, t, n, mi = ig
            out_pos.append(
                positions_np[p] if 0 <= p < len(positions_np) else zero3
            )
            out_normal.append(
                normals_np[n] if 0 <= n < len(normals_np) else zero3
            )
            if 0 <= mi < len(baked):
                out_albedo.append(baked[mi][0])
                out_material.append(baked[mi][1])
            else:
                out_albedo.append(zero4)
                out_material.append(zero4)
        out_indices[i] = idx

    mb.indices.append(out_indices)
    mb.pos.append(np.array(out_pos, f32).reshape(-1, 3))
    mb.normal.append(np.array(out_normal, f32).reshape(-1, 3))
    mb.albedo.append(np.array(out_albedo, f32).reshape(-1, 4))
    mb.material.append(np.array(out_material, f32).reshape(-1, 4))

    return MeshHandle(
        vertex_count=len(ig_to_index),
        triangle_count=len(face_groups) // 3,
        index_offset=index_offset,
        base_vertex_offset=base_vertex_offset,
    )
