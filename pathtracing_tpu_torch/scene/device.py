"""Device-resident scene: row-gatherable tables as a NamedTuple of tensors.

The reference passes raw pointers to flattened buffers into the kernel
(reference: main.cc:26-38, path_tracer.hh:306-319). Here every hot lookup is
packed into one row, so a ray-query step or a shading fetch reads whole rows
(the CUDA ray query reads them as 16-byte vectors):

  nl8     (8N, 8)  node AABB + {accept, cancel} fused per (octant, node),
                   indexed by the link index (reference layout bvh.cc:217-226)
  tri_pos (T, 12)  triangle vertex positions by global triangle id
  inst_f  (I, 21)  inv_transform columns (12) + rotation rows (9)
  inst_u  (I, 6)   blas count/offset, index_offset, base_vertex, tri_offset
  vattr   (V, 12)  normal(3) + albedo(4) + material(4) + pad
  sf_*    (S, _)   per-subframe TLAS handle, camera, light rows

The packers are numpy on the host and produce the same bytes as the JAX
package's; only the upload differs. ``nl8[:, 6:8]`` hold int32 link bit
patterns (small ids are subnormals, some patterns are NaNs): they are copied
and bit-viewed, never sent through a float op.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device

Array = Any
f32 = np.float32


class SceneDevice(NamedTuple):
    nl8: Array        # (8N, 8) f32; cols 6,7 are int32 bit patterns
    tri_pos: Array    # (T, 12) f32
    tri_idx: Array    # (T, 4) int32 — absolute vertex ids [i0,i1,i2,pad]
    inst_f: Array     # (I, 21) f32
    inst_u: Array     # (I, 6) int32
    vattr: Array      # (V, 12) f32
    sf_tlas_count: Array  # (S,) int32
    sf_tlas_offset: Array
    sf_cam: Array     # (S, 18) f32
    sf_light: Array   # (S, 7) f32
    # Fields of the JAX package's SceneDevice that later slices of the port
    # fill (bf16 node rows, wide-BVH mega-table, packed shading rows,
    # emissive-light tables, hot rows). They stay None here, and the code of
    # this slice raises NotImplementedError when one is set.
    nl5: Array | None = None
    wide_rows: Array | None = None
    wide_root: Array | None = None
    wide_root_base: Array | None = None
    tri_shade: Array | None = None
    lt_tris: Array | None = None
    lt_rows: Array | None = None
    lt_cdf: Array | None = None
    lt_seg: Array | None = None
    lt_rank: Array | None = None
    hot_rows: Array | None = None
    hot_planes: Array | None = None


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Upload a host table bit-exactly (a byte copy, no float op). Always a
    copy: the tensor never aliases the caller's (maybe read-only) array."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _instance_rows(instances, pad_to: int = 1):
    I = max(len(instances), pad_to, 1)
    inst_f = np.zeros((I, 21), f32)
    inst_u = np.zeros((I, 6), np.int32)
    for i, inst in enumerate(instances):
        inv = inst.inv_transform.astype(f32)
        # columns 0..2 of all 4 rows (used by mul_m4v4/mul_m3v3 forms,
        # reference: ray_query.hh:159-165)
        inst_f[i, 0:12] = inv[:, 0:3].reshape(-1)
        inst_f[i, 12:21] = inst.transform[:3, :3].astype(f32).reshape(-1)
        inst_u[i, 0:5] = (
            inst.blas.node_count,
            inst.blas.node_offset,
            inst.mesh.index_offset,
            inst.mesh.base_vertex_offset,
            inst.mesh.index_offset // 3,
        )
    return inst_f, inst_u


def pack_nl8(bvh_nodes, bvh_links, segments) -> np.ndarray:
    """Fused node+link rows for every traversable BVH segment.

    segments: iterable of (node_offset, node_count). Rows of BVHs that are
    never traversed are left zero (never read).
    """
    nodes = bvh_nodes.astype(f32)
    links_bits = np.ascontiguousarray(bvh_links, np.uint32).view(f32)
    out = np.zeros((8 * len(nodes), 8), f32)
    seen = set()
    for offset, count in segments:
        if count == 0 or (offset, count) in seen:
            continue
        seen.add((offset, count))
        block = slice(8 * offset, 8 * offset + 8 * count)
        out[block, 0:6] = np.tile(nodes[offset : offset + count], (8, 1))
        out[block, 6:8] = links_bits[block]
    return out


def pack_tri_tables(indices, pos, meshes):
    """(T, 12) packed triangle vertices + (T, 4) absolute vertex ids,
    both in global triangle order (index_offset/3 + prim).

    meshes: iterable of MeshHandle covering the triangles that can be hit.
    """
    t_total = max(len(indices) // 3, 1)
    out_pos = np.zeros((t_total, 12), f32)
    out_idx = np.zeros((t_total, 4), np.int32)
    seen = set()
    for m in meshes:
        key = (m.index_offset, m.triangle_count)
        if m.triangle_count == 0 or key in seen:
            continue
        seen.add(key)
        tri = indices[
            m.index_offset : m.index_offset + 3 * m.triangle_count
        ].reshape(-1, 3).astype(np.int64) + m.base_vertex_offset
        p = pos[tri]  # (t, 3, 3)
        t0 = m.index_offset // 3
        out_pos[t0 : t0 + m.triangle_count, 0:9] = p.reshape(-1, 9)
        out_idx[t0 : t0 + m.triangle_count, 0:3] = tri
    return out_pos, out_idx


def pack_vattr(normal, albedo, material) -> np.ndarray:
    v = max(len(normal), 1)
    out = np.zeros((v, 12), f32)
    if len(normal):
        out[:, 0:3] = normal
        out[:, 3:7] = albedo
        out[:, 7:11] = material
    return out


def pack_scene(
    mesh_arrays,
    bvh_nodes: np.ndarray,
    bvh_links: np.ndarray,
    instances,
    subframes,
    emissive_nee: bool = False,
    wide: bool = False,
    device=None,
) -> SceneDevice:
    """Pack host scene state into device tensors.

    mesh_arrays: (indices, pos, normal, albedo, material) flat numpy arrays.
    subframes: list of scene.types.Subframe. ``device=None`` means CUDA and
    raises when there is none. The wide-BVH tables (``wide=True``) and the
    area-light tables (``emissive_nee=True``) are later slices of the port.
    """
    if wide:
        raise NotImplementedError(
            "pack_scene(wide=True): the wide-BVH mega-table is a later slice "
            "of the port (accel/wide.py)"
        )
    if emissive_nee:
        raise NotImplementedError(
            "pack_scene(emissive_nee=True): area-light NEE is a later slice "
            "of the port (ops/arealights.py)"
        )
    device = resolve_device(device)
    indices, pos, normal, albedo, material = mesh_arrays
    inst_f, inst_u = _instance_rows(instances)

    segments = [(i.blas.node_offset, i.blas.node_count) for i in instances]
    segments += [(sf.tlas.node_offset, sf.tlas.node_count) for sf in subframes]

    sf_tlas, sf_cam, sf_light = _subframe_rows(subframes)

    tri_pos, tri_idx = pack_tri_tables(
        indices, pos, [i.mesh for i in instances]
    )
    dev = lambda a: to_device(a, device)
    return SceneDevice(
        nl8=dev(pack_nl8(bvh_nodes, bvh_links, segments)),
        tri_pos=dev(tri_pos),
        tri_idx=dev(tri_idx),
        inst_f=dev(inst_f),
        inst_u=dev(inst_u),
        vattr=dev(pack_vattr(normal, albedo, material)),
        sf_tlas_count=dev(sf_tlas[:, 0]),
        sf_tlas_offset=dev(sf_tlas[:, 1]),
        sf_cam=dev(sf_cam),
        sf_light=dev(sf_light),
    )


def _subframe_rows(subframes):
    S = max(len(subframes), 1)
    sf_tlas = np.zeros((S, 2), np.int32)
    sf_cam = np.zeros((S, 18), f32)
    sf_light = np.zeros((S, 7), f32)
    for i, sf in enumerate(subframes):
        sf_tlas[i] = (sf.tlas.node_count, sf.tlas.node_offset)
        c = sf.cam
        sf_cam[i, 0:9] = np.asarray(c.orientation, f32).reshape(-1)
        sf_cam[i, 9:12] = np.asarray(c.position, f32)
        sf_cam[i, 12] = c.aspect_ratio
        sf_cam[i, 13] = c.inv_focal_length
        sf_cam[i, 14] = c.focal_distance
        sf_cam[i, 15] = c.aperture_angle
        sf_cam[i, 16] = float(c.aperture_polygon)
        sf_cam[i, 17] = c.aperture_radius
        sf_light[i, 0:3] = np.asarray(sf.light.direction, f32)
        sf_light[i, 3:6] = np.asarray(sf.light.color, f32)
        sf_light[i, 6] = sf.light.cos_solid_angle
    return sf_tlas, sf_cam, sf_light
