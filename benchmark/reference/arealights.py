"""Emissive-surface next-event estimation (area-light NEE); the JAX package's
``ops/arealights.py``.

The reference NEE-samples only the directional sun (path_tracer.hh:594-620);
emissive surfaces are found by BSDF sampling alone. This module adds the
second technique, off by default: a scene packed with
``pack_scene(..., emissive_nee=True)`` carries the light tables below, and
then every path renderer (the scan, K2, K5) draws one more rand4 per bounce
and traces a second any-hit ray toward a point on an emitter.

Estimator: uniform-by-area sampling over all emissive world-space
triangles, one-sample MIS against the BSDF lobe with the power heuristic:
NEE contributions are weighted by ``p_area / (p_area^2 + p_bsdf^2)`` and
BSDF-sampled emission hits by ``p_bsdf^2 / (p_bsdf^2 + p_area(hit)^2)``.

Tables (SceneDevice's optional fields, built by ``build_light_table``):
  lt_tris (L, 9) f32   world-space triangle vertices, one emissive triangle
                       per row per instance
  lt_rows (L,)  i32    global tri-table row, for the attribute interpolation
                       through tri_idx / vattr
  lt_cdf  (L,)  f32    inclusive area prefix sum; last entry = total area
  lt_seg  (I,)  i32    per-instance first row in lt_tris (-1: no emitters)
  lt_rank (T,)  i32    per-mesh emissive rank of each triangle (-1: not
                       emissive); a hit (inst, prim) is light row
                       lt_seg[inst] + lt_rank[tri_row]

Emitters are static: one table for all subframes, as in the JAX package.
The path kernels' light policy (csrc/path.cuh, ``AreaLights``) computes the
functions below in the same order.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .bsdf import bsdf_eval
from .vec import Vec3, c32, cross, dot3, length3, sqrt, where3

Array = Any
f32 = np.float32

# f32(1) - f32(1e-7): the largest u.x the CDF search takes
_U_MAX = c32(f32(1.0) - f32(1e-7))


# ---------------------------------------------------------------- host pack


def build_light_table(mesh_arrays, instances):
    """Collect emissive triangles in world space.

    Returns None when the scene has no emissive triangles, else a dict of
    the lt_* numpy arrays documented above, byte-equal to the JAX package's.
    """
    indices, pos, normal, albedo, material = mesh_arrays
    T = max(len(indices) // 3, 1)
    lt_rank = np.full(T, -1, np.int32)
    lt_seg = np.full(max(len(instances), 1), -1, np.int32)

    # per-mesh emissive ranks (meshes shared by instances rank once)
    mesh_emissive = {}  # index_offset -> (triangle vertex ids, emissive tri ids)
    for inst in instances:
        m = inst.mesh
        if m.triangle_count == 0 or m.index_offset in mesh_emissive:
            continue
        tri = indices[
            m.index_offset : m.index_offset + 3 * m.triangle_count
        ].reshape(-1, 3).astype(np.int64) + m.base_vertex_offset
        emis = (material[tri, 3] > 0).any(axis=1)  # any vertex emissive
        ids = np.nonzero(emis)[0]
        t0 = m.index_offset // 3
        lt_rank[t0 + ids] = np.arange(len(ids), dtype=np.int32)
        mesh_emissive[m.index_offset] = (tri, ids)

    tris, rows, areas = [], [], []
    for i, inst in enumerate(instances):
        m = inst.mesh
        if m.triangle_count == 0:
            continue
        tri, ids = mesh_emissive[m.index_offset]
        if len(ids) == 0:
            continue
        lt_seg[i] = len(rows)
        M = inst.transform.astype(f32)
        p = pos[tri[ids]].astype(f32)  # (k, 3, 3) object space
        pw = p @ M[:3, :3] + M[3, :3]  # row-vector convention
        e1 = pw[:, 1] - pw[:, 0]
        e2 = pw[:, 2] - pw[:, 0]
        a = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        tris.append(pw.reshape(-1, 9))
        rows.extend((m.index_offset // 3 + ids).tolist())
        areas.append(a)

    if not rows:
        return None
    areas = np.concatenate(areas).astype(f32)
    return dict(
        lt_tris=np.concatenate(tris).astype(f32),
        lt_rows=np.asarray(rows, np.int32),
        lt_cdf=np.cumsum(areas, dtype=f32),
        lt_seg=lt_seg,
        lt_rank=lt_rank,
    )


# ---------------------------------------------------------------- device


class AreaSample(NamedTuple):
    wi: Vec3            # direction to the sampled light point
    dist: Array         # distance to it
    weighted_pdf: Array  # p_area / (p_area^2 + p_bsdf^2), zeroed if invalid
    radiance: Vec3      # interpolated albedo x emission at the point
    bsdf: Vec3          # f x |cos| toward the light (bsdf_eval color)
    shadow_active: Array


def _light_verts(scene, j):
    row = scene.lt_tris[j]
    return (
        Vec3(row[:, 0], row[:, 1], row[:, 2]),
        Vec3(row[:, 3], row[:, 4], row[:, 5]),
        Vec3(row[:, 6], row[:, 7], row[:, 8]),
    )


def _solid_angle_pdf(v0, v1, v2, d: Vec3, dist, total_area):
    """Area-measure -> solid-angle pdf at distance ``dist`` along d."""
    ng = cross(v1 - v0, v2 - v0)
    nglen = length3(ng)
    cos_l = torch.abs(dot3(ng, d)) / torch.where(nglen == 0, 1.0, nglen)
    denom = cos_l * total_area
    return torch.where(
        denom > 0, dist * dist / torch.where(denom > 0, denom, 1.0), 0.0
    )


def sample_area_light(scene, u, info, tview: Vec3, active) -> AreaSample:
    """One light sample per lane: pick a triangle by area (CDF search on
    u.x), a point uniformly on it (square-root warp on u.y / u.z), and
    evaluate the BSDF toward it. The pdfs come folded into the
    one-sample-MIS weight, so the caller only multiplies radiance x bsdf x
    visibility."""
    total_area = scene.lt_cdf[-1]
    r = torch.clamp(u.x, max=_U_MAX) * total_area
    j = torch.clamp(
        torch.searchsorted(scene.lt_cdf, r, right=True),
        0, scene.lt_cdf.shape[0] - 1,
    )
    v0, v1, v2 = _light_verts(scene, j)

    su = sqrt(u.y)
    b0 = 1.0 - su
    b1 = su * (1.0 - u.z)
    b2 = su * u.z
    p = v0 * b0 + v1 * b1 + v2 * b2

    dvec = p - info.pos
    dist = length3(dvec)
    wi = dvec / torch.where(dist == 0, 1.0, dist)
    p_area = _solid_angle_pdf(v0, v1, v2, wi, dist, total_area)

    # interpolated emitted radiance (the vertex order of the lt_tris rows)
    ti = scene.tri_idx[scene.lt_rows[j]]
    a0 = scene.vattr[ti[:, 0]]
    a1 = scene.vattr[ti[:, 1]]
    a2 = scene.vattr[ti[:, 2]]
    attr = a0 * b0[:, None] + a1 * b1[:, None] + a2 * b2[:, None]
    radiance = Vec3(attr[:, 3], attr[:, 4], attr[:, 5]) * attr[:, 10]

    tlight = info.tbn.vec_mul(wi)
    color, b_pdf = bsdf_eval(
        tlight, tview, info.albedo, info.roughness, info.metallic,
        info.transmission, info.eta,
    )

    # one-sample power heuristic folded with the 1/p_area estimator factor
    denom = p_area * p_area + b_pdf * b_pdf
    w = torch.where(
        (p_area > 0) & torch.isfinite(p_area) & (denom > 0),
        p_area / torch.where(denom > 0, denom, 1.0),
        0.0,
    )

    lit = (
        ((radiance.x > 0) | (radiance.y > 0) | (radiance.z > 0))
        & (w > 0)
        & ((color.x > 0) | (color.y > 0) | (color.z > 0))
        & (dist > 0)
    )
    return AreaSample(
        wi=wi,
        dist=dist,
        weighted_pdf=torch.where(lit, w, torch.zeros_like(w)),
        radiance=radiance,
        bsdf=color,
        shadow_active=active & lit,
    )


def area_nee_color(s: AreaSample, occluded, active) -> Vec3:
    live = active & s.shadow_active & torch.logical_not(occluded)
    c = s.bsdf * s.radiance * s.weighted_pdf
    zero = torch.zeros_like(c.x)
    return where3(live, c, Vec3(zero, zero, zero))


def light_pdf_of_hit(scene, inst, prim, d: Vec3, thit, hit_valid) -> Array:
    """Solid-angle pdf with which sample_area_light would have produced this
    BSDF-sampled hit (0 for a hit that is not emissive): the other half of
    the MIS pair, from the same lt_tris row, so the weights cancel
    exactly."""
    safe_inst = torch.where(hit_valid, inst, 0)
    tri_row = scene.inst_u[safe_inst, 4] + torch.where(hit_valid, prim, 0)
    rank = scene.lt_rank[tri_row]
    seg = scene.lt_seg[safe_inst]
    is_light = hit_valid & (rank >= 0) & (seg >= 0)
    j = torch.where(is_light, seg + rank, 0)
    v0, v1, v2 = _light_verts(scene, j)
    pdf = _solid_angle_pdf(v0, v1, v2, d, thit, scene.lt_cdf[-1])
    return torch.where(is_light & torch.isfinite(pdf), pdf, 0.0)
