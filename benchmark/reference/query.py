"""Ray queries by brute force: every triangle a ray could reach is tested.

No tree: each mesh is cut into runs of ``CLUSTER`` consecutive triangles,
each run of each instance gets a world-space box (its object-space corners
through the instance's transform, padded), and a ray tests every triangle
of every run whose box it crosses. The boxes only skip work; a box is made
wide enough that it never hides a triangle the ray meets.

The triangle test is the renderer's own (reference: math.hh:340-401, the
watertight test), run in instance space on the ray brought there by the
instance's inverse transform (reference: ray_query.hh:159-165). A closest
query keeps the nearest hit with tmin < t < tmax; an any-hit query reports
whether there is one.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .vec import Vec3, cross, dot3, fabs3, where3

Array = Any
CLUSTER = 16
# boxes are padded by PAD_ABS + PAD_REL * |corner| in world units
PAD_ABS, PAD_REL = 1e-3, 1e-4
# elements of one (rays x boxes) test, and triangle slots of one block
BOX_TESTS_PER_CHUNK = 1 << 23
SLOTS_PER_BLOCK = 1 << 22


class RayHit(NamedTuple):
    """Closest-hit record (reference: ray_query.hh:24-35)."""

    thit: Array       # < 0 => miss
    bary_u: Array
    bary_v: Array
    bary_w: Array
    inst: Array       # int32; -1 => none
    prim: Array
    back: Array       # bool


def instance_ray(fi, org: Vec3, d: Vec3):
    """Ray into instance space by the inverse transform's columns
    (reference: ray_query.hh:159-165)."""
    bo = Vec3(
        fi[:, 0] * org.x + fi[:, 3] * org.y + fi[:, 6] * org.z + fi[:, 9],
        fi[:, 1] * org.x + fi[:, 4] * org.y + fi[:, 7] * org.z + fi[:, 10],
        fi[:, 2] * org.x + fi[:, 5] * org.y + fi[:, 8] * org.z + fi[:, 11],
    )
    bd = Vec3(
        fi[:, 0] * d.x + fi[:, 3] * d.y + fi[:, 6] * d.z,
        fi[:, 1] * d.x + fi[:, 4] * d.y + fi[:, 7] * d.z,
        fi[:, 2] * d.x + fi[:, 5] * d.y + fi[:, 8] * d.z,
    )
    return bo, bd


def tri_preprocess(d: Vec3):
    """Woop max-axis permutation + shear constants
    (reference: math.hh:340-356). Returns (axis int32, S Vec3)."""
    a = fabs3(d)
    is0 = torch.logical_and(a.x > a.y, a.x > a.z)
    is1 = torch.logical_and(torch.logical_not(is0), a.y > a.z)
    two = torch.full_like(d.x, 2, dtype=torch.int32)
    axis = torch.where(is0, 0, torch.where(is1, 1, two))
    rdir = Vec3(
        torch.where(is0, d.z, d.x),
        torch.where(is1, d.z, d.y),
        torch.where(is0, d.x, torch.where(is1, d.y, d.z)),
    )
    inv_z = 1.0 / rdir.z
    return axis, Vec3(rdir.x * inv_z, rdir.y * inv_z, torch.ones_like(inv_z) * inv_z)


def tri_intersect(origin: Vec3, axis, S: Vec3, p0: Vec3, p1: Vec3, p2: Vec3):
    """Watertight ray-triangle test (reference: math.hh:358-401).

    Returns (hit bool, u, v, t, back_face bool).
    """
    A = p0 - origin
    B = p1 - origin
    C = p2 - origin
    x = Vec3(A.x, B.x, C.x)
    y = Vec3(A.y, B.y, C.y)
    z = Vec3(A.z, B.z, C.z)
    is0 = axis == 0
    is1 = axis == 1
    x2 = where3(is0, z, x)
    y2 = where3(is1, z, y)
    z2 = where3(is0, x, where3(is1, y, z))
    x3 = x2 - z2 * S.x
    y3 = y2 - z2 * S.y
    uvw = cross(y3, x3)
    det = uvw.x + uvw.y + uvw.z
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    u = uvw.x * inv_det
    v = uvw.y * inv_det
    t = dot3(uvw, z2 * S.z) * inv_det
    back = det < 0
    back = torch.logical_xor(back, S.z < 0)
    back = torch.logical_xor(back, axis != 2)
    all_pos = (uvw.x >= 0) & (uvw.y >= 0) & (uvw.z >= 0)
    all_neg = (uvw.x <= 0) & (uvw.y <= 0) & (uvw.z <= 0)
    hit = (det != 0) & (t >= 0) & (all_pos | all_neg)
    return hit, u, v, t, back


def tri_vertices(tp):
    return (
        Vec3(tp[..., 0], tp[..., 1], tp[..., 2]),
        Vec3(tp[..., 3], tp[..., 4], tp[..., 5]),
        Vec3(tp[..., 6], tp[..., 7], tp[..., 8]),
    )


class Clusters(NamedTuple):
    """The runs of triangles a query tests, one entry per (instance, run)."""

    inst: Array   # (E,) int32 instance id
    tri0: Array   # (E,) int32 first global triangle row of the run
    ntri: Array   # (E,) int32 triangles in the run (<= CLUSTER)
    sub: Array    # (E,) int32 subframe of the instance, -1: every subframe
    lo: Array     # (E, 3) float32 world box, padded
    hi: Array


def mesh_runs(pos: np.ndarray, indices: np.ndarray, mesh):
    """Object-space boxes of a mesh's runs of CLUSTER triangles:
    (first local triangle, count, lo (n, 3), hi (n, 3)) in float64."""
    tri = indices[mesh.index_offset: mesh.index_offset + 3 * mesh.triangle_count]
    p = pos[tri.reshape(-1, 3).astype(np.int64) + mesh.base_vertex_offset].astype(np.float64)
    starts = np.arange(0, mesh.triangle_count, CLUSTER)
    counts = np.minimum(CLUSTER, mesh.triangle_count - starts)
    lo = np.stack([p[s:s + c].reshape(-1, 3).min(0) for s, c in zip(starts, counts)])
    hi = np.stack([p[s:s + c].reshape(-1, 3).max(0) for s, c in zip(starts, counts)])
    return starts, counts, lo, hi


def build_clusters(instances, runs_by_mesh, device) -> Clusters:
    """instances: objects with ``mesh`` (index_offset, ...), ``transform``
    (4x4, row-vector convention: p @ M[:3, :3] + M[3, :3]) and ``sub``;
    runs_by_mesh: index_offset -> mesh_runs(...)."""
    inst, tri0, ntri, sub, los, his = [], [], [], [], [], []
    for i, ins in enumerate(instances):
        starts, counts, lo, hi = runs_by_mesh[ins.mesh.index_offset]
        m = ins.transform.astype(np.float64)
        corners = np.stack([
            np.where([(k >> a) & 1 for a in range(3)], hi, lo) for k in range(8)
        ], 1)  # (n, 8, 3)
        w = corners @ m[:3, :3] + m[3, :3]
        wlo, whi = w.min(1), w.max(1)
        pad = PAD_ABS + PAD_REL * np.maximum(np.abs(wlo), np.abs(whi))
        inst.append(np.full(len(starts), i, np.int32))
        tri0.append((ins.mesh.index_offset // 3 + starts).astype(np.int32))
        ntri.append(counts.astype(np.int32))
        sub.append(np.full(len(starts), ins.sub, np.int32))
        los.append(wlo - pad)
        his.append(whi + pad)
    cat = lambda xs, dt: torch.from_numpy(np.concatenate(xs).astype(dt)).to(device)
    return Clusters(cat(inst, np.int32), cat(tri0, np.int32), cat(ntri, np.int32),
                    cat(sub, np.int32), cat(los, np.float32), cat(his, np.float32))


def _box_candidates(cl: Clusters, org: Vec3, d: Vec3, tmin, tmax, active, sub):
    """(ray, entry) pairs whose ray crosses the entry's box within
    [tmin, tmax] (padded): rays of one chunk against every entry."""
    o = torch.stack([org.x, org.y, org.z], -1)[:, None, :]
    dd = torch.stack([d.x, d.y, d.z], -1)[:, None, :]
    lo, hi = cl.lo[None], cl.hi[None]
    zero = dd == 0
    inside = (o >= lo) & (o <= hi)
    inv = 1.0 / torch.where(zero, 1.0, dd)
    t1 = torch.where(zero, torch.where(inside, -np.inf, np.inf), (lo - o) * inv)
    t2 = torch.where(zero, torch.where(inside, np.inf, -np.inf), (hi - o) * inv)
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    ok = (near <= far) & (far >= tmin[:, None] - 1e-3)
    ok &= near <= tmax[:, None] * (1 + 1e-4) + 1e-3
    ok &= active[:, None]
    ok &= (cl.sub[None] < 0) | (cl.sub[None] == sub[:, None])
    return ok.nonzero(as_tuple=True)


def query(tables, cl: Clusters, org: Vec3, d: Vec3, tmin, tmax, active, anyhit, sub):
    """Trace a batch of rays against every triangle they could meet.

    tables: ``inst_f`` (I, 21) and ``tri_pos`` (T, 12). tmin / tmax / anyhit
    / sub per lane. Returns (RayHit of the closest lanes, occluded of the
    any-hit lanes)."""
    R = org.x.shape[0]
    dev = org.x.device
    best_t = torch.full((R,), np.inf, dtype=torch.float32, device=dev)
    best_key = torch.full((R,), np.iinfo(np.int64).max, dtype=torch.int64, device=dev)
    occluded = torch.zeros(R, dtype=torch.bool, device=dev)
    pairs_r, pairs_e = [], []
    step = max(1, BOX_TESTS_PER_CHUNK // max(1, cl.inst.shape[0]))
    for a in range(0, R, step):
        b = min(R, a + step)
        sl = slice(a, b)
        r, e = _box_candidates(
            cl, Vec3(org.x[sl], org.y[sl], org.z[sl]), Vec3(d.x[sl], d.y[sl], d.z[sl]),
            tmin[sl], tmax[sl], active[sl], sub[sl])
        pairs_r.append(r + a)
        pairs_e.append(e)
    pr = torch.cat(pairs_r)
    pe = torch.cat(pairs_e)
    k = torch.arange(CLUSTER, device=dev)
    per_block = max(1, SLOTS_PER_BLOCK // CLUSTER)
    hits = []
    for a in range(0, pr.shape[0], per_block):
        r, e = pr[a:a + per_block], pe[a:a + per_block]
        inst = cl.inst[e].long()
        fi = tables.inst_f[inst]
        bo, bd = instance_ray(fi, Vec3(org.x[r], org.y[r], org.z[r]),
                              Vec3(d.x[r], d.y[r], d.z[r]))
        axis, S = tri_preprocess(bd)
        valid = k[None] < cl.ntri[e][:, None]
        row = torch.where(valid, cl.tri0[e][:, None] + k[None], 0)
        col = lambda v: v[:, None].expand(-1, CLUSTER)
        ok, _, _, t, _ = tri_intersect(
            Vec3(col(bo.x), col(bo.y), col(bo.z)), col(axis),
            Vec3(col(S.x), col(S.y), col(S.z)), *tri_vertices(tables.tri_pos[row]))
        rr = col(r)
        ok = ok & valid & (t > tmin[rr]) & (t < tmax[rr])
        if not ok.any():
            continue
        prim = (cl.tri0[e] - tables.inst_u[inst, 4]).long()[:, None] + k[None]
        key = (col(inst) << 32) | prim
        rr, t, key = rr[ok], t[ok], key[ok]
        occluded[rr[anyhit[rr]]] = True
        keep = ~anyhit[rr]
        rr, t, key = rr[keep], t[keep], key[keep]
        best_t.scatter_reduce_(0, rr, t, "amin")
        hits.append((rr, t, key))
    for rr, t, key in hits:
        win = t == best_t[rr]
        best_key.scatter_reduce_(0, rr[win], key[win], "amin")
    hit_m = torch.isfinite(best_t) & ~anyhit & active
    c_inst = torch.where(hit_m, (best_key >> 32).to(torch.int32), -1)
    c_prim = torch.where(hit_m, (best_key & 0xFFFFFFFF).to(torch.int32), 0)
    return finalize_hit(tables, org, d, best_t, c_inst, c_prim), occluded


def finalize_hit(tables, org: Vec3, d: Vec3, tmax, c_inst, c_prim) -> RayHit:
    """The RayHit of the closest hit's ids, (u, v, back) from one triangle
    test of the winner (as the renderer's walks finish)."""
    hitm = c_inst >= 0
    iidx = torch.where(hitm, c_inst, 0)
    fi = tables.inst_f[iidx]
    bo, bd = instance_ray(fi, org, d)
    baxis, bS = tri_preprocess(bd)
    tri_row = torch.where(hitm, tables.inst_u[iidx, 4] + c_prim, 0)
    _, tu, tv, _, tback = tri_intersect(bo, baxis, bS, *tri_vertices(tables.tri_pos[tri_row]))
    zero = torch.zeros_like(tmax)
    tu = torch.where(hitm, tu, zero)
    tv = torch.where(hitm, tv, zero)
    return RayHit(
        thit=torch.where(hitm, tmax, -1.0),
        bary_u=tu,
        bary_v=tv,
        bary_w=1.0 - tu - tv,
        inst=c_inst,
        prim=torch.where(hitm, c_prim, 0),
        back=hitm & tback,
    )
