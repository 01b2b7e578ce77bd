"""The path-tracing integrator (reference: path_tracer.hh:594-741).

``path_trace_samples`` computes a batch of per-sample radiance values with
bit-faithful RNG threading: one warm-up PCG4D step, one film/aperture draw,
then per bounce an NEE draw, a BSDF draw, and a *conditional* atmosphere
draw — lanes that miss or terminate stop consuming their counters exactly
like the reference's scalar control flow.

The bounce loop is a Python loop (``max_bounces`` passes of the same body);
every bounce makes ONE merged ray query — the any-hit shadow ray and the
closest-hit bounce ray of each lane trace together in a 2R-lane batch with a
per-lane anyhit mask (3R lanes with area lights: the area-light shadow ray
too) — with inactive lanes masked. On a CUDA device that
query is the hand-written kernel (ops/traversal.ray_query dispatches), and
nothing in the loop asks the device for a value: no ``.item()``, no
``.cpu()``.

Dead lanes carry inf/NaN by design, like the reference's dead paths: they are
masked at every accumulation, never cleaned, and never used as an index.

Gradients (diff/render.py) run PyTorch's autograd through this code; the
ray queries stay outside the graph. ``record=`` / ``replay=`` are the fast
gradients' two passes, and the gathers of differentiable tables are autograd
Functions whose backward is a kernel on the card: ``small_table_gather``
(K7a), whose transpose the JAX package writes by hand, and ``row_gather``
(K7b), for the vertex, instance and triangle tables.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops import arealights, rng
from pathtracing_tpu_torch.ops.bsdf import bsdf_eval, sample_bsdf
from pathtracing_tpu_torch.ops.camera import camera_from_table, get_camera_ray
from pathtracing_tpu_torch.ops.samplers import sample_cone, sample_gaussian_weighted_disk
from pathtracing_tpu_torch.ops.sky import atmosphere_attenuation, atmosphere_scattering
from pathtracing_tpu_torch.ops.traversal import (
    RayHit,
    _instance_ray,
    _tri_intersect,
    _tri_preprocess,
    _tri_vertices,
    ray_query,
)
from pathtracing_tpu_torch.utils.vec import (
    Mat3,
    Vec2,
    Vec3,
    c32,
    create_tangent_space,
    dot3,
    length3,
    maximum,
    normalize3,
    where3,
)

Array = Any
_PI = c32(math.pi)
_IOR = c32(1.5)
_INV_IOR = c32(1.0 / _IOR)
_TWO_PI = c32(2.0 * _PI)


class LightParams(NamedTuple):
    direction: Vec3
    color: Vec3
    cos_solid_angle: Array


def small_table_grad_plain(idx: Array, g: Array, n_rows: int) -> Array:
    """The transpose of ``table[idx]`` for a table of ``n_rows`` rows:
    ``out[s, c] = sum of g[r, c] over r with idx[r] == s`` (the JAX
    package's ``_stg_bwd``, ``onehot(idx)^T @ g``, written as one
    ``index_add_``). The plain version of the K7a kernel. Adds in double
    and rounds once, as the kernel does: a frame's millions of float
    cotangents cancel on some rows, where a float sum's rounding error
    would reach the result's last digits, in an order-dependent way."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float64, device=g.device)
    return out.index_add_(0, idx.long(), g.double()).to(g.dtype)


def row_grad_plain(index: Array, g: Array, n_rows: int) -> Array:
    """The transpose of ``table[index]`` for a table of ``n_rows`` rows and
    an index of shape (R,) or (R, 3): one scatter-add of the index's
    cotangent rows (the JAX package's ``_vg3_bwd``; XLA's transpose of a
    plain gather), in double as ``small_table_grad_plain``. The plain
    version of the K7b kernel."""
    out = torch.zeros((n_rows, g.shape[-1]), dtype=torch.float64, device=g.device)
    flat = g.reshape(-1, g.shape[-1]).double()
    return out.index_add_(0, index.reshape(-1).long(), flat).to(g.dtype)


class SmallTableGather(torch.autograd.Function):
    """``table[idx]`` for the tiny per-subframe tables (sf_light (S, 7),
    sf_cam (S, 18)), whose transpose is a sum of R cotangent rows into S
    rows: every lane of a frame lands on one of a few rows. The backward is
    the K7a kernel for CUDA tensors (ops/cuda_gather_grad.py: block partials
    in lane order, then the partials in block order; deterministic, no
    float atomics) and ``small_table_grad_plain`` for CPU tensors. ``idx``
    gets no gradient."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.contiguous()
        if g.is_cuda:
            from pathtracing_tpu_torch.ops.cuda_gather_grad import small_table_grad_cuda

            return small_table_grad_cuda(idx, g, ctx.n_rows), None
        return small_table_grad_plain(idx, g, ctx.n_rows), None


class RowGather(torch.autograd.Function):
    """``table[index]`` for an index of shape (R,) or (R, 3) into a table of
    at most 32 columns: ``vattr[ti3]`` (R, 3, 12), the three vertex rows of
    each lane's triangle in one gather so that the transpose is one sum of
    3R rows (the JAX package's ``_vattr_gather3``), and shade_hit's
    ``inst_f[iidx]`` (R, 21) and ``tri_pos[tri_row]`` (R, 12), whose
    transposes XLA derives. Miss lanes all read row 0 (or the rows of
    triangle 0), so a few rows receive most addends (zeros), and PyTorch's
    index backward would add each such run serially. The backward is the
    K7b kernel for CUDA tensors (ops/cuda_gather_grad.py: a stable sort of
    the indices, then each run of equal indices summed in order;
    deterministic, no float atomics) and ``row_grad_plain`` for CPU
    tensors. The index gets no gradient."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.n_rows = table.shape[0]
        return table[index]

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        g = g.contiguous()
        if g.is_cuda:
            from pathtracing_tpu_torch.ops.cuda_gather_grad import row_grad_cuda

            return row_grad_cuda(index, g, ctx.n_rows), None
        return row_grad_plain(index, g, ctx.n_rows), None


def small_table_gather(table: Array, idx: Array) -> Array:
    """``table[idx]`` with the transpose of ``SmallTableGather``."""
    return SmallTableGather.apply(table, idx)


def row_gather(table: Array, index: Array) -> Array:
    """``table[index]`` with the transpose of ``RowGather``."""
    return RowGather.apply(table, index)


def light_from_table(sf_light: Array, idx: Array) -> LightParams:
    l = small_table_gather(sf_light, idx)
    return LightParams(
        direction=Vec3(l[:, 0], l[:, 1], l[:, 2]),
        color=Vec3(l[:, 3], l[:, 4], l[:, 5]),
        cos_solid_angle=l[:, 6],
    )


class HitInfo(NamedTuple):
    """reference: path_tracer.hh:321-338."""

    thit: Array
    pos: Vec3
    tbn: Mat3
    albedo: Vec3
    alpha: Array
    roughness: Array
    metallic: Array
    emission: Array
    transmission: Array
    eta: Array
    nee_pdf: Array


def trace_ray(
    scene,
    light: LightParams,
    tlas_count,
    tlas_offset,
    origin: Vec3,
    d: Vec3,
    tmin,
    active,
) -> HitInfo:
    """Closest-hit trace + shading fetch (reference: path_tracer.hh:340-412)."""
    hit, _ = ray_query(
        scene, tlas_count, tlas_offset, origin, d, tmin, 1e9, active
    )
    return shade_hit(scene, light, hit, origin, d)


def shade_hit(
    scene, light: LightParams, hit, origin: Vec3, d: Vec3,
    packed: bool = False,
) -> HitInfo:
    """Shading fetch for a closest-hit result (reference: path_tracer.hh:356-412).

    The default gathers the per-vertex tables (tri_idx, vattr, tri_pos).
    ``packed=True`` reads the (T, 48) ``tri_shade`` rows of a scene packed
    with ``wide=True`` instead (scene/device.pack_tri_shade): one row gives
    the three 11-float vertex attributes and the 9 positions, and ``back`` is
    re-derived from the triangle test instead of taken from ``hit``.
    ``path_trace_samples`` does not pass it; it serves the fused renderers.
    """
    if packed and scene.tri_shade is None:
        raise ValueError("shade_hit(packed=True): the scene carries no "
                         "tri_shade rows; pack it with wide=True")
    miss = hit.thit < 0

    # ---- miss: sun disk (reference: path_tracer.hh:356-366) ----
    visible = (dot3(light.direction, d) > light.cos_solid_angle).to(torch.float32)
    miss_nee_pdf = visible / ((1.0 - light.cos_solid_angle) * _TWO_PI)
    sun_scale = torch.where(miss_nee_pdf == 0.0, 1.0, miss_nee_pdf)
    miss_albedo = light.color * (visible * sun_scale)

    # ---- hit: interpolate vertex attributes (row gathers) ----
    # miss lanes carry inst -1: every index is guarded to row 0
    iidx = torch.where(miss, 0, hit.inst)
    ui = scene.inst_u[iidx]
    fi = row_gather(scene.inst_f, iidx)  # (R, 21)
    tri_row = ui[:, 4] + torch.where(miss, 0, hit.prim)
    if packed:
        # tri_shade is not a differentiable field (diff/render.py), so its
        # gather has no transpose to route
        ts_row = scene.tri_shade[tri_row]  # (R, 48)
        a0 = ts_row[:, 0:11]
        a1 = ts_row[:, 11:22]
        a2 = ts_row[:, 22:33]
        tp = ts_row[:, 33:42]
    else:
        ti = scene.tri_idx[tri_row]  # (R, 4) absolute vertex ids
        # one (R, 3) gather: its transpose is one sum of 3R rows
        a012 = row_gather(scene.vattr, ti[:, 0:3].contiguous())  # (R, 3, 12)
        a0 = a012[:, 0]
        a1 = a012[:, 1]
        a2 = a012[:, 2]
        tp = row_gather(scene.tri_pos, tri_row)  # (R, 12)

    # (u, v, t) re-derived at fixed topology from the hit ids, with the
    # same formulas as the ray query's own triangle test
    bo, bd = _instance_ray(fi, origin, d)
    baxis, bS = _tri_preprocess(bd)
    _, du, dv, dt, dback = _tri_intersect(bo, baxis, bS, *_tri_vertices(tp))
    back = (torch.logical_not(miss) & dback) if packed else hit.back
    thit = torch.where(miss, hit.thit, dt)
    bu = torch.where(miss, hit.bary_u, du)
    bv = torch.where(miss, hit.bary_v, dv)
    bw = 1.0 - bu - bv
    attr = a0 * bu[:, None] + a1 * bv[:, None] + a2 * bw[:, None]
    n = Vec3(attr[:, 0], attr[:, 1], attr[:, 2])
    alb = Vec3(attr[:, 3], attr[:, 4], attr[:, 5])
    alpha = attr[:, 6]
    mat_r = attr[:, 7]
    mat_m = attr[:, 8]
    mat_t = attr[:, 9]
    mat_e = attr[:, 10]

    # rotate normal to world: mul_m3v3(rot, n) with rot = transform 3x3
    # (reference: path_tracer.hh:371,392)
    nw = Vec3(
        fi[:, 12] * n.x + fi[:, 15] * n.y + fi[:, 18] * n.z,
        fi[:, 13] * n.x + fi[:, 16] * n.y + fi[:, 19] * n.z,
        fi[:, 14] * n.x + fi[:, 17] * n.y + fi[:, 20] * n.z,
    )
    # Miss/dead lanes read instance 0's dummy rows: route them through a
    # constant normal and guard the normalize operand. Live-lane values are
    # untouched: the where only redirects miss lanes.
    nlen = length3(nw)
    one = torch.ones_like(nlen)
    nw = nw / torch.where(miss | (nlen == 0), one, nlen)
    nw = where3(miss, Vec3(one * 0.0, one * 0.0, one), nw)

    # IOR 1.5; back-face flips the normal (reference: path_tracer.hh:394-400)
    eta = torch.where(back, _IOR, _INV_IOR)
    nw = where3(back, -nw, nw)

    tbn = create_tangent_space(nw)
    pos = origin + d * thit

    zero = torch.zeros_like(hit.thit)
    return HitInfo(
        thit=thit,
        pos=pos,
        tbn=tbn,
        albedo=where3(miss, miss_albedo, alb),
        alpha=torch.where(miss, zero, alpha),
        roughness=torch.where(miss, zero, mat_r * mat_r),
        metallic=torch.where(miss, zero, mat_m),
        emission=torch.where(miss, one, mat_e),
        transmission=torch.where(miss, zero, mat_t),
        eta=torch.where(miss, one, eta),
        nee_pdf=torch.where(miss, miss_nee_pdf, zero),
    )


class NeeState(NamedTuple):
    """nee_prepare -> nee_finish plumbing (split around the shadow trace)."""

    u: Any                # the NEE rand4 draw
    light_dir: Vec3
    color: Vec3           # pre-visibility bsdf*pdf*light color
    bsdf_pdf: Any
    nee_pdf: Any
    black: Any
    shadow_active: Any


def nee_prepare(
    seed: rng.Seed,
    light: LightParams,
    info: HitInfo,
    tview: Vec3,
    active,
) -> tuple:
    """NEE up to (not including) the shadow trace
    (reference: path_tracer.hh:594-609). Returns (seed, NeeState).

    Split from nee_finish so the shadow ray can ride the same ray query as
    the bounce ray (per-lane anyhit). Inactive lanes draw nothing.
    """
    seed, u = rng.uniform4_masked(seed, active)
    light_dir = sample_cone(
        light.direction, light.cos_solid_angle, Vec2(u.x, u.y)
    )
    nee_pdf = 1.0 / ((1.0 - light.cos_solid_angle) * _TWO_PI)

    tlight = info.tbn.vec_mul(light_dir)  # mul_v3m3(light_dir, tbn)
    color, bsdf_pdf = bsdf_eval(
        tlight, tview, info.albedo, info.roughness, info.metallic,
        info.transmission, info.eta,
    )
    color = color * nee_pdf * light.color

    black = (color.x == 0) & (color.y == 0) & (color.z == 0)
    # Shadow ray only decides occlusion; lanes already black skip tracing
    # (reference: path_tracer.hh:606-609 short-circuit has no RNG).
    shadow_active = active & torch.logical_not(black)
    return seed, NeeState(
        u=u, light_dir=light_dir, color=color, bsdf_pdf=bsdf_pdf,
        nee_pdf=nee_pdf, black=black, shadow_active=shadow_active,
    )


def nee_finish(
    st: NeeState,
    light: LightParams,
    info: HitInfo,
    occluded,
    active,
    config: RenderConfig,
) -> Vec3:
    """NEE after the shadow trace: MIS weight + sun transmittance march
    (reference: path_tracer.hh:611-619). The march jitter is the already-
    drawn u.w — no RNG here."""
    dead = st.black | occluded

    mis_pdf = torch.where(
        light.cos_solid_angle < 1.0,
        (st.nee_pdf * st.nee_pdf + st.bsdf_pdf * st.bsdf_pdf) / st.nee_pdf,
        1.0,
    )

    color = st.color * atmosphere_attenuation(
        st.u.w, info.pos, st.light_dir,
        torch.full_like(st.u.w, config.max_ray_dist),
    )
    color = color / mis_pdf

    zero = torch.zeros_like(color.x)
    live = active & torch.logical_not(dead)
    return where3(live, color, Vec3(zero, zero, zero))


def camera_sample(config: RenderConfig, scene, xs, ys, sample_index):
    """Seed warm-up, film/aperture draw, and camera ray for one sample per
    lane (reference: path_tracer.hh:655-672).

    A ``subframe`` past the scene's subframe rows reads the last row, as
    XLA's gather clamps an index into its table (PyTorch's would raise, and
    on the card stop the process); ``subframe`` itself is returned as
    computed, as the JAX package returns it.

    Returns (seed, subframe, light, tlas_count, tlas_offset, ray_o, ray_dir).
    """
    subframe = torch.where(
        sample_index < 0,
        0,
        torch.div(
            sample_index, config.samples_per_motion_blur_step, rounding_mode="floor"
        ),
    ).to(torch.int32)

    # int32 holds the uint32 bit patterns (ops/rng.py)
    seed = rng.Seed(
        xs.to(torch.int32),
        ys.to(torch.int32),
        sample_index.to(torch.int32),
        torch.full_like(xs, config.student_id, dtype=torch.int32),
    )
    seed = rng.pcg4d(seed)  # warm-up (reference: path_tracer.hh:660)

    seed, u = rng.uniform4(seed)

    film = sample_gaussian_weighted_disk(Vec2(u.x, u.y), 0.4) + 0.5

    row = lambda table: subframe.clamp(0, table.shape[0] - 1)
    cam = camera_from_table(scene.sf_cam, row(scene.sf_cam))
    light = light_from_table(scene.sf_light, row(scene.sf_light))
    tlas_count = scene.sf_tlas_count[row(scene.sf_tlas_count)]
    tlas_offset = scene.sf_tlas_offset[row(scene.sf_tlas_offset)]

    coord = Vec2(
        xs.to(torch.float32) + film.x, ys.to(torch.float32) + film.y
    )
    ray_dir, ray_o = get_camera_ray(
        cam, Vec2(u.z, u.w), coord, config.image_width, config.image_height
    )
    return seed, subframe, light, tlas_count, tlas_offset, ray_o, ray_dir


def _rec_of(hit: RayHit, occluded) -> dict:
    """A hit record (the JAX package's ``_rec_of``): the closest hit's
    topology and the shadow ray's occlusion."""
    return {
        "hit": hit.thit >= 0,
        "inst": hit.inst,
        "prim": hit.prim,
        "back": hit.back,
        "occ": occluded,
    }


def _hit_of(rec: dict) -> RayHit:
    """The RayHit a replay shades in place of a ray query (the JAX
    package's ``_hit_of``): shade_hit re-derives (u, v, t) of a hit from its
    ids, so only the ids and the hit/miss sign are taken."""
    one = torch.ones_like(rec["inst"], dtype=torch.float32)
    return RayHit(
        thit=torch.where(rec["hit"], one, -one),
        bary_u=0.0 * one, bary_v=0.0 * one, bary_w=one,
        inst=rec["inst"],
        prim=rec["prim"],
        back=rec["back"],
    )


def _stack_records(recs: list, like: dict) -> dict:
    """Per-bounce record dicts -> one dict of (B, R) tensors (the shape of
    the JAX package's ``lax.scan`` output; (0, R) for no bounce, with the
    dtypes of the record ``like``)."""
    if not recs:
        return {k: v[None][:0] for k, v in like.items()}
    return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}


def path_trace_samples(
    config: RenderConfig,
    scene,
    xs: Array,
    ys: Array,
    sample_index: Array,
    query_shade=None,
    record: bool = False,
    replay=None,
) -> Vec3:
    """One radiance sample per lane (reference: path_tracer.hh:637-741).

    xs, ys: pixel coordinates (int32); sample_index: int32 (negative =>
    subframe 0, reference: path_tracer.hh:655-657). All on the scene's
    device.

    record/replay: the fast gradients' two passes (diff/render.py).
    ``record=True`` also returns the hit topology, ``(contribution,
    (prim_rec, recs))``: ``prim_rec`` a dict of (R,) tensors (``hit``,
    ``inst``, ``prim``, ``back``, ``occ``; occ all False) for the primary
    ray, ``recs`` the same keys as (max_bounces, R) tensors, row b for bounce
    ray b + 1 and the sun shadow ray traced beside it. ``replay=<records>``
    runs the same radiance computation with every ray query replaced by a
    lookup in those records: traversal is outside the autograd graph anyway
    (ray_query runs under no_grad), so differentiating the replay gives the
    same gradients, with no walk in the graph. Shading, RNG threading and
    the conditional atmosphere draws are recomputed bit for bit (the
    atmosphere predicate reads the re-derived thit in both passes).

    Area-light NEE (ops/arealights.py) turns on when the scene carries the
    light tables (``pack_scene(emissive_nee=True)``): per bounce one more
    masked rand4 draw after the NEE draw, and a third ray in the bounce's
    query, the any-hit ray toward the sampled light point (tmax just short
    of it); its term is added right after the query, before the sun's, and
    emission found by BSDF sampling takes the power-heuristic weight.

    query_shade: optional trace-and-shade override, called once for the
    primary rays and once per bounce for the merged query: ``(scene, light,
    subframe, org, d, tmin, tmax, active, anyhit, n_shade) -> (occluded over
    lanes [:N - n_shade], HitInfo over the last n_shade lanes)``, with
    ``subframe`` the (N,) subframe index of each lane as ``camera_sample``
    computes it (rows past a table read its last row). The JAX hook takes
    each lane's ``tlas_count`` / ``tlas_offset`` from the scene it runs on;
    here one controller drives every shard, so the hook takes the subframe
    and reads each shard's TLAS handles from that shard's own tables
    (parallel/geomshard.make_geom_query_shade). As in JAX, it refuses
    area-light NEE, and record/replay refuse it (NotImplementedError);
    record/replay with light tables raise it too.
    """
    contribution, prim_rec, recs, _, _ = _path_trace(
        config, scene, xs, ys, sample_index, query_shade, record, replay)
    return (contribution, (prim_rec, recs)) if record else contribution


def path_trace_samples_masked_records(config: RenderConfig, scene, xs, ys, sample_index):
    """``path_trace_samples(record=True)`` with every record row a path
    never reached set to zero: a bounce row where the lane was inactive,
    and an ``occ`` entry where no shadow ray was traced (inactive lane, or
    a NEE colour that was black). That is the rule of the megakernel's
    record build (K6, csrc/path.cuh), which writes only the rows its path
    reaches into zeroed planes. Returns (contribution, (prim_rec, recs))."""
    contribution, prim_rec, recs, active, shadow = _path_trace(
        config, scene, xs, ys, sample_index, None, True, None)
    masked = {}
    for k, v in recs.items():
        keep = shadow if k == "occ" else active
        masked[k] = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return contribution, (prim_rec, masked)


def _path_trace(config, scene, xs, ys, sample_index, query_shade, record, replay):
    """path_trace_samples' body. Returns (contribution, prim_rec, recs,
    active, shadow_active): the last four only with ``record`` (else None),
    ``active`` / ``shadow_active`` the (B, R) masks of the lanes that traced
    the bounce / shadow ray of each row."""
    if query_shade is not None and scene.lt_tris is not None:
        raise NotImplementedError(
            "area-light NEE is not supported under a query_shade override "
            "(geometry sharding packs shard scenes without light tables)"
        )
    if (record or replay is not None) and scene.lt_tris is not None:
        raise NotImplementedError(
            "record/replay gradients support the default sun-NEE trace only, "
            "not area-light NEE (as in the JAX package)"
        )
    if (record or replay is not None) and query_shade is not None:
        raise NotImplementedError(
            "record/replay gradients support the default trace only, not a "
            "query_shade override (as in the JAX package)"
        )
    use_lights = arealights.has_lights(scene)

    seed, subframe, light, tlas_count, tlas_offset, ray_o, ray_dir = (
        camera_sample(config, scene, xs, ys, sample_index)
    )

    all_active = torch.ones_like(xs, dtype=torch.bool)
    prim_rec = None
    if replay is not None:
        info = shade_hit(scene, light, _hit_of(replay[0]), ray_o, ray_dir)
    elif record:
        phit, _ = ray_query(
            scene, tlas_count, tlas_offset, ray_o, ray_dir, 0.0, 1e9, all_active
        )
        prim_rec = _rec_of(phit, torch.zeros_like(all_active))
        info = shade_hit(scene, light, phit, ray_o, ray_dir)
    elif query_shade is not None:
        _, info = query_shade(
            scene, light, subframe, ray_o, ray_dir, 0.0, 1e9, all_active, False,
            xs.shape[0],
        )
    else:
        info = trace_ray(
            scene, light, tlas_count, tlas_offset, ray_o, ray_dir, 0.0, all_active
        )

    one = torch.ones_like(ray_dir.x)
    zero = torch.zeros_like(ray_dir.x)
    zero3 = Vec3(zero, zero, zero)
    attenuation = Vec3(one, one, one)
    contribution = zero3

    seed, attenuation, in_scatter = atmosphere_scattering(
        seed, light.direction, light.color, ray_o, ray_dir, info.thit, all_active
    )
    contribution = contribution + in_scatter + attenuation * info.albedo * info.emission

    regularization = one
    roughness = info.roughness
    active = all_active
    gamma = c32(config.path_space_regularization_gamma)
    cat = lambda a, b: torch.cat([a, b])
    cat3 = lambda *vs: Vec3(*(torch.cat([getattr(v, k) for v in vs]) for k in "xyz"))
    R = xs.shape[0]
    # loop-invariant parts of the merged query's inputs: R any-hit lanes per
    # shadow ray (the sun's, and the area light's), then R closest-hit lanes
    n_shadow = 2 if use_lights else 1
    tlas_count2 = torch.cat([tlas_count] * (n_shadow + 1))
    tlas_offset2 = torch.cat([tlas_offset] * (n_shadow + 1))
    subframe2 = torch.cat([subframe] * (n_shadow + 1)) if query_shade is not None else None
    anyhit2 = cat(
        torch.ones(n_shadow * R, dtype=torch.bool, device=xs.device),
        torch.zeros(R, dtype=torch.bool, device=xs.device),
    )
    if use_lights:
        far = torch.full((R,), c32(config.max_ray_dist), dtype=torch.float32,
                         device=xs.device)
    recs, actives, shadows = [], [], []

    for b in range(config.max_bounces):
        active = active & (info.thit > 0)

        # tangent-space view (reference: path_tracer.hh:700-702)
        view = info.tbn.vec_mul(-ray_dir)
        view = Vec3(
            view.x, view.y,
            torch.where(view.z < 1e-7, maximum(view.z, 1e-7), view.z),
        )
        view = normalize3(view)

        info_now = info._replace(roughness=roughness)

        seed, nee = nee_prepare(seed, light, info_now, view, active)

        if use_lights:
            seed, ua = rng.uniform4_masked(seed, active)
            area = arealights.sample_area_light(scene, ua, info_now, view, active)

        seed, u = rng.uniform4_masked(seed, active)
        sample = sample_bsdf(
            Vec3(u.x, u.y, u.z), view, info_now.albedo, info_now.roughness,
            info_now.metallic, info_now.transmission, info_now.eta,
        )

        new_dir = normalize3(info.tbn.mul_vec(sample.direction))
        new_o = info.pos
        ray_dir = where3(active, new_dir, ray_dir)
        ray_o = where3(active, new_o, ray_o)

        if replay is not None:
            rec = {k: v[b] for k, v in replay[1].items()}
            occluded = rec["occ"]
            bounce_hit = _hit_of(rec)
        elif use_lights:
            # three rays per lane in one query: sun shadow, area-light shadow
            # (tmax just short of the sampled point), bounce
            hit3, occ3 = ray_query(
                scene,
                tlas_count2,
                tlas_offset2,
                cat3(info_now.pos, info_now.pos, ray_o),
                cat3(nee.light_dir, area.wi, ray_dir),
                config.min_ray_dist,
                torch.cat([far, area.dist * c32(1.0 - 1e-3), far]),
                torch.cat([nee.shadow_active, area.shadow_active, active]),
                anyhit=anyhit2,
            )
            occluded = occ3[:R]
            area_occluded = occ3[R:2 * R]
            bounce_hit = RayHit(*(a[2 * R:] for a in hit3))
        elif query_shade is not None:
            # the same merged query, traced and shaded by the override
            occluded, info = query_shade(
                scene, light, subframe2, cat3(info_now.pos, ray_o),
                cat3(nee.light_dir, ray_dir), config.min_ray_dist,
                config.max_ray_dist, cat(nee.shadow_active, active), anyhit2, R,
            )
        else:
            # One ray query per bounce: the any-hit shadow ray and the
            # closest-hit bounce ray trace together (per-lane anyhit mask).
            # RNG order is untouched — both draws above happen before either
            # trace result is consumed.
            hit2, occ2 = ray_query(
                scene,
                tlas_count2,
                tlas_offset2,
                cat3(info_now.pos, ray_o),
                cat3(nee.light_dir, ray_dir),
                config.min_ray_dist,
                config.max_ray_dist,
                cat(nee.shadow_active, active),
                anyhit=anyhit2,
            )
            occluded = occ2[:R]
            bounce_hit = RayHit(*(a[R:] for a in hit2))
        if record:
            recs.append(_rec_of(bounce_hit, occluded))
            actives.append(active)
            shadows.append(nee.shadow_active)
        if query_shade is None:
            info = shade_hit(scene, light, bounce_hit, ray_o, ray_dir)
        if use_lights:
            contribution = contribution + where3(
                active,
                attenuation * arealights.area_nee_color(area, area_occluded, active),
                zero3,
            )

        nee_color = nee_finish(nee, light, info_now, occluded, active, config)
        contribution = contribution + where3(
            active, attenuation * nee_color, zero3
        )

        bsdf_pdf = sample.pdf
        # guarded divisions: pdf==0 lanes keep the reference's inf value
        # and take no gradient (inf is a where-constant)
        pdf_safe = torch.where(bsdf_pdf == 0, 1.0, bsdf_pdf)
        mis_pdf = torch.where(
            bsdf_pdf < 0,
            -bsdf_pdf,
            torch.where(
                bsdf_pdf == 0,
                math.inf,
                (info.nee_pdf * info.nee_pdf + bsdf_pdf * bsdf_pdf) / pdf_safe,
            ),
        )

        attenuation = where3(
            active, attenuation * sample.attenuation, attenuation
        )

        seed, atmo_att, in_scatter = atmosphere_scattering(
            seed, light.direction, light.color, ray_o, ray_dir, info.thit, active
        )

        inv_mis = torch.where(torch.isinf(mis_pdf), 0.0, 1.0 / mis_pdf)
        emission = info.emission
        if use_lights:
            # the light-sampling half of the MIS pair: emission found by BSDF
            # sampling is weighted down by the pdf with which
            # sample_area_light would have found the same point (delta lobes
            # keep full weight: NEE cannot sample them)
            pl = arealights.light_pdf_of_hit(
                scene, bounce_hit.inst, bounce_hit.prim, ray_dir, info.thit,
                bounce_hit.thit >= 0,
            )
            b2 = pdf_safe * pdf_safe
            denom = b2 + pl * pl
            w_area = torch.where(
                bsdf_pdf < 0,
                1.0,
                torch.where(denom > 0, b2 / torch.where(denom > 0, denom, 1.0), 1.0),
            )
            emission = emission * w_area
        contribution = contribution + where3(
            active,
            attenuation
            * (in_scatter + atmo_att * info.albedo * emission)
            * inv_mis,
            zero3,
        )
        inv_abs_pdf = torch.where(
            bsdf_pdf == 0, math.inf, 1.0 / torch.abs(pdf_safe)
        )
        attenuation = where3(
            active, attenuation * atmo_att * inv_abs_pdf, attenuation
        )

        # path-space regularization (reference: path_tracer.hh:734-737)
        regularization = torch.where(
            active & (bsdf_pdf > 0.0),
            regularization
            * maximum(
                1.0
                - gamma / torch.pow(torch.where(bsdf_pdf > 0, bsdf_pdf, 1.0), 0.25),
                0.0,
            ),
            regularization,
        )
        roughness = 1.0 - (1.0 - info.roughness) * regularization

    if not record:
        return contribution, None, None, None, None
    stack = lambda masks: torch.stack(masks) if masks else all_active[None][:0]
    return (contribution, prim_rec, _stack_records(recs, prim_rec), stack(actives),
            stack(shadows))
