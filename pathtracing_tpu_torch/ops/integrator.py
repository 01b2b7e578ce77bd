"""The path-tracing integrator (reference: path_tracer.hh:594-741).

``path_trace_samples`` computes a batch of per-sample radiance values with
bit-faithful RNG threading: one warm-up PCG4D step, one film/aperture draw,
then per bounce an NEE draw, a BSDF draw, and a *conditional* atmosphere
draw — lanes that miss or terminate stop consuming their counters exactly
like the reference's scalar control flow.

The bounce loop is a Python loop (``max_bounces`` passes of the same body);
every bounce makes ONE merged ray query — the any-hit shadow ray and the
closest-hit bounce ray of each lane trace together in a 2R-lane batch with a
per-lane anyhit mask — with inactive lanes masked. On a CUDA device that
query is the hand-written kernel (ops/traversal.ray_query dispatches), and
nothing in the loop asks the device for a value: no ``.item()``, no
``.cpu()``.

Dead lanes carry inf/NaN by design, like the reference's dead paths: they are
masked at every accumulation, never cleaned, and never used as an index.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops import rng
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


def small_table_gather(table: Array, idx: Array) -> Array:
    """``table[idx]`` for the tiny per-subframe tables (sf_light (S,7),
    sf_cam (S,18)). Forward only: the JAX package's custom transpose of this
    gather comes with the gradient slice of the port."""
    return table[idx]


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

    Gathers the per-vertex tables (tri_idx, vattr, tri_pos). The packed
    ``tri_shade`` rows (``packed=True``) belong to the wide-BVH slice.
    """
    if packed:
        raise NotImplementedError(
            "shade_hit(packed=True) reads the tri_shade rows of the wide-BVH "
            "slice of the port"
        )
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
    fi = scene.inst_f[iidx]
    tri_row = ui[:, 4] + torch.where(miss, 0, hit.prim)
    ti = scene.tri_idx[tri_row]  # (R, 4) absolute vertex ids
    a012 = scene.vattr[ti[:, 0:3]]  # (R, 3, 12)
    a0 = a012[:, 0]
    a1 = a012[:, 1]
    a2 = a012[:, 2]

    # (u, v, t) re-derived at fixed topology from the hit ids, with the
    # same formulas as the ray query's own triangle test
    bo, bd = _instance_ray(fi, origin, d)
    baxis, bS = _tri_preprocess(bd)
    tp = scene.tri_pos[tri_row]  # (R, 12)
    _, du, dv, dt, _ = _tri_intersect(bo, baxis, bS, *_tri_vertices(tp))
    back = hit.back
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

    ``subframe`` must stay inside the scene's subframe rows (an index past
    them raises in PyTorch): build the scene with the config it is rendered
    with.

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

    cam = camera_from_table(scene.sf_cam, subframe)
    light = light_from_table(scene.sf_light, subframe)
    tlas_count = scene.sf_tlas_count[subframe]
    tlas_offset = scene.sf_tlas_offset[subframe]

    coord = Vec2(
        xs.to(torch.float32) + film.x, ys.to(torch.float32) + film.y
    )
    ray_dir, ray_o = get_camera_ray(
        cam, Vec2(u.z, u.w), coord, config.image_width, config.image_height
    )
    return seed, subframe, light, tlas_count, tlas_offset, ray_o, ray_dir


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

    This slice covers the default sun-NEE trace. The JAX package's
    ``query_shade`` override (geometry sharding), ``record``/``replay``
    (two-pass gradients) and area-light NEE (scenes packed with light
    tables) are later slices and raise NotImplementedError.
    """
    if query_shade is not None:
        raise NotImplementedError(
            "query_shade overrides come with the sharding slice of the port"
        )
    if record or replay is not None:
        raise NotImplementedError(
            "record/replay come with the gradient slice of the port"
        )
    if scene.lt_tris is not None:
        raise NotImplementedError(
            "area-light NEE comes with a later slice of the port"
        )

    seed, subframe, light, tlas_count, tlas_offset, ray_o, ray_dir = (
        camera_sample(config, scene, xs, ys, sample_index)
    )

    all_active = torch.ones_like(xs, dtype=torch.bool)
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
    cat3 = lambda a, b: Vec3(cat(a.x, b.x), cat(a.y, b.y), cat(a.z, b.z))
    R = xs.shape[0]
    # loop-invariant halves of the merged query's inputs
    tlas_count2 = cat(tlas_count, tlas_count)
    tlas_offset2 = cat(tlas_offset, tlas_offset)
    anyhit2 = cat(
        torch.ones(R, dtype=torch.bool, device=xs.device),
        torch.zeros(R, dtype=torch.bool, device=xs.device),
    )

    for _ in range(config.max_bounces):
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

        seed, u = rng.uniform4_masked(seed, active)
        sample = sample_bsdf(
            Vec3(u.x, u.y, u.z), view, info_now.albedo, info_now.roughness,
            info_now.metallic, info_now.transmission, info_now.eta,
        )

        new_dir = normalize3(info.tbn.mul_vec(sample.direction))
        new_o = info.pos
        ray_dir = where3(active, new_dir, ray_dir)
        ray_o = where3(active, new_o, ray_o)

        # One ray query per bounce: the any-hit shadow ray and the
        # closest-hit bounce ray trace together (per-lane anyhit mask). RNG
        # order is untouched — both draws above happen before either trace
        # result is consumed.
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
        info = shade_hit(scene, light, bounce_hit, ray_o, ray_dir)

        nee_color = nee_finish(nee, light, info_now, occluded, active, config)
        contribution = contribution + where3(
            active, attenuation * nee_color, zero3
        )

        bsdf_pdf = sample.pdf
        # guarded divisions: pdf==0 lanes keep the reference's inf value
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
        contribution = contribution + where3(
            active,
            attenuation
            * (in_scatter + atmo_att * info.albedo * info.emission)
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

    return contribution
