"""The path-tracing integrator of the plain reference (reference:
path_tracer.hh:594-741), in plain PyTorch over a batch of samples.

One warm-up PCG4D step, one film/aperture draw, then per bounce an NEE
draw, with area lights a light draw, a BSDF draw and a conditional
atmosphere draw; lanes that miss or end stop drawing, as the reference's
scalar control flow does. Every ray query is the brute-force query of
``query.py``. ``counts`` (a dict) gathers the path's own events, the work
the roofline charges; ``lowp`` (a function that rounds a float tensor)
rounds the path's state at every bounce, the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from . import arealights, rng
from .bsdf import bsdf_eval, sample_bsdf
from .camera import camera_from_table, get_camera_ray
from .query import RayHit, instance_ray, query, tri_intersect, tri_preprocess, tri_vertices
from .samplers import sample_cone, sample_gaussian_weighted_disk
from .sky import atmosphere_attenuation, atmosphere_scattering
from .vec import (
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

EVENTS = ("samples", "rays", "shade_hits", "shade_misses", "atmo_marches",
          "nee_evals", "nee_marches", "bsdf_samples", "light_samples", "light_pdfs")


class LightParams(NamedTuple):
    direction: Vec3
    color: Vec3
    cos_solid_angle: Array


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


def _count(counts, name, mask):
    if counts is not None:
        counts[name] = counts.get(name, 0) + int(mask.sum())


def light_from_table(sf_light, idx) -> LightParams:
    l = sf_light[idx]
    return LightParams(
        direction=Vec3(l[:, 0], l[:, 1], l[:, 2]),
        color=Vec3(l[:, 3], l[:, 4], l[:, 5]),
        cos_solid_angle=l[:, 6],
    )


def shade_hit(frame, light: LightParams, hit: RayHit, origin: Vec3, d: Vec3) -> HitInfo:
    """Shading fetch for a closest hit (reference: path_tracer.hh:356-412)."""
    miss = hit.thit < 0

    # miss: the sun disk (reference: path_tracer.hh:356-366)
    visible = (dot3(light.direction, d) > light.cos_solid_angle).to(torch.float32)
    miss_nee_pdf = visible / ((1.0 - light.cos_solid_angle) * _TWO_PI)
    sun_scale = torch.where(miss_nee_pdf == 0.0, 1.0, miss_nee_pdf)
    miss_albedo = light.color * (visible * sun_scale)

    # hit: interpolate the vertex attributes; miss lanes read row 0
    iidx = torch.where(miss, 0, hit.inst)
    ui = frame.inst_u[iidx]
    fi = frame.inst_f[iidx]
    tri_row = ui[:, 4] + torch.where(miss, 0, hit.prim)
    ti = frame.tri_idx[tri_row]
    a0 = frame.vattr[ti[:, 0]]
    a1 = frame.vattr[ti[:, 1]]
    a2 = frame.vattr[ti[:, 2]]
    tp = frame.tri_pos[tri_row]

    # (u, v, t) from the hit ids by the same triangle test
    bo, bd = instance_ray(fi, origin, d)
    baxis, bS = tri_preprocess(bd)
    _, du, dv, dt, _ = tri_intersect(bo, baxis, bS, *tri_vertices(tp))
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

    # normal to world by the transform's 3x3 (reference: path_tracer.hh:371,392)
    nw = Vec3(
        fi[:, 12] * n.x + fi[:, 15] * n.y + fi[:, 18] * n.z,
        fi[:, 13] * n.x + fi[:, 16] * n.y + fi[:, 19] * n.z,
        fi[:, 14] * n.x + fi[:, 17] * n.y + fi[:, 20] * n.z,
    )
    nlen = length3(nw)
    one = torch.ones_like(nlen)
    nw = nw / torch.where(miss | (nlen == 0), one, nlen)
    nw = where3(miss, Vec3(one * 0.0, one * 0.0, one), nw)

    # IOR 1.5; a back face flips the normal (reference: path_tracer.hh:394-400)
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


def path_trace(cfg, frame, xs, ys, sample_index, counts=None, lowp=None) -> Vec3:
    """One radiance sample per lane (reference: path_tracer.hh:637-741).
    xs, ys, sample_index: int32 tensors on the frame's device."""
    q = (lambda t: t) if lowp is None else lowp
    q3 = lambda v: Vec3(q(v.x), q(v.y), q(v.z))
    use_lights = frame.lt_tris is not None
    dev = xs.device
    R = xs.shape[0]

    # ---- camera sample (reference: path_tracer.hh:655-672) ----
    subframe = torch.where(
        sample_index < 0, 0,
        torch.div(sample_index, cfg.samples_per_motion_blur_step, rounding_mode="floor"),
    ).to(torch.int32)
    seed = rng.Seed(xs.to(torch.int32), ys.to(torch.int32), sample_index.to(torch.int32),
                    torch.full_like(xs, cfg.student_id, dtype=torch.int32))
    seed = rng.pcg4d(seed)
    seed, u = rng.uniform4(seed)
    film = sample_gaussian_weighted_disk(Vec2(u.x, u.y), 0.4) + 0.5
    sub = subframe.clamp(0, frame.sf_cam.shape[0] - 1)
    cam = camera_from_table(frame.sf_cam, sub)
    light = light_from_table(frame.sf_light, sub)
    coord = Vec2(xs.to(torch.float32) + film.x, ys.to(torch.float32) + film.y)
    ray_dir, ray_o = get_camera_ray(cam, Vec2(u.z, u.w), coord, cfg.image_width,
                                    cfg.image_height)
    ray_dir, ray_o = q3(ray_dir), q3(ray_o)
    all_active = torch.ones(R, dtype=torch.bool, device=dev)
    _count(counts, "samples", all_active)

    def trace(org, d, tmin, tmax, active, anyhit, sub_):
        n = org.x.shape[0]
        full = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
        tmin = full(tmin) if not torch.is_tensor(tmin) else tmin
        tmax = full(tmax) if not torch.is_tensor(tmax) else tmax
        return query(frame, frame.clusters, org, d, tmin, tmax, active, anyhit, sub_)

    hit, _ = trace(ray_o, ray_dir, 0.0, 1e9, all_active,
                   torch.zeros(R, dtype=torch.bool, device=dev), sub)
    _count(counts, "rays", all_active)
    _count(counts, "shade_hits", hit.thit >= 0)
    _count(counts, "shade_misses", hit.thit < 0)
    info = shade_hit(frame, light, hit, ray_o, ray_dir)

    one = torch.ones_like(ray_dir.x)
    zero = torch.zeros_like(ray_dir.x)
    zero3 = Vec3(zero, zero, zero)
    attenuation = Vec3(one, one, one)
    contribution = zero3

    seed, attenuation, in_scatter, live = atmosphere_scattering(
        seed, light.direction, light.color, ray_o, ray_dir, info.thit, all_active)
    _count(counts, "atmo_marches", live)
    contribution = contribution + in_scatter + attenuation * info.albedo * info.emission

    regularization = one
    roughness = info.roughness
    active = all_active
    gamma = c32(cfg.path_space_regularization_gamma)
    cat3 = lambda *vs: Vec3(*(torch.cat([getattr(v, k) for v in vs]) for k in "xyz"))
    n_shadow = 2 if use_lights else 1
    sub_all = torch.cat([sub] * (n_shadow + 1))
    anyhit_all = torch.cat([torch.ones(n_shadow * R, dtype=torch.bool, device=dev),
                            torch.zeros(R, dtype=torch.bool, device=dev)])
    far = torch.full((R,), c32(cfg.max_ray_dist), dtype=torch.float32, device=dev)

    for _ in range(cfg.max_bounces):
        active = active & (info.thit > 0)

        # tangent-space view (reference: path_tracer.hh:700-702)
        view = info.tbn.vec_mul(-ray_dir)
        view = Vec3(view.x, view.y,
                    torch.where(view.z < 1e-7, maximum(view.z, 1e-7), view.z))
        view = normalize3(view)
        info_now = info._replace(roughness=roughness)

        # sun NEE up to the shadow ray (reference: path_tracer.hh:594-609)
        seed, un = rng.uniform4_masked(seed, active)
        light_dir = sample_cone(light.direction, light.cos_solid_angle, Vec2(un.x, un.y))
        nee_pdf = 1.0 / ((1.0 - light.cos_solid_angle) * _TWO_PI)
        tlight = info_now.tbn.vec_mul(light_dir)
        nee_color, nee_bsdf_pdf = bsdf_eval(
            tlight, view, info_now.albedo, info_now.roughness, info_now.metallic,
            info_now.transmission, info_now.eta)
        nee_color = nee_color * nee_pdf * light.color
        black = (nee_color.x == 0) & (nee_color.y == 0) & (nee_color.z == 0)
        shadow_active = active & torch.logical_not(black)
        _count(counts, "nee_evals", active)

        if use_lights:
            seed, ua = rng.uniform4_masked(seed, active)
            area = arealights.sample_area_light(frame, ua, info_now, view, active)
            _count(counts, "light_samples", active)

        seed, ub = rng.uniform4_masked(seed, active)
        sample = sample_bsdf(Vec3(ub.x, ub.y, ub.z), view, info_now.albedo,
                             info_now.roughness, info_now.metallic,
                             info_now.transmission, info_now.eta)
        _count(counts, "bsdf_samples", active)

        new_dir = normalize3(info.tbn.mul_vec(sample.direction))
        ray_dir = q3(where3(active, new_dir, ray_dir))
        ray_o = q3(where3(active, info.pos, ray_o))

        # the shadow rays and the bounce ray in one query
        if use_lights:
            orgs = cat3(info_now.pos, info_now.pos, ray_o)
            dirs = cat3(light_dir, area.wi, ray_dir)
            tmax = torch.cat([far, area.dist * c32(1.0 - 1e-3), far])
            acts = torch.cat([shadow_active, area.shadow_active, active])
        else:
            orgs = cat3(info_now.pos, ray_o)
            dirs = cat3(light_dir, ray_dir)
            tmax = torch.cat([far, far])
            acts = torch.cat([shadow_active, active])
        hit_all, occ_all = trace(orgs, dirs, c32(cfg.min_ray_dist), tmax, acts,
                                 anyhit_all, sub_all)
        occluded = occ_all[:R]
        _count(counts, "rays", acts)
        bounce_hit = RayHit(*(a[n_shadow * R:] for a in hit_all))
        _count(counts, "shade_hits", active & (bounce_hit.thit >= 0))
        _count(counts, "shade_misses", active & (bounce_hit.thit < 0))
        info = shade_hit(frame, light, bounce_hit, ray_o, ray_dir)
        if use_lights:
            area_occluded = occ_all[R:2 * R]
            contribution = contribution + where3(
                active,
                attenuation * arealights.area_nee_color(area, area_occluded, active),
                zero3)

        # sun NEE after the shadow ray (reference: path_tracer.hh:611-619)
        dead = black | occluded
        mis_pdf_n = torch.where(
            light.cos_solid_angle < 1.0,
            (nee_pdf * nee_pdf + nee_bsdf_pdf * nee_bsdf_pdf) / nee_pdf, 1.0)
        sun = nee_color * atmosphere_attenuation(
            un.w, info_now.pos, light_dir, torch.full_like(un.w, cfg.max_ray_dist))
        sun = sun / mis_pdf_n
        live_nee = active & torch.logical_not(dead)
        _count(counts, "nee_marches", live_nee)
        contribution = contribution + where3(
            active, attenuation * where3(live_nee, sun, zero3), zero3)

        bsdf_pdf = sample.pdf
        pdf_safe = torch.where(bsdf_pdf == 0, 1.0, bsdf_pdf)
        mis_pdf = torch.where(
            bsdf_pdf < 0, -bsdf_pdf,
            torch.where(bsdf_pdf == 0, math.inf,
                        (info.nee_pdf * info.nee_pdf + bsdf_pdf * bsdf_pdf) / pdf_safe))
        attenuation = where3(active, attenuation * sample.attenuation, attenuation)

        seed, atmo_att, in_scatter, live = atmosphere_scattering(
            seed, light.direction, light.color, ray_o, ray_dir, info.thit, active)
        _count(counts, "atmo_marches", live)

        inv_mis = torch.where(torch.isinf(mis_pdf), 0.0, 1.0 / mis_pdf)
        emission = info.emission
        if use_lights:
            # the BSDF half of the MIS pair for an emitter hit
            pl = arealights.light_pdf_of_hit(frame, bounce_hit.inst, bounce_hit.prim,
                                             ray_dir, info.thit, bounce_hit.thit >= 0)
            if counts is not None:
                hv = bounce_hit.thit >= 0
                si = torch.where(hv, bounce_hit.inst, 0)
                rank = frame.lt_rank[frame.inst_u[si, 4] + torch.where(hv, bounce_hit.prim, 0)]
                _count(counts, "light_pdfs", active & hv & (rank >= 0) & (frame.lt_seg[si] >= 0))
            b2 = pdf_safe * pdf_safe
            denom = b2 + pl * pl
            w_area = torch.where(
                bsdf_pdf < 0, 1.0,
                torch.where(denom > 0, b2 / torch.where(denom > 0, denom, 1.0), 1.0))
            emission = emission * w_area
        contribution = contribution + where3(
            active, attenuation * (in_scatter + atmo_att * info.albedo * emission) * inv_mis,
            zero3)
        inv_abs_pdf = torch.where(bsdf_pdf == 0, math.inf, 1.0 / torch.abs(pdf_safe))
        attenuation = where3(active, attenuation * atmo_att * inv_abs_pdf, attenuation)
        attenuation, contribution = q3(attenuation), q3(contribution)

        # path-space regularization (reference: path_tracer.hh:734-737)
        regularization = torch.where(
            active & (bsdf_pdf > 0.0),
            regularization * maximum(
                1.0 - gamma / torch.pow(torch.where(bsdf_pdf > 0, bsdf_pdf, 1.0), 0.25),
                0.0),
            regularization)
        roughness = 1.0 - (1.0 - info.roughness) * regularization

    return contribution


def render_pixels(cfg, frame, xs, ys, sample_base, spp: int, counts=None, lowp=None,
                  lanes: int = 1 << 15):
    """Average radiance of samples [sample_base, sample_base + spp) of each
    entry (int32 tensors xs, ys, sample_base: one pixel and its first
    sample per entry): (N, 3) float32, each entry's samples added in sample
    order from 0 and divided by spp. ``lanes``: samples traced in one
    batch."""
    n = xs.shape[0]
    dev = xs.device
    total = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    per = max(1, lanes // max(1, n))
    for a in range(0, spp, per):
        k = min(per, spp - a)
        px = xs.repeat(k)
        py = ys.repeat(k)
        si = (sample_base.repeat(k) + a
              + torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(n))
        c = path_trace(cfg, frame, px, py, si.to(torch.int32), counts=counts, lowp=lowp)
        for j in range(k):
            sl = slice(j * n, (j + 1) * n)
            total += torch.stack([c.x[sl], c.y[sl], c.z[sl]], -1)
    return total / torch.full((1,), spp, dtype=torch.float32, device=dev)
