"""Nishita single-scattering atmosphere (reference: path_tracer.hh:456-588).

Fully unrolled 8x4 ray march, elementwise over the ray batch. The scattering
pass consumes one RNG draw per call *conditionally* — only when the ray hits
the atmosphere sphere and is not short-circuited by a near hit
(reference: path_tracer.hh:513-525) — replicated per lane with masked draws.
"""

from __future__ import annotations

import math

import torch

from .constants import (
    ATMOSPHERE_HEIGHT,
    ATMOSPHERE_MIE_ANISOTROPY,
    ATMOSPHERE_MIE_COEFFICIENT,
    ATMOSPHERE_MIE_SCALE_HEIGHT,
    ATMOSPHERE_PRIMARY_ITERATIONS,
    ATMOSPHERE_RAYLEIGH_COEFFICIENT,
    ATMOSPHERE_RAYLEIGH_SCALE_HEIGHT,
    ATMOSPHERE_SECONDARY_ITERATIONS,
    EARTH_RADIUS,
)
from . import rng
from .vec import Vec3, c32, dot3, length3, maximum, minimum, sqrt

# constants at their float32 values, as Python floats (see utils.vec.c32)
_MAX_RAY_DIST = c32(1e9)
_EARTH_R = c32(EARTH_RADIUS)
_ATMO_R = c32(EARTH_RADIUS + ATMOSPHERE_HEIGHT)
_RAY_COEF = Vec3(*(c32(c) for c in ATMOSPHERE_RAYLEIGH_COEFFICIENT))
_MIE_COEF = Vec3(*(c32(c) for c in ATMOSPHERE_MIE_COEFFICIENT))
_RAY_H = c32(ATMOSPHERE_RAYLEIGH_SCALE_HEIGHT)
_MIE_H = c32(ATMOSPHERE_MIE_SCALE_HEIGHT)
_G = c32(ATMOSPHERE_MIE_ANISOTROPY)
_PI = c32(math.pi)
# phase-function constants, folded in float32 in the reference's order
_RAYLEIGH_K = c32(3.0 / c32(16.0 * _PI))
_MIE_K = c32(c32(3.0 / c32(8.0 * _PI)) * c32(1.0 - c32(_G * _G)))
_MIE_D0 = c32(2.0 + c32(_G * _G))
_MIE_D1 = c32(1.0 + c32(_G * _G))
_MIE_D2 = c32(2.0 * _G)


def ray_sphere_intersection(origin: Vec3, d: Vec3, center: Vec3, radius):
    """reference: math.hh:404-417. Returns (hit, tmin, tmax).

    Guarded operand (ops/bsdf.py pattern): rays missing the sphere
    (disc <= 0) never reach the sqrt; the untaken side gets a dummy operand
    of 1. Forward values are unchanged (sq only feeds t-bounds that
    hit=False lanes mask out downstream)."""
    oc = origin - center
    b = dot3(oc, d)
    c = dot3(oc, oc) - radius * radius
    disc = b * b - c
    hit = disc > 0
    sq = torch.where(
        hit, sqrt(torch.where(hit, disc, 1.0)), 0.0
    )
    return disc >= 0, -b - sq, -b + sq


def _earth_origin(like):
    zero = torch.zeros_like(like)
    return Vec3(zero, zero - _EARTH_R, zero)


def atmosphere_attenuation(jitter, pos: Vec3, view: Vec3, tmax):
    """Sun transmittance along a shadow ray; no RNG consumption
    (reference: path_tracer.hh:456-497). iterations = 8."""
    earth = _earth_origin(pos.x)
    one = torch.ones_like(pos.x)

    hit, tmin, atmax = ray_sphere_intersection(pos, view, earth, _ATMO_R)
    tmin = maximum(tmin, 0.0)
    tmax = minimum(atmax, torch.where(tmax < 0, _MAX_RAY_DIST, tmax))

    iters = 8  # ATMOSPHERE_PRIMARY_ITERATIONS at the call site
    segment = (tmax - tmin) / iters
    ray_od = torch.zeros_like(pos.x)
    mie_od = torch.zeros_like(pos.x)
    shadowed = torch.zeros_like(hit)
    for i in range(iters):
        t = segment * (jitter + i)
        height = length3(pos + view * t - earth) - _EARTH_R
        shadowed = torch.logical_or(shadowed, height < 0)
        # clamp for the exponentials only: deep-underground samples would
        # produce exp(+inf); the unclamped height drives `shadowed`, so
        # forward values of all surviving lanes are identical
        # (reference: path_tracer.hh:479-485)
        height = maximum(height, -1e4)
        ray_od = ray_od + torch.exp(-height / _RAY_H)
        mie_od = mie_od + torch.exp(-height / _MIE_H)

    tau = (_RAY_COEF * ray_od + _MIE_COEF * mie_od) * segment
    att = Vec3(torch.exp(-tau.x), torch.exp(-tau.y), torch.exp(-tau.z))
    zero = torch.zeros_like(pos.x)
    att = Vec3(
        torch.where(shadowed, zero, att.x),
        torch.where(shadowed, zero, att.y),
        torch.where(shadowed, zero, att.z),
    )
    # miss => attenuation 1 (reference: path_tracer.hh:470-472)
    return Vec3(
        torch.where(hit, att.x, one),
        torch.where(hit, att.y, one),
        torch.where(hit, att.z, one),
    )


def atmosphere_scattering(
    seed: rng.Seed,
    light_dir: Vec3,
    light_color: Vec3,
    pos: Vec3,
    view: Vec3,
    tmax,
    active,
):
    """In-scatter + transmittance (reference: path_tracer.hh:499-588).

    Returns (seed, attenuation Vec3, in_scatter Vec3, live): the RNG draw,
    and the march, happen per lane iff ``live``: active AND not
    short-circuited AND the atmosphere sphere is hit — exactly the
    reference's consumption pattern.
    """
    earth = _earth_origin(pos.x)
    one = torch.ones_like(pos.x)
    zero = torch.zeros_like(pos.x)

    near_skip = torch.logical_and(tmax > 0, tmax < 1e3)
    hit, tmin, atmax = ray_sphere_intersection(pos, view, earth, _ATMO_R)
    tmin = maximum(tmin, 0.0)
    tmax = minimum(atmax, torch.where(tmax < 0, _MAX_RAY_DIST, tmax))

    live = torch.logical_and(active, torch.logical_and(torch.logical_not(near_skip), hit))
    seed, jitter = rng.uniform4_masked(seed, live)

    interval = tmax - tmin
    segment = interval / ATMOSPHERE_PRIMARY_ITERATIONS

    mu = dot3(view, light_dir)
    rayleigh_phase = (1.0 + mu * mu) * _RAYLEIGH_K
    mie_phase = (
        (1.0 + mu * mu)
        * _MIE_K
        / (torch.pow(_MIE_D1 - mu * _MIE_D2, 1.5) * _MIE_D0)
    )

    ray_od = zero
    mie_od = zero
    ray_sum = Vec3(zero, zero, zero)
    mie_sum = Vec3(zero, zero, zero)
    for i in range(ATMOSPHERE_PRIMARY_ITERATIONS):
        t = segment * (jitter.x + i)
        p = pos + view * t
        _, ltmin, ltmax = ray_sphere_intersection(p, light_dir, earth, _ATMO_R)
        light_segment = (ltmax - ltmin) / ATMOSPHERE_SECONDARY_ITERATIONS
        l_ray_od = zero
        l_mie_od = zero
        shadowed = torch.zeros_like(hit)
        for j in range(ATMOSPHERE_SECONDARY_ITERATIONS):
            lt = light_segment * (jitter.y + j)
            height = length3(p + light_dir * lt - earth) - _EARTH_R
            shadowed = torch.logical_or(shadowed, height < 0)
            height = maximum(height, -1e4)  # see attenuation note
            l_ray_od = l_ray_od + torch.exp(-height / _RAY_H)
            l_mie_od = l_mie_od + torch.exp(-height / _MIE_H)

        height = maximum(length3(p - earth) - _EARTH_R, 0.0)
        ray_density = torch.exp(-height / _RAY_H) * segment
        mie_density = torch.exp(-height / _MIE_H) * segment
        ray_od = ray_od + ray_density
        mie_od = mie_od + mie_density

        tau = _RAY_COEF * (l_ray_od * light_segment + ray_od) + _MIE_COEF * (
            l_mie_od * light_segment + mie_od
        )
        local_att = Vec3(torch.exp(-tau.x), torch.exp(-tau.y), torch.exp(-tau.z))
        local_att = Vec3(
            torch.where(shadowed, zero, local_att.x),
            torch.where(shadowed, zero, local_att.y),
            torch.where(shadowed, zero, local_att.z),
        )
        ray_sum = ray_sum + local_att * ray_density
        mie_sum = mie_sum + local_att * mie_density

    tau = _RAY_COEF * ray_od + _MIE_COEF * mie_od
    attenuation = Vec3(torch.exp(-tau.x), torch.exp(-tau.y), torch.exp(-tau.z))
    in_scatter = (
        ray_sum * _RAY_COEF * rayleigh_phase + mie_sum * _MIE_COEF * mie_phase
    ) * light_color * 4.0

    # Early-outs return attenuation=1, in_scatter=0
    # (reference: path_tracer.hh:510-521).
    attenuation = Vec3(
        torch.where(live, attenuation.x, one),
        torch.where(live, attenuation.y, one),
        torch.where(live, attenuation.z, one),
    )
    in_scatter = Vec3(
        torch.where(live, in_scatter.x, zero),
        torch.where(live, in_scatter.y, zero),
        torch.where(live, in_scatter.z, zero),
    )
    return seed, attenuation, in_scatter, live
