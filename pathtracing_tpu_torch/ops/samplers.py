"""Sampling primitives (reference: path_tracer.hh:12-83), batched SoA."""

from __future__ import annotations

import math

import torch

from pathtracing_tpu_torch.utils.vec import (
    Mat3,
    Vec2,
    Vec3,
    c32,
    clamp,
    create_tangent_space,
    dot2,
    inv_erf,
    maximum,
    mix,
    where2,
)

_PI = c32(math.pi)
_SQRT2 = c32(1.41421356)


def sample_gaussian(u, sigma, epsilon):
    """reference: path_tracer.hh:12-17."""
    k = u * 2.0 - 1.0
    k = clamp(k, -(1.0 - epsilon), 1.0 - epsilon)
    return inv_erf(k) * c32(c32(sigma) * _SQRT2)


def sample_gaussian_weighted_disk(u: Vec2, sigma) -> Vec2:
    """Film anti-aliasing offset (reference: path_tracer.hh:19-25)."""
    r = torch.sqrt(u.x)
    theta = u.y * c32(2.0 * _PI)
    r = sample_gaussian(r, sigma, c32(1e-6))
    return Vec2(r * torch.cos(theta), r * torch.sin(theta))


def sample_cosine_hemisphere(u: Vec2) -> Vec3:
    """reference: path_tracer.hh:27-33."""
    r = torch.sqrt(u.x)
    theta = u.y * c32(2.0 * _PI)
    d = Vec2(r * torch.cos(theta), r * torch.sin(theta))
    return Vec3(d.x, d.y, torch.sqrt(maximum(1.0 - dot2(d, d), 0.0)))


def cosine_hemisphere_pdf(dir_z):
    """reference: path_tracer.hh:35-38."""
    return maximum(dir_z * c32(1.0 / _PI), 0.0)


def sample_cone(d: Vec3, cos_theta_min, u: Vec2) -> Vec3:
    """Sun-disk cone sample (reference: path_tracer.hh:40-48).

    At u.x == 0 (a real pcg4d output) cos_theta == 1 exactly; the sqrt takes
    a guarded operand there so the untaken branch never sees a negative."""
    cos_theta = mix(1.0, cos_theta_min, u.x)
    s2 = 1.0 - cos_theta * cos_theta
    pos = s2 > 0
    sin_theta = torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)
    phi = u.y * 2.0 * _PI
    ts: Mat3 = create_tangent_space(d)
    v = Vec3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta)
    return ts.mul_vec(v)  # mul_m3v3(tangent_space, v)


def sample_regular_polygon(u: Vec2, angle, sides) -> Vec2:
    """Aperture bokeh shape (reference: path_tracer.hh:50-62)."""
    side = torch.floor(u.x * sides)
    ux = u.x * sides
    ux = ux - torch.floor(ux)
    side_radians = c32(2.0 * _PI) / sides
    a1 = side_radians * side + angle
    a2 = side_radians * (side + 1.0) + angle
    b = Vec2(torch.sin(a1), torch.cos(a1))
    c = Vec2(torch.sin(a2), torch.cos(a2))
    uu = Vec2(ux, u.y)
    uu = where2(uu.x + uu.y > 1.0, 1.0 - uu, uu)
    return b * uu.x + c * uu.y


def sample_ggx_vndf(view: Vec3, roughness, u: Vec2) -> Vec3:
    """Visible-NDF GGX sampling, arXiv 2306.05044 listing
    (reference: path_tracer.hh:64-83). roughness<1e-3 => +Z (delta mirror).
    """
    vx = roughness * view.x
    vy = roughness * view.y
    vz = view.z
    l = torch.sqrt(vx * vx + vy * vy + vz * vz)
    v = Vec3(vx / l, vy / l, vz / l)

    phi = u.x * c32(2.0 * _PI)
    z = (1.0 - u.y) * (1.0 + v.z) - v.z  # fma in the reference
    z2 = 1.0 - z * z
    zpos = z2 > 0
    sin_theta = torch.where(
        zpos, torch.sqrt(clamp(torch.where(zpos, z2, 1.0), 0.0, 1.0)), 0.0
    )  # guarded operand; z == +-1 occurs at u.y in {0, 1}
    x = sin_theta * torch.cos(phi)
    y = sin_theta * torch.sin(phi)
    h = Vec3(x + v.x, y + v.y, z + v.z)

    hx = roughness * h.x
    hy = roughness * h.y
    hz = maximum(h.z, 0.0)
    l2 = torch.sqrt(hx * hx + hy * hy + hz * hz)
    l2 = torch.where(l2 == 0, 1.0, l2)
    out = Vec3(hx / l2, hy / l2, hz / l2)

    delta = roughness < 1e-3
    zero = torch.zeros_like(out.x)
    one = torch.ones_like(out.x)
    return Vec3(
        torch.where(delta, zero, out.x),
        torch.where(delta, zero, out.y),
        torch.where(delta, one, out.z),
    )
