"""Metallic/dielectric microfacet BSDF with GGX VNDF sampling
(reference: path_tracer.hh:89-296), batched SoA with branch-free selects.

The guarded-operand pattern is kept throughout: the untaken side of a select
never divides by zero or takes the root of a negative, so a later slice can
differentiate the same code."""

from __future__ import annotations

from typing import NamedTuple, Any

import math

import torch

from pathtracing_tpu_torch.ops.samplers import (
    cosine_hemisphere_pdf,
    sample_cosine_hemisphere,
    sample_ggx_vndf,
)
from pathtracing_tpu_torch.utils.vec import (
    Vec2,
    Vec3,
    c32,
    dot3,
    luminance,
    maximum,
    mix,
    normalize3_safe,
    reflect,
    refract,
    where3,
)

Array = Any
_PI = c32(math.pi)


def fresnel_schlick_bidir_attenuated(v_dot_h, f0, eta, roughness):
    """reference: path_tracer.hh:89-98."""
    sin_theta2 = eta * eta * (1.0 - v_dot_h * v_dot_h)
    tir = torch.logical_and(eta > 1.0, sin_theta2 >= 1.0)
    sin_safe = torch.where(sin_theta2 >= 1.0, 0.5, sin_theta2)  # guarded operand
    v_dot_h = torch.where(eta > 1.0, torch.sqrt(1.0 - sin_safe), v_dot_h)
    f = f0 + (maximum(1.0 - roughness, f0) - f0) * torch.pow(
        maximum(1.0 - v_dot_h, 0.0), 5.0
    )
    return torch.where(tir, 1.0, f)


def fresnel_schlick_bidir(v_dot_h, f0, eta):
    """reference: path_tracer.hh:100-103."""
    return fresnel_schlick_bidir_attenuated(
        v_dot_h, f0, eta, torch.zeros_like(v_dot_h)
    )


def trowbridge_reitz_distribution(hdotn, a):
    """GGX NDF (reference: path_tracer.hh:105-110)."""
    a2 = a * a
    denom = hdotn * hdotn * (a2 - 1.0) + 1.0
    return a2 / maximum(denom * _PI * denom, c32(1e-10))


def trowbridge_reitz_masking_shadowing(ldotn, ldoth, vdotn, vdoth, a):
    """Height-correlated Smith (reference: path_tracer.hh:112-123)."""
    bad = torch.logical_or(vdotn * vdoth < 0, ldotn * ldoth < 0)
    a2 = a * a
    denom = torch.abs(vdotn) * torch.sqrt(
        ldotn * ldotn - a2 * ldotn * ldotn + a2
    ) + torch.abs(ldotn) * torch.sqrt(vdotn * vdotn - a2 * vdotn * vdotn + a2)
    g = 0.5 / torch.where(denom == 0, 1.0, denom)
    return torch.where(bad | (denom == 0), 0.0, g)


def trowbridge_reitz_masking(vdotn, vdoth, a):
    """Separable G1 (reference: path_tracer.hh:125-129)."""
    bad = vdotn * vdoth < 0
    denom = vdotn + torch.sqrt(vdotn * vdotn * (1.0 - a * a) + a * a)
    g = 2.0 * vdotn / torch.where(denom == 0, 1.0, denom)
    return torch.where(bad | (denom == 0), 0.0, g)


class BsdfCore(NamedTuple):
    color: Vec3  # includes |ldotn|
    reflection_pdf: Array
    diffuse_pdf: Array
    transmission_pdf: Array


def bsdf_core(
    light: Vec3,
    h: Vec3,
    view: Vec3,
    albedo: Vec3,
    roughness,
    metallic,
    transmission,
    eta,
    f0,
    distribution,
) -> BsdfCore:
    """Combined BRDF/BTDF core (reference: path_tracer.hh:131-181)."""
    brdf = light.z > 0
    ldotn = light.z
    vdotn = view.z
    vdoth = dot3(view, h)
    ldoth = dot3(light, h)

    fresnel = fresnel_schlick_bidir(vdoth, f0, eta)
    geometry = trowbridge_reitz_masking_shadowing(
        ldotn, ldoth, vdotn, vdoth, roughness
    )
    g1 = trowbridge_reitz_masking(vdotn, vdoth, roughness)

    # BRDF branch (association matches the C expression exactly)
    spec = (albedo * metallic + fresnel * (1.0 - metallic)) * geometry * distribution
    diff = albedo * (
        (1.0 - fresnel) * (1.0 - metallic) * (1.0 - transmission) / _PI
    )
    brdf_color = spec + diff
    brdf_refl_pdf = g1 * distribution / (4.0 * view.z)
    brdf_diff_pdf = cosine_hemisphere_pdf(light.z)

    # BTDF branch (guarded: denom==0 lanes are pathological in the
    # reference too)
    denom = eta * vdoth + ldoth
    denom = torch.where(denom == 0, 1.0, denom)
    btdf_color = albedo * (
        transmission
        * torch.abs(vdoth * ldoth)
        * (1.0 - fresnel)
        * 4.0
        * geometry
        * distribution
        / (denom * denom)
    )
    btdf_pdf = (
        torch.abs(vdoth * ldoth)
        * g1
        * distribution
        / (torch.abs(view.z) * denom * denom)
    )

    zero = torch.zeros_like(ldotn)
    color = where3(brdf, brdf_color, btdf_color) * torch.abs(ldotn)
    return BsdfCore(
        color=color,
        reflection_pdf=torch.where(brdf, brdf_refl_pdf, zero),
        diffuse_pdf=torch.where(brdf, brdf_diff_pdf, zero),
        transmission_pdf=torch.where(brdf, zero, btdf_pdf),
    )


def _f0_of(eta):
    f0 = (1.0 - eta) / (1.0 + eta)
    return f0 * f0


def _lobe_probs(view_z, albedo: Vec3, roughness, metallic, transmission, eta, f0):
    """Lobe selection probabilities (reference: path_tracer.hh:202-207)."""
    reflection_prob = mix(
        1.0,
        fresnel_schlick_bidir_attenuated(view_z, f0, eta, roughness),
        luminance(albedo) * (1.0 - metallic),
    )
    transmission_prob = (1.0 - reflection_prob) * transmission
    diffuse_prob = (1.0 - reflection_prob) * (1.0 - transmission)
    return reflection_prob, transmission_prob, diffuse_prob


def bsdf_eval(
    light: Vec3,
    view: Vec3,
    albedo: Vec3,
    roughness,
    metallic,
    transmission,
    eta,
):
    """Tangent-space BSDF evaluation; returns (color, pdf)
    (reference: path_tracer.hh:184-222)."""
    refl = light.z > 0
    h_refl = normalize3_safe(view + light)
    h_trans = normalize3_safe(light + view * eta) * torch.sign(eta - 1.0)
    h = where3(refl, h_refl, h_trans)
    distribution = trowbridge_reitz_distribution(h.z, roughness)

    f0 = _f0_of(eta)
    rp, tp, dp = _lobe_probs(
        view.z, albedo, roughness, metallic, transmission, eta, f0
    )

    dist = torch.where(roughness < 1e-3, 0.0, distribution)
    core = bsdf_core(
        light, h, view, albedo, roughness, metallic, transmission, eta, f0, dist
    )
    pdf = (
        core.reflection_pdf * rp
        + core.diffuse_pdf * dp
        + core.transmission_pdf * tp
    )
    return core.color, pdf


class BsdfSample(NamedTuple):
    direction: Vec3
    attenuation: Vec3
    pdf: Array  # negative marks delta lobes (disables MIS downstream)


def sample_bsdf(
    u: Vec3,
    view: Vec3,
    albedo: Vec3,
    roughness,
    metallic,
    transmission,
    eta,
) -> BsdfSample:
    """Lobe pick + direction sample (reference: path_tracer.hh:224-296)."""
    h = sample_ggx_vndf(view, roughness, Vec2(u.x, u.y))

    f0 = _f0_of(eta)
    rp, tp, dp = _lobe_probs(
        view.z, albedo, roughness, metallic, transmission, eta, f0
    )

    # u.z subtraction chain (reference: path_tracer.hh:248-266)
    z1 = u.z - rp
    is_refl = z1 <= 0
    z2 = z1 - tp
    is_trans = torch.logical_and(torch.logical_not(is_refl), z2 <= 0)
    is_diff = torch.logical_not(torch.logical_or(is_refl, is_trans))

    d_refl = reflect(-view, h)
    d_trans = refract(-view, h, eta)
    d_diff = sample_cosine_hemisphere(Vec2(u.x, u.y))
    h_diff = normalize3_safe(d_diff + view)

    out_dir = where3(is_refl, d_refl, where3(is_trans, d_trans, d_diff))
    h_used = where3(is_diff, h_diff, h)
    bad = torch.where(
        is_refl,
        d_refl.z <= 0,
        torch.where(is_trans, d_trans.z >= 0, d_diff.z == 0),
    )

    distribution = trowbridge_reitz_distribution(h_used.z, roughness)
    delta = roughness < 1e-3
    distribution = torch.where(
        delta,
        torch.where(is_diff, 0.0, torch.abs(4.0 * out_dir.z * view.z)),
        distribution,
    )

    core = bsdf_core(
        out_dir, h_used, view, albedo, roughness, metallic, transmission, eta,
        f0, distribution,
    )
    pdf = core.reflection_pdf * rp + core.transmission_pdf * tp
    # Mark extremities with negative PDFs (reference: path_tracer.hh:291-295).
    pdf = torch.where(
        torch.logical_and(delta, torch.logical_not(is_diff)),
        -pdf,
        pdf + core.diffuse_pdf * dp,
    )

    zero = torch.zeros_like(pdf)
    one = torch.ones_like(pdf)
    return BsdfSample(
        direction=where3(bad, Vec3(zero, zero, one), out_dir),
        attenuation=where3(bad, Vec3(zero, zero, zero), core.color),
        pdf=torch.where(bad, one, pdf),
    )
