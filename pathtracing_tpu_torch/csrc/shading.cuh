// Device versions of the port's shading modules, for the path kernels
// (path.cuh: the megakernel K2 and the wavefront kernel K5).  Each function
// mirrors the tensor function named beside it, which is its plain version:
//   utils/vec.py       V3 arithmetic, normalize3, create_tangent_space, M3
//                      products, inv_erf
//   ops/rng.py         pcg4d, uniform4 (a masked draw is a plain `if` at the
//                      call site: the seed advances only when it is taken)
//   ops/camera.py      camera_from_table, get_camera_ray
//   ops/samplers.py    sample_gaussian_weighted_disk, sample_cone,
//                      sample_regular_polygon, sample_ggx_vndf, the cosine
//                      hemisphere
//   ops/bsdf.py        bsdf_eval, sample_bsdf and their helpers
//   ops/sky.py         ray_sphere_intersection, atmosphere_attenuation,
//                      atmosphere_scattering (8 primary x 4 secondary steps)
//   ops/integrator.py  light_from_table, shade_hit from the tri_shade row
//                      (packed=True) or from tri_idx, vattr and tri_pos,
//                      nee_prepare, nee_finish
//
// Parity rules, so that a sample agrees with the plain version to the last
// bit where the math library agrees:
//   * every expression keeps the tensor code's operand order and association
//     (the tensor code rounds after each op; this file is built with
//     --fmad=false, so nothing is contracted);
//   * constants are the tensor code's float32-rounded values (hex literals
//     where the tensor code folds them from float32 operands);
//   * torch.clamp / torch.maximum / torch.minimum propagate NaN, fminf/fmaxf
//     do not: clamp_min / clamp_max / max_nan / min_nan below;
//   * torch.pow keeps its exponent: powf(x, 5.0f), powf(x, 1.5f),
//     powf(x, 0.25f); no rsqrtf, __expf or __powf;
//   * torch.sign(x) is (0 < x) - (x < 0): 0 for NaN and for either zero;
//   * PyTorch's CUDA kernels divide a tensor by a Python scalar c as
//     t * (1 / c) (the reciprocal rounded once, on the host), and a Python
//     scalar by a tensor as reciprocal(t) * c on either device: both are
//     written so here (RECIP marks them), since the plain version on the
//     card is what the kernel is held to;
//   * a `torch.where(c, a, b)` whose untaken side has no effect is a branch
//     here, and the untaken side is not computed.
//
// This header's bytes are part of the path kernels' library hashes
// (ops/cuda_build.py): an edit here rebuilds them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ray_common.cuh"

namespace ptq {

// ------------------------------------------------------------- constants
// float32 values of the tensor code's constants; the formula beside each.
constexpr float kPi = 0x1.921fb6p+1f;           // c32(pi)
constexpr float kTwoPi = 0x1.921fb6p+2f;        // c32(2 * c32(pi))
constexpr float kInvPi = 0x1.45f306p-2f;        // c32(1 / c32(pi))
constexpr float kSigmaSqrt2 = 0x1.21a186p-1f;   // c32(c32(0.4) * c32(1.41421356))
constexpr float kGaussHi = 0x1.ffffdep-1f;      // 1 - c32(1e-6)
constexpr float kTangentThr = 0x1.279a74p-1f;   // c32(0.57735026918962576451)
constexpr float kIor = 1.5f;
constexpr float kInvIor = 0x1.555556p-1f;       // c32(1 / 1.5)
constexpr float kEarthR = 6378100.0f;
constexpr float kAtmoR = 6478100.0f;            // EARTH_RADIUS + ATMOSPHERE_HEIGHT
constexpr float kRayCx = 5.8e-6f, kRayCy = 13.6e-6f, kRayCz = 33.1e-6f;
constexpr float kMieC = 4.0e-6f;
constexpr float kRayH = 7994.0f, kMieH = 1200.0f;
// RECIP: -height / H is -height * (1 / H)
constexpr float kInvRayH = 1.0f / kRayH, kInvMieH = 1.0f / kMieH;
constexpr float kRayleighK = 0x1.e8ec8ap-5f;    // c32(3 / c32(16 pi))
constexpr float kMieK = 0x1.600674p-5f;         // c32(3 / c32(8 pi)) * c32(1 - g^2)
constexpr float kMieD0 = 0x1.51eb86p+1f;        // c32(2 + c32(g^2)), g = 0.8
constexpr float kMieD1 = 0x1.a3d70cp+0f;        // c32(1 + c32(g^2))
constexpr float kMieD2 = 0x1.99999ap+0f;        // c32(2 g)
constexpr float kErfP = 0x1.152af4p+2f;         // f32(2) / (f32(pi) * f32(0.147))
constexpr float kErfInvA = 0x1.b35fc8p+2f;      // f32(1) / f32(0.147)
constexpr float kMaxRayDist = 1e9f;             // ops/sky.py _MAX_RAY_DIST
constexpr int kPrimaryIters = 8;                // ATMOSPHERE_PRIMARY_ITERATIONS
constexpr int kSecondaryIters = 4;              // ATMOSPHERE_SECONDARY_ITERATIONS

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// ------------------------------------------------------ utils/vec.py
struct V2 { float x, y; };
struct F4 { float x, y, z, w; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

// torch.clamp(x, min=lo) / (x, max=hi), as PyTorch's CUDA kernels compute
// them: NaN stays NaN, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }
// torch.maximum / torch.minimum of two tensors: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float sign_t(float x) {
    return (float)((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length3(V3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ V3 normalize3(V3 a) { return a / length3(a); }
__device__ __forceinline__ V3 normalize3_safe(V3 a) {
    float l = length3(a);
    l = l == 0.0f ? 1.0f : l;
    return a / l;
}

// Row-major 3x3 of rows (utils/vec.py Mat3).
struct M3 {
    V3 r0, r1, r2;
    // mul_m3v3(m, v): column-vector product
    __device__ __forceinline__ V3 mul_vec(V3 v) const {
        return {r0.x * v.x + r1.x * v.y + r2.x * v.z,
                r0.y * v.x + r1.y * v.y + r2.y * v.z,
                r0.z * v.x + r1.z * v.y + r2.z * v.z};
    }
    // mul_v3m3(v, m): rows . v
    __device__ __forceinline__ V3 vec_mul(V3 v) const {
        return {dot3(r0, v), dot3(r1, v), dot3(r2, v)};
    }
};

// Rows {tangent, bitangent, normal} (reference: math.hh:419-435).
__device__ __forceinline__ M3 create_tangent_space(V3 n) {
    const bool use_x = fabsf(n.x) < kTangentThr;
    const bool use_y = !use_x && fabsf(n.y) < kTangentThr;
    const V3 major = {use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f,
                      (use_x || use_y) ? 0.0f : 1.0f};
    const V3 tangent = normalize3(cross(n, major));
    return {tangent, cross(n, tangent), n};
}

// Winitzki, a = 0.147 (reference: math.hh:455-463).
__device__ __forceinline__ float inv_erf(float x) {
    const float ln1x2 = logf(1.0f - x * x);
    const float k = ln1x2 * 0.5f + kErfP;
    const float k2 = k * k;
    return sign_t(x) * sqrtf(sqrtf(k2 - ln1x2 * kErfInvA) - k);
}

// ------------------------------------------------------ ops/rng.py
struct Seed { uint32_t x, y, z, w; };

__device__ __forceinline__ Seed pcg4d(Seed s) {
    uint32_t x = s.x * 1664525u + 1013904223u;
    uint32_t y = s.y * 1664525u + 1013904223u;
    uint32_t z = s.z * 1664525u + 1013904223u;
    uint32_t w = s.w * 1664525u + 1013904223u;
    // seed += seed.yzxy * seed.wxyz (simultaneous)
    uint32_t x2 = x + y * w, y2 = y + z * x, z2 = z + x * y, w2 = w + y * z;
    x2 ^= x2 >> 16;
    y2 ^= y2 >> 16;
    z2 ^= z2 >> 16;
    w2 ^= w2 >> 16;
    return {x2 + y2 * w2, y2 + z2 * x2, z2 + x2 * y2, w2 + y2 * z2};
}

// (float)uint32 rounded once, times 2^-32 (exact)
__device__ __forceinline__ float u32_to_f(uint32_t v) { return __uint2float_rn(v) * 0x1p-32f; }

// generate_uniform_random4: advance the seed, return its four words as floats.
__device__ __forceinline__ F4 uniform4(Seed& s) {
    s = pcg4d(s);
    return {u32_to_f(s.x), u32_to_f(s.y), u32_to_f(s.z), u32_to_f(s.w)};
}

// ------------------------------------------------------ ops/samplers.py
__device__ __forceinline__ V2 sample_gaussian_weighted_disk_04(float ux, float uy) {
    float r = sqrtf(ux);
    const float theta = uy * kTwoPi;
    // sample_gaussian(r, 0.4, 1e-6)
    float k = r * 2.0f - 1.0f;
    k = clamp_max(clamp_min(k, -kGaussHi), kGaussHi);
    r = inv_erf(k) * kSigmaSqrt2;
    return {r * cosf(theta), r * sinf(theta)};
}

__device__ __forceinline__ V3 sample_cosine_hemisphere(float ux, float uy) {
    const float r = sqrtf(ux);
    const float theta = uy * kTwoPi;
    const float dx = r * cosf(theta), dy = r * sinf(theta);
    return {dx, dy, sqrtf(clamp_min(1.0f - (dx * dx + dy * dy), 0.0f))};
}

__device__ __forceinline__ float cosine_hemisphere_pdf(float z) {
    return clamp_min(z * kInvPi, 0.0f);
}

// Sun-disk cone sample (reference: path_tracer.hh:40-48).
__device__ __forceinline__ V3 sample_cone(V3 d, float cos_theta_min, float ux, float uy) {
    const float cos_theta = (1.0f - ux) + cos_theta_min * ux;  // mix(1, c, u.x)
    const float s2 = 1.0f - cos_theta * cos_theta;
    const float sin_theta = s2 > 0.0f ? sqrtf(s2) : 0.0f;
    const float phi = uy * 2.0f * kPi;
    const M3 ts = create_tangent_space(d);
    return ts.mul_vec({cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta});
}

// Aperture bokeh shape (reference: path_tracer.hh:50-62).
__device__ __forceinline__ V2 sample_regular_polygon(float ux0, float uy, float angle,
                                                     float sides) {
    const float side = floorf(ux0 * sides);
    float ux = ux0 * sides;
    ux = ux - floorf(ux);
    const float side_radians = (1.0f / sides) * kTwoPi;  // RECIP: c / t
    const float a1 = side_radians * side + angle;
    const float a2 = side_radians * (side + 1.0f) + angle;
    const V2 b = {sinf(a1), cosf(a1)}, c = {sinf(a2), cosf(a2)};
    V2 uu = {ux, uy};
    if (uu.x + uu.y > 1.0f) uu = {1.0f - uu.x, 1.0f - uu.y};
    return {b.x * uu.x + c.x * uu.y, b.y * uu.x + c.y * uu.y};
}

// Visible-NDF GGX sampling (reference: path_tracer.hh:64-83).
__device__ __forceinline__ V3 sample_ggx_vndf(V3 view, float roughness, float ux, float uy) {
    if (roughness < 1e-3f) return {0.0f, 0.0f, 1.0f};  // delta mirror
    const float vx = roughness * view.x;
    const float vy = roughness * view.y;
    const float vz = view.z;
    const float l = sqrtf(vx * vx + vy * vy + vz * vz);
    const V3 v = {vx / l, vy / l, vz / l};
    const float phi = ux * kTwoPi;
    const float z = (1.0f - uy) * (1.0f + v.z) - v.z;
    const float z2 = 1.0f - z * z;
    const float sin_theta = z2 > 0.0f ? sqrtf(clamp_max(clamp_min(z2, 0.0f), 1.0f)) : 0.0f;
    const float x = sin_theta * cosf(phi);
    const float y = sin_theta * sinf(phi);
    const V3 h = {x + v.x, y + v.y, z + v.z};
    const float hx = roughness * h.x;
    const float hy = roughness * h.y;
    const float hz = clamp_min(h.z, 0.0f);
    float l2 = sqrtf(hx * hx + hy * hy + hz * hz);
    l2 = l2 == 0.0f ? 1.0f : l2;
    return {hx / l2, hy / l2, hz / l2};
}

// ------------------------------------------------------ ops/bsdf.py
__device__ __forceinline__ float fresnel_schlick_bidir_attenuated(
    float v_dot_h, float f0, float eta, float roughness) {
    const float sin_theta2 = eta * eta * (1.0f - v_dot_h * v_dot_h);
    const bool tir = eta > 1.0f && sin_theta2 >= 1.0f;
    const float sin_safe = sin_theta2 >= 1.0f ? 0.5f : sin_theta2;
    const float vdh = eta > 1.0f ? sqrtf(1.0f - sin_safe) : v_dot_h;
    const float f = f0 + (max_nan(1.0f - roughness, f0) - f0) *
                             powf(clamp_min(1.0f - vdh, 0.0f), 5.0f);
    return tir ? 1.0f : f;
}

__device__ __forceinline__ float trowbridge_reitz_distribution(float hdotn, float a) {
    const float a2 = a * a;
    const float denom = hdotn * hdotn * (a2 - 1.0f) + 1.0f;
    return a2 / clamp_min(denom * kPi * denom, 1e-10f);
}

__device__ __forceinline__ float trowbridge_reitz_masking_shadowing(
    float ldotn, float ldoth, float vdotn, float vdoth, float a) {
    const bool bad = vdotn * vdoth < 0.0f || ldotn * ldoth < 0.0f;
    const float a2 = a * a;
    const float denom =
        fabsf(vdotn) * sqrtf(ldotn * ldotn - a2 * ldotn * ldotn + a2) +
        fabsf(ldotn) * sqrtf(vdotn * vdotn - a2 * vdotn * vdotn + a2);
    const float g = (1.0f / (denom == 0.0f ? 1.0f : denom)) * 0.5f;  // RECIP: c / t
    return (bad || denom == 0.0f) ? 0.0f : g;
}

__device__ __forceinline__ float trowbridge_reitz_masking(float vdotn, float vdoth, float a) {
    const bool bad = vdotn * vdoth < 0.0f;
    const float denom = vdotn + sqrtf(vdotn * vdotn * (1.0f - a * a) + a * a);
    const float g = 2.0f * vdotn / (denom == 0.0f ? 1.0f : denom);
    return (bad || denom == 0.0f) ? 0.0f : g;
}

struct Material {
    V3 albedo;
    float roughness, metallic, transmission, eta;
};

struct BsdfCore {
    V3 color;  // includes |ldotn|
    float reflection_pdf, diffuse_pdf, transmission_pdf;
};

// Combined BRDF/BTDF core (reference: path_tracer.hh:131-181).
__device__ __forceinline__ BsdfCore bsdf_core(V3 light, V3 h, V3 view, const Material& m,
                                              float f0, float distribution) {
    const bool brdf = light.z > 0.0f;
    const float ldotn = light.z, vdotn = view.z;
    const float vdoth = dot3(view, h);
    const float ldoth = dot3(light, h);
    const float fresnel = fresnel_schlick_bidir_attenuated(vdoth, f0, m.eta, 0.0f);
    const float geometry =
        trowbridge_reitz_masking_shadowing(ldotn, ldoth, vdotn, vdoth, m.roughness);
    const float g1 = trowbridge_reitz_masking(vdotn, vdoth, m.roughness);
    BsdfCore c;
    V3 color;
    if (brdf) {
        const float fm = fresnel * (1.0f - m.metallic);
        const V3 am = m.albedo * m.metallic;
        const V3 spec = V3{am.x + fm, am.y + fm, am.z + fm} * geometry * distribution;
        // RECIP: t / pi is t * c32(1 / pi)
        const V3 diff = m.albedo * ((1.0f - fresnel) * (1.0f - m.metallic) *
                                    (1.0f - m.transmission) * kInvPi);
        color = spec + diff;
        c.reflection_pdf = g1 * distribution / (4.0f * view.z);
        c.diffuse_pdf = cosine_hemisphere_pdf(light.z);
        c.transmission_pdf = 0.0f;
    } else {
        float denom = m.eta * vdoth + ldoth;
        denom = denom == 0.0f ? 1.0f : denom;
        const float vl = fabsf(vdoth * ldoth);
        color = m.albedo * (m.transmission * vl * (1.0f - fresnel) * 4.0f * geometry *
                            distribution / (denom * denom));
        c.reflection_pdf = 0.0f;
        c.diffuse_pdf = 0.0f;
        c.transmission_pdf = vl * g1 * distribution / (fabsf(view.z) * denom * denom);
    }
    c.color = color * fabsf(ldotn);
    return c;
}

__device__ __forceinline__ float f0_of(float eta) {
    const float f0 = (1.0f - eta) / (1.0f + eta);
    return f0 * f0;
}

// Lobe selection probabilities (reference: path_tracer.hh:202-207).
__device__ __forceinline__ void lobe_probs(float view_z, const Material& m, float f0,
                                           float& rp, float& tp, float& dp) {
    const float lum = m.albedo.x * 0.2126f + m.albedo.y * 0.7152f + m.albedo.z * 0.0722f;
    const float t = lum * (1.0f - m.metallic);
    rp = (1.0f - t) + fresnel_schlick_bidir_attenuated(view_z, f0, m.eta, m.roughness) * t;
    tp = (1.0f - rp) * m.transmission;
    dp = (1.0f - rp) * (1.0f - m.transmission);
}

// Tangent-space BSDF evaluation (reference: path_tracer.hh:184-222).
__device__ __forceinline__ void bsdf_eval(V3 light, V3 view, const Material& m, V3& color,
                                          float& pdf) {
    V3 h;
    if (light.z > 0.0f) {
        h = normalize3_safe(view + light);
    } else {
        h = normalize3_safe(light + view * m.eta) * sign_t(m.eta - 1.0f);
    }
    const float f0 = f0_of(m.eta);
    float rp, tp, dp;
    lobe_probs(view.z, m, f0, rp, tp, dp);
    const float dist =
        m.roughness < 1e-3f ? 0.0f : trowbridge_reitz_distribution(h.z, m.roughness);
    const BsdfCore core = bsdf_core(light, h, view, m, f0, dist);
    pdf = core.reflection_pdf * rp + core.diffuse_pdf * dp + core.transmission_pdf * tp;
    color = core.color;
}

struct BsdfSample {
    V3 direction, attenuation;
    float pdf;  // negative marks delta lobes (disables MIS downstream)
};

// reference: math.hh:442-453
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return i - n * (2.0f * dot3(n, i)); }
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
    const float ndoti = dot3(n, i);
    const float k = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
    if (k < 0.0f) return {0.0f, 0.0f, 0.0f};  // total internal reflection
    return i * eta - n * (eta * ndoti + sqrtf(k));
}

// Lobe pick + direction sample (reference: path_tracer.hh:224-296).
__device__ __forceinline__ BsdfSample sample_bsdf(float ux, float uy, float uz, V3 view,
                                                  const Material& m) {
    const V3 h = sample_ggx_vndf(view, m.roughness, ux, uy);
    const float f0 = f0_of(m.eta);
    float rp, tp, dp;
    lobe_probs(view.z, m, f0, rp, tp, dp);
    const float z1 = uz - rp;
    const bool is_refl = z1 <= 0.0f;
    const float z2 = z1 - tp;
    const bool is_trans = !is_refl && z2 <= 0.0f;
    const bool is_diff = !(is_refl || is_trans);

    V3 out_dir, h_used;
    bool bad;
    if (is_refl) {
        out_dir = reflect(-view, h);
        h_used = h;
        bad = out_dir.z <= 0.0f;
    } else if (is_trans) {
        out_dir = refract(-view, h, m.eta);
        h_used = h;
        bad = out_dir.z >= 0.0f;
    } else {
        out_dir = sample_cosine_hemisphere(ux, uy);
        h_used = normalize3_safe(out_dir + view);
        bad = out_dir.z == 0.0f;
    }
    const bool delta = m.roughness < 1e-3f;
    float distribution;
    if (delta) {
        distribution = is_diff ? 0.0f : fabsf(4.0f * out_dir.z * view.z);
    } else {
        distribution = trowbridge_reitz_distribution(h_used.z, m.roughness);
    }
    const BsdfCore core = bsdf_core(out_dir, h_used, view, m, f0, distribution);
    float pdf = core.reflection_pdf * rp + core.transmission_pdf * tp;
    // mark extremities with negative PDFs (reference: path_tracer.hh:291-295)
    pdf = (delta && !is_diff) ? -pdf : pdf + core.diffuse_pdf * dp;
    if (bad) return {{0.0f, 0.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, 1.0f};
    return {out_dir, core.color, pdf};
}

// ------------------------------------------------------ ops/camera.py
struct Camera {
    M3 orientation;
    V3 position;
    float aspect_ratio, inv_focal_length, focal_distance, aperture_angle,
        aperture_polygon, aperture_radius;
};

__device__ __forceinline__ Camera camera_from_row(const float* __restrict__ c) {
    Camera cam;
    cam.orientation = {{__ldg(c + 0), __ldg(c + 1), __ldg(c + 2)},
                       {__ldg(c + 3), __ldg(c + 4), __ldg(c + 5)},
                       {__ldg(c + 6), __ldg(c + 7), __ldg(c + 8)}};
    cam.position = {__ldg(c + 9), __ldg(c + 10), __ldg(c + 11)};
    cam.aspect_ratio = __ldg(c + 12);
    cam.inv_focal_length = __ldg(c + 13);
    cam.focal_distance = __ldg(c + 14);
    cam.aperture_angle = __ldg(c + 15);
    cam.aperture_polygon = __ldg(c + 16);
    cam.aperture_radius = __ldg(c + 17);
    return cam;
}

// Thin-lens camera ray (reference: path_tracer.hh:429-450).
__device__ __forceinline__ void get_camera_ray(const Camera& cam, float ux, float uy,
                                               float cx, float cy, int width, int height,
                                               V3& d, V3& origin) {
    // RECIP: coord / image_width is coord * (1 / width)
    float uvx = cx * (1.0f / (float)width) * 2.0f - 1.0f;
    float uvy = cy * (1.0f / (float)height) * 2.0f - 1.0f;
    uvx = uvx * cam.aspect_ratio;
    uvy = -uvy;
    V2 ap = {0.0f, 0.0f};
    if (cam.aperture_polygon > 3.0f) {
        const V2 poly =
            sample_regular_polygon(ux, uy, cam.aperture_angle, cam.aperture_polygon);
        ap = {poly.x * cam.aperture_radius, poly.y * cam.aperture_radius};
    }
    const V3 o = {ap.x, ap.y, 0.0f};
    V3 dd = V3{uvx * cam.inv_focal_length, uvy * cam.inv_focal_length, -1.0f} *
            cam.focal_distance;
    dd = normalize3(dd - o);
    d = cam.orientation.mul_vec(dd);
    origin = cam.orientation.mul_vec(o) + cam.position;
}

// ------------------------------------------------------ ops/sky.py
// reference: math.hh:404-417; returns disc >= 0, and the two t's.
__device__ __forceinline__ bool ray_sphere_intersection(V3 origin, V3 d, float& t0,
                                                        float& t1) {
    // oc = origin - (0, -R_earth, 0)
    const V3 oc = {origin.x - 0.0f, origin.y - (-kEarthR), origin.z - 0.0f};
    const float b = dot3(oc, d);
    const float c = dot3(oc, oc) - kAtmoR * kAtmoR;
    const float disc = b * b - c;
    const float sq = disc > 0.0f ? sqrtf(disc) : 0.0f;
    t0 = -b - sq;
    t1 = -b + sq;
    return disc >= 0.0f;
}

// Height above the earth's surface of p (length3(p - earth) - R_earth).
__device__ __forceinline__ float height_of(V3 p) {
    return length3(V3{p.x - 0.0f, p.y - (-kEarthR), p.z - 0.0f}) - kEarthR;
}

// Sun transmittance along a shadow ray, 8 steps; no RNG
// (reference: path_tracer.hh:456-497).
__device__ __forceinline__ V3 atmosphere_attenuation(float jitter, V3 pos, V3 view,
                                                     float tmax) {
    float tmin, atmax;
    const bool hit = ray_sphere_intersection(pos, view, tmin, atmax);
    if (!hit) return {1.0f, 1.0f, 1.0f};  // miss => attenuation 1
    tmin = clamp_min(tmin, 0.0f);
    tmax = min_nan(atmax, tmax < 0.0f ? kMaxRayDist : tmax);
    const float segment = (tmax - tmin) * (1.0f / 8.0f);  // RECIP (exact)
    float ray_od = 0.0f, mie_od = 0.0f;
    bool shadowed = false;
    for (int i = 0; i < 8; ++i) {
        const float t = segment * (jitter + (float)i);
        float height = height_of(pos + view * t);
        shadowed = shadowed || height < 0.0f;
        height = clamp_min(height, -1e4f);
        ray_od = ray_od + expf(-height * kInvRayH);
        mie_od = mie_od + expf(-height * kInvMieH);
    }
    if (shadowed) return {0.0f, 0.0f, 0.0f};
    return {expf(-((kRayCx * ray_od + kMieC * mie_od) * segment)),
            expf(-((kRayCy * ray_od + kMieC * mie_od) * segment)),
            expf(-((kRayCz * ray_od + kMieC * mie_od) * segment))};
}

// In-scatter + transmittance of a closest ray, with its conditional draw
// (reference: path_tracer.hh:499-588): the seed advances iff the ray is not
// short-circuited by a near hit and meets the atmosphere sphere (the caller
// calls it only for a live path).  Returns whether it marched.
__device__ __forceinline__ bool atmosphere_scattering(Seed& seed, V3 light_dir,
                                                      V3 light_color, V3 pos, V3 view,
                                                      float tmax, V3& attenuation,
                                                      V3& in_scatter) {
    attenuation = {1.0f, 1.0f, 1.0f};
    in_scatter = {0.0f, 0.0f, 0.0f};
    const bool near_skip = tmax > 0.0f && tmax < 1e3f;
    float tmin, atmax;
    const bool hit = ray_sphere_intersection(pos, view, tmin, atmax);
    if (near_skip || !hit) return false;
    const F4 jitter = uniform4(seed);
    tmin = clamp_min(tmin, 0.0f);
    tmax = min_nan(atmax, tmax < 0.0f ? kMaxRayDist : tmax);
    const float segment = (tmax - tmin) * (1.0f / (float)kPrimaryIters);  // RECIP (exact)

    const float mu = dot3(view, light_dir);
    const float rayleigh_phase = (1.0f + mu * mu) * kRayleighK;
    const float mie_phase =
        (1.0f + mu * mu) * kMieK / (powf(kMieD1 - mu * kMieD2, 1.5f) * kMieD0);

    float ray_od = 0.0f, mie_od = 0.0f;
    V3 ray_sum = {0.0f, 0.0f, 0.0f}, mie_sum = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < kPrimaryIters; ++i) {
        const float t = segment * (jitter.x + (float)i);
        const V3 p = pos + view * t;
        float ltmin, ltmax;
        ray_sphere_intersection(p, light_dir, ltmin, ltmax);
        const float light_segment =
            (ltmax - ltmin) * (1.0f / (float)kSecondaryIters);  // RECIP (exact)
        float l_ray_od = 0.0f, l_mie_od = 0.0f;
        bool shadowed = false;
        for (int j = 0; j < kSecondaryIters; ++j) {
            const float lt = light_segment * (jitter.y + (float)j);
            float height = height_of(p + light_dir * lt);
            shadowed = shadowed || height < 0.0f;
            height = clamp_min(height, -1e4f);
            l_ray_od = l_ray_od + expf(-height * kInvRayH);
            l_mie_od = l_mie_od + expf(-height * kInvMieH);
        }
        const float height = clamp_min(height_of(p), 0.0f);
        const float ray_density = expf(-height * kInvRayH) * segment;
        const float mie_density = expf(-height * kInvMieH) * segment;
        ray_od = ray_od + ray_density;
        mie_od = mie_od + mie_density;
        if (!shadowed) {
            const float lr = l_ray_od * light_segment + ray_od;
            const float lm = l_mie_od * light_segment + mie_od;
            const V3 local_att = {expf(-(kRayCx * lr + kMieC * lm)),
                                  expf(-(kRayCy * lr + kMieC * lm)),
                                  expf(-(kRayCz * lr + kMieC * lm))};
            ray_sum = ray_sum + local_att * ray_density;
            mie_sum = mie_sum + local_att * mie_density;
        } else {
            // a shadowed step adds local_att = 0: 0 * density
            ray_sum = ray_sum + V3{0.0f, 0.0f, 0.0f} * ray_density;
            mie_sum = mie_sum + V3{0.0f, 0.0f, 0.0f} * mie_density;
        }
    }
    attenuation = {expf(-(kRayCx * ray_od + kMieC * mie_od)),
                   expf(-(kRayCy * ray_od + kMieC * mie_od)),
                   expf(-(kRayCz * ray_od + kMieC * mie_od))};
    const V3 ray_c = {kRayCx, kRayCy, kRayCz};
    const V3 mie_c = {kMieC, kMieC, kMieC};
    in_scatter = (ray_sum * ray_c * rayleigh_phase + mie_sum * mie_c * mie_phase) *
                 light_color * 4.0f;
    return true;
}

// ------------------------------------------------------ ops/integrator.py
struct Light {
    V3 direction, color;
    float cos_solid_angle;
};

__device__ __forceinline__ Light light_from_row(const float* __restrict__ l) {
    return {{__ldg(l + 0), __ldg(l + 1), __ldg(l + 2)},
            {__ldg(l + 3), __ldg(l + 4), __ldg(l + 5)},
            __ldg(l + 6)};
}

// HitInfo (reference: path_tracer.hh:321-338); alpha is not read downstream.
struct HitInfo {
    float thit;
    V3 pos;
    M3 tbn;
    Material m;  // albedo, roughness, metallic, transmission, eta
    float emission, nee_pdf;
};

// shade_hit's miss branch: the sun disk (reference: path_tracer.hh:356-366).
// `thit` is the query's (-1 on a miss).
__device__ __forceinline__ HitInfo shade_miss(const Light& light, float thit, V3 origin,
                                              V3 d) {
    HitInfo h;
    const float visible = dot3(light.direction, d) > light.cos_solid_angle ? 1.0f : 0.0f;
    const float miss_nee_pdf = visible / ((1.0f - light.cos_solid_angle) * kTwoPi);
    const float sun_scale = miss_nee_pdf == 0.0f ? 1.0f : miss_nee_pdf;
    h.thit = thit;
    h.pos = origin + d * thit;
    h.tbn = create_tangent_space({0.0f, 0.0f, 1.0f});
    h.m.albedo = light.color * (visible * sun_scale);
    h.m.roughness = 0.0f;
    h.m.metallic = 0.0f;
    h.m.transmission = 0.0f;
    h.m.eta = 1.0f;
    h.emission = 1.0f;
    h.nee_pdf = miss_nee_pdf;
    return h;
}

// shade_hit's hit branch once the fetch has the triangle's three vertex
// attribute rows a0, a1, a2 (columns: normal 0-2, albedo 3-5, alpha 6,
// roughness 7, metallic 8, transmission 9, emission 10) and (u, v, t, back)
// (reference: path_tracer.hh:367-412).  fi: the instance's inst_f row.
__device__ __forceinline__ HitInfo shade_surface(
    const float* __restrict__ fi, const float* __restrict__ a0,
    const float* __restrict__ a1, const float* __restrict__ a2, float bu, float bv,
    float dt, bool back, V3 origin, V3 d) {
    HitInfo h;
    const float bw = 1.0f - bu - bv;
    // attr = a0 * u + a1 * v + a2 * w, per column
    float attr[11];
#pragma unroll
    for (int k = 0; k < 11; ++k) {
        if (k == 6) continue;  // alpha
        attr[k] = __ldg(a0 + k) * bu + __ldg(a1 + k) * bv + __ldg(a2 + k) * bw;
    }
    const V3 n = {attr[0], attr[1], attr[2]};
    // rotate the normal to world: mul_m3v3(rot, n) (reference: path_tracer.hh:371,392)
    V3 nw = {__ldg(fi + 12) * n.x + __ldg(fi + 15) * n.y + __ldg(fi + 18) * n.z,
             __ldg(fi + 13) * n.x + __ldg(fi + 16) * n.y + __ldg(fi + 19) * n.z,
             __ldg(fi + 14) * n.x + __ldg(fi + 17) * n.y + __ldg(fi + 20) * n.z};
    const float nlen = length3(nw);
    nw = nw / (nlen == 0.0f ? 1.0f : nlen);
    // IOR 1.5; a back-face hit flips the normal (reference: path_tracer.hh:394-400)
    if (back) nw = -nw;
    h.thit = dt;
    h.pos = origin + d * dt;
    h.tbn = create_tangent_space(nw);
    h.m.albedo = {attr[3], attr[4], attr[5]};
    h.m.roughness = attr[7] * attr[7];
    h.m.metallic = attr[8];
    h.m.transmission = attr[9];
    h.m.eta = back ? kIor : kInvIor;
    h.emission = attr[10];
    h.nee_pdf = 0.0f;
    return h;
}

// shade_hit(packed=True): the shading fetch from the hit ids and one
// tri_shade row (the three 11-float attribute rows, then the 9 positions).
// (u, v, t, back) are re-derived by the triangle test on the instance ray.
// `thit` is the query's: the walk's tmax on a hit, -1 on a miss.
__device__ __forceinline__ HitInfo shade_hit_packed(
    const float* __restrict__ tri_shade, const float* __restrict__ inst_f,
    const int* __restrict__ inst_u, const Light& light, int c_inst, int c_prim,
    float thit, V3 origin, V3 d) {
    if (c_inst < 0) return shade_miss(light, thit, origin, d);
    const float* __restrict__ fi = inst_f + 21 * (size_t)c_inst;
    const float* __restrict__ ts =
        tri_shade + 48 * (size_t)(__ldg(inst_u + 6 * (size_t)c_inst + 4) + c_prim);
    V3 bo, bd, S;
    int axis;
    instance_ray(fi, origin, d, bo, bd);
    tri_preprocess(bd, axis, S);
    const V3 p0 = {__ldg(ts + 33), __ldg(ts + 34), __ldg(ts + 35)};
    const V3 p1 = {__ldg(ts + 36), __ldg(ts + 37), __ldg(ts + 38)};
    const V3 p2 = {__ldg(ts + 39), __ldg(ts + 40), __ldg(ts + 41)};
    float bu, bv, dt;
    bool back;
    tri_intersect(bo, axis, S, p0, p1, p2, bu, bv, dt, back);
    return shade_surface(fi, ts, ts + 11, ts + 22, bu, bv, dt, back, origin, d);
}

// shade_hit (the scan's default fetch): the triangle's vertex ids from
// tri_idx, its three vattr rows (12 floats each), its positions from
// tri_pos.  (u, v, t, back) come from the walk's finalize step
// (ray_common.cuh, hit_surface), as the scan re-derives (u, v, t) by that
// test and takes back from the query's result.  Binary scenes carry no
// tri_shade rows; this is their fetch.
__device__ __forceinline__ HitInfo shade_hit_unpacked(
    const float4* __restrict__ tri_pos, const int* __restrict__ tri_idx,
    const float* __restrict__ vattr, const float* __restrict__ inst_f,
    const int* __restrict__ inst_u, const Light& light, int c_inst, int c_prim,
    float thit, V3 origin, V3 d) {
    if (c_inst < 0) return shade_miss(light, thit, origin, d);
    float bu, bv, dt;
    bool back;
    hit_surface(tri_pos, inst_f, inst_u, origin, d, c_inst, c_prim, bu, bv, dt, back);
    const int* __restrict__ ti =
        tri_idx + 4 * (size_t)(__ldg(inst_u + 6 * (size_t)c_inst + 4) + c_prim);
    return shade_surface(inst_f + 21 * (size_t)c_inst, vattr + 12 * (size_t)__ldg(ti + 0),
                         vattr + 12 * (size_t)__ldg(ti + 1), vattr + 12 * (size_t)__ldg(ti + 2),
                         bu, bv, dt, back, origin, d);
}

// nee_prepare -> nee_finish plumbing, split around the shadow trace.
struct NeeState {
    float jitter;  // u.w of the NEE draw: the transmittance march's jitter
    V3 light_dir, color;
    float bsdf_pdf, nee_pdf;
    bool black;
};

// NEE up to the shadow trace (reference: path_tracer.hh:594-609), for a live
// path: draws once.  The shadow ray is traced iff !black.
__device__ __forceinline__ NeeState nee_prepare(Seed& seed, const Light& light,
                                                const HitInfo& info, const Material& m,
                                                V3 tview) {
    const F4 u = uniform4(seed);
    NeeState st;
    st.jitter = u.w;
    st.light_dir = sample_cone(light.direction, light.cos_solid_angle, u.x, u.y);
    st.nee_pdf = 1.0f / ((1.0f - light.cos_solid_angle) * kTwoPi);
    const V3 tlight = info.tbn.vec_mul(st.light_dir);
    V3 color;
    bsdf_eval(tlight, tview, m, color, st.bsdf_pdf);
    st.color = color * st.nee_pdf * light.color;
    st.black = st.color.x == 0.0f && st.color.y == 0.0f && st.color.z == 0.0f;
    return st;
}

// NEE after the shadow trace: MIS weight + sun transmittance march
// (reference: path_tracer.hh:611-619).  No RNG.  Returns whether it marched.
__device__ __forceinline__ bool nee_finish(const NeeState& st, const Light& light, V3 pos,
                                           bool occluded, float max_ray_dist, V3& out) {
    if (st.black || occluded) {
        out = {0.0f, 0.0f, 0.0f};
        return false;
    }
    const float mis_pdf = light.cos_solid_angle < 1.0f
                              ? (st.nee_pdf * st.nee_pdf + st.bsdf_pdf * st.bsdf_pdf) /
                                    st.nee_pdf
                              : 1.0f;
    const V3 c = st.color * atmosphere_attenuation(st.jitter, pos, st.light_dir, max_ray_dist);
    out = c / mis_pdf;
    return true;
}

}  // namespace ptq
