// The megakernel (K2): whole sun-NEE paths, one thread per pixel slot.
//
// Replaces the JAX package's persistent-lane renderer
// pathtracing_tpu/ops/megakernel.py::path_trace_megakernel (with _service
// and _launch), an XLA while-loop there, on its sun-NEE path over the wide
// tables.  It computes the same function: for pixel slots [0, n_pixels),
// mapped through pixel_order and offset by pixel_base, the per-pixel sums of
// the samples [sample_base, sample_base + spp) of the reference's path loop
// (reference: path_tracer.hh:637-741), and with with_stats the per-pixel sums
// of each sample's luminance squared.
//
// Design.  The JAX loop keeps R persistent SIMD lanes stepping together: a
// service step shades and respawns the lanes whose ray has finished and a
// cumsum hands out work items, because TPU lanes cannot leave the loop on
// their own.  A CUDA thread runs its own loop and the hardware schedules the
// blocks, so here one thread owns one pixel slot and runs its samples in
// order; each sample is the reference's loop as the port's
// ops/integrator.path_trace_samples runs it:
//   film draw; camera ray; primary closest walk; shade; conditional
//   atmosphere draw; then per bounce: NEE draw, BSDF draw, any-hit shadow
//   walk (when the NEE colour is not black), closest bounce walk, shade,
//   nee_finish, MIS, conditional atmosphere draw, regularisation.
// That is the per-lane draw order of ops/megakernel.py (film; cond-atmo; per
// bounce nee, bsdf, cond-atmo).  The walk is wide_walk.cuh's, inlined; the
// shading is shading.cuh's.  A path ends on a miss or after max_bounces.
//
// The fold.  A thread adds its samples into r, g, b (and lum^2) registers
// starting from 0.0f, in sample order, and writes each pixel once: the sums
// are deterministic and in the plain version's order (a sample-ordered sum of
// path_trace_samples), with no float atomics.  Two launches give the same
// bytes.
//
// The step cap.  JAX caps its while-loop's periods; here each ray's walk is
// capped at `max_steps` row visits (the wrapper's default is 64x the longest
// walk the plain walk shows on the golden scene).  A sample one of whose rays
// hits the cap is abandoned (not folded) and counted in n_truncated.
//
// What bounds it on an H100: issue and latency.  The golden scene's tables
// (~1.5 MB) sit in L2 and the output is 12-16 B per pixel; a sample is ~11
// dependent walks of tens of row visits each plus ~1,000 flops of shading
// per bounce (the atmosphere march dominates), and a warp runs as long as
// its longest path.  This first design keeps it simple: no queue, no
// regrouping of rays between bounces; registers and spills are reported by
// the build (chip_smoke.py), not chased.
//
// The counting build (kCount) adds each thread's row visits, tests and
// shading calls into a uint64 array at its end; chip_smoke.py turns them into
// the bound.  It is a separate instantiation: the timed kernel counts
// nothing.
//
// Parity: built with --fmad=false, IEEE division and square root, no
// fast-math, no flush-to-zero (ops/cuda_build.py); shading.cuh has the rules
// that keep a sample on the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ray_common.cuh"
#include "shading.cuh"
#include "wide_walk.cuh"

namespace {

using namespace ptq;

constexpr int kBlock = 128;

struct Tables {
    const float4* rows;        // (M, W) f32 mega-table
    const uint32_t* wide_root; // (K, 8) root cursors
    const int* root_base;      // one int32, or null
    const float4* tri_pos;     // (T, 12) f32 (stub leaves)
    const float* inst_f;       // (I, 21) f32
    const int* inst_u;         // (I, 6) i32
    const float* tri_shade;    // (T, 48) f32
    const float* sf_cam;       // (S, 18) f32
    const float* sf_light;     // (S, 7) f32
    const int* sf_tlas_offset; // (S,) i32
    int n_cam, n_light, n_tlas;
};

struct Frame {
    const int* pixel_order;    // (n_pixels,) i32 permutation, or null
    int n_pixels, spp, sample_base, pixel_base;
    int width, height, max_bounces, smbs, max_steps;
    uint32_t student_id;
    float min_ray_dist, max_ray_dist, gamma;
};

struct Out {
    float *r, *g, *b, *l2;     // (n_pixels,) sums; l2 null without stats
    int* n_truncated;          // one int32, added to
    unsigned long long* counts;  // kNCounts, added to (counting build only)
};

// The counting build's counters, in the order of MK_COUNT_NAMES in
// ops/cuda_megakernel.py.
enum {
    kSamples, kWideRows, kLeafRows, kInstRows, kSlabTests, kTriTests, kRays,
    kShadeHits, kShadeMisses, kAtmoMarches, kNeeEvals, kNeeMarches,
    kBsdfSamples, kNCounts
};

struct NoPathCount : NoWalkCount {
    __device__ __forceinline__ void add(int) {}
    __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct PathCount {
    uint32_t c[kNCounts];
    __device__ __forceinline__ PathCount() {
#pragma unroll
        for (int k = 0; k < kNCounts; ++k) c[k] = 0;
    }
    __device__ __forceinline__ void wide_row(int slabs) {
        ++c[kWideRows];
        c[kSlabTests] += (uint32_t)slabs;
    }
    __device__ __forceinline__ void leaf_row(int tris) {
        ++c[kLeafRows];
        c[kTriTests] += (uint32_t)tris;
    }
    __device__ __forceinline__ void inst_row() { ++c[kInstRows]; }
    __device__ __forceinline__ void add(int k) { ++c[k]; }
    __device__ __forceinline__ void flush(unsigned long long* out) {
#pragma unroll
        for (int k = 0; k < kNCounts; ++k)
            if (c[k]) atomicAdd(out + k, (unsigned long long)c[k]);
    }
};

// A subframe row index clamped into a table of n rows, as XLA clamps a
// gather index (ops/integrator.camera_sample).
__device__ __forceinline__ int clamp_row(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// One sample of one pixel (ops/integrator.path_trace_samples); false when a
// walk hit the step cap (the sample is then abandoned).
template <int S, int L, bool STUB, class Count>
__device__ __forceinline__ bool trace_sample(const Tables& t, const Frame& f, int x, int y,
                                             int sample_index, V3& contrib, Count& count) {
    // ---- camera_sample: seed warm-up, film/aperture draw, camera ray ----
    const int subframe = sample_index < 0 ? 0 : sample_index / f.smbs;
    Seed seed = pcg4d({(uint32_t)x, (uint32_t)y, (uint32_t)sample_index, f.student_id});
    const F4 u = uniform4(seed);
    const V2 film = sample_gaussian_weighted_disk_04(u.x, u.y);
    const Camera cam = camera_from_row(t.sf_cam + 18 * (size_t)clamp_row(subframe, t.n_cam));
    const Light light = light_from_row(t.sf_light + 7 * (size_t)clamp_row(subframe, t.n_light));
    const int tlas_offset = __ldg(t.sf_tlas_offset + clamp_row(subframe, t.n_tlas));
    V3 ray_o, ray_d;
    get_camera_ray(cam, u.z, u.w, (float)x + (film.x + 0.5f), (float)y + (film.y + 0.5f),
                   f.width, f.height, ray_d, ray_o);
    count.add(kSamples);

    contrib = {0.0f, 0.0f, 0.0f};
    V3 attenuation = {1.0f, 1.0f, 1.0f}, bsdf_atten = {0.0f, 0.0f, 0.0f};
    float regularization = 1.0f, roughness = 0.0f, bsdf_pdf = 0.0f;
    float tmin = 0.0f;  // the primary ray's (trace_ray passes 0)
    NeeState nee;
    bool occluded = false;
    for (int b = 0;; ++b) {
        // ---- the closest ray: primary (b == 0) or bounce b ----
        float tmax = f.max_ray_dist;
        int c_inst, c_prim;
        bool unused;
        count.add(kRays);
        if (!wide_walk<S, L, STUB, true>(
                t.rows, t.tri_pos, t.inst_u,
                root_cursor(t.wide_root, t.root_base, tlas_offset, ray_d), ray_o, ray_d,
                safe_inv(ray_d), false, tmin, tmax, c_inst, c_prim, unused, f.max_steps,
                count))
            return false;
        const HitInfo info = shade_hit_packed(t.tri_shade, t.inst_f, t.inst_u, light, c_inst,
                                              c_prim, c_inst >= 0 ? tmax : -1.0f, ray_o, ray_d);
        count.add(c_inst >= 0 ? kShadeHits : kShadeMisses);
        V3 atmo_att, in_scatter;
        if (b == 0) {
            if (atmosphere_scattering(seed, light.direction, light.color, ray_o, ray_d,
                                      info.thit, atmo_att, in_scatter))
                count.add(kAtmoMarches);
            contrib = (contrib + in_scatter) + atmo_att * info.m.albedo * info.emission;
            attenuation = atmo_att;
            roughness = info.m.roughness;
        } else {
            // NEE of the previous hit (its position is this ray's origin)
            V3 nee_color;
            if (nee_finish(nee, light, ray_o, occluded, f.max_ray_dist, nee_color))
                count.add(kNeeMarches);
            contrib = contrib + attenuation * nee_color;
            // guarded divisions: pdf == 0 keeps the reference's inf
            const float pdf_safe = bsdf_pdf == 0.0f ? 1.0f : bsdf_pdf;
            const float mis_pdf =
                bsdf_pdf < 0.0f
                    ? -bsdf_pdf
                    : (bsdf_pdf == 0.0f
                           ? f_inf()
                           : (info.nee_pdf * info.nee_pdf + bsdf_pdf * bsdf_pdf) / pdf_safe);
            attenuation = attenuation * bsdf_atten;
            if (atmosphere_scattering(seed, light.direction, light.color, ray_o, ray_d,
                                      info.thit, atmo_att, in_scatter))
                count.add(kAtmoMarches);
            const float inv_mis = isinf(mis_pdf) ? 0.0f : 1.0f / mis_pdf;
            contrib = contrib +
                      attenuation * (in_scatter + atmo_att * info.m.albedo * info.emission) *
                          inv_mis;
            const float inv_abs_pdf = bsdf_pdf == 0.0f ? f_inf() : 1.0f / fabsf(pdf_safe);
            attenuation = attenuation * atmo_att * inv_abs_pdf;
            // path-space regularization (reference: path_tracer.hh:734-737);
            // RECIP: gamma / pow(pdf, 0.25) is reciprocal(pow) * gamma
            if (bsdf_pdf > 0.0f)
                regularization =
                    regularization *
                    clamp_min(1.0f - (1.0f / powf(bsdf_pdf, 0.25f)) * f.gamma, 0.0f);
            roughness = 1.0f - (1.0f - info.m.roughness) * regularization;
        }
        if (b == f.max_bounces || !(info.thit > 0.0f)) return true;

        // ---- bounce b + 1: tangent-space view, NEE and BSDF draws ----
        V3 view = info.tbn.vec_mul(-ray_d);
        view.z = view.z < 1e-7f ? 1e-7f : view.z;
        view = normalize3(view);
        Material m = info.m;
        m.roughness = roughness;
        nee = nee_prepare(seed, light, info, m, view);
        count.add(kNeeEvals);
        const F4 ub = uniform4(seed);
        const BsdfSample smp = sample_bsdf(ub.x, ub.y, ub.z, view, m);
        count.add(kBsdfSamples);
        bsdf_atten = smp.attenuation;
        bsdf_pdf = smp.pdf;
        ray_o = info.pos;
        ray_d = normalize3(info.tbn.mul_vec(smp.direction));
        tmin = f.min_ray_dist;

        // ---- the any-hit shadow ray, only for a NEE colour that is not black
        occluded = false;
        if (!nee.black) {
            float tmax_s = f.max_ray_dist;
            int unused_inst, unused_prim;
            count.add(kRays);
            if (!wide_walk<S, L, STUB, true>(
                    t.rows, t.tri_pos, t.inst_u,
                    root_cursor(t.wide_root, t.root_base, tlas_offset, nee.light_dir),
                    info.pos, nee.light_dir, safe_inv(nee.light_dir), true, f.min_ray_dist,
                    tmax_s, unused_inst, unused_prim, occluded, f.max_steps, count))
                return false;
        }
    }
}

template <int S, int L, bool STUB, bool kCount>
__global__ void __launch_bounds__(kBlock) megakernel(Tables t, Frame f, Out o) {
    const int slot = blockIdx.x * kBlock + threadIdx.x;
    if (slot >= f.n_pixels) return;
    const int local = f.pixel_order ? __ldg(f.pixel_order + slot) : slot;
    const int pixel = f.pixel_base + local;
    const int x = pixel % f.width, y = pixel / f.width;
    typename std::conditional<kCount, PathCount, NoPathCount>::type count;

    float ar = 0.0f, ag = 0.0f, ab = 0.0f, al2 = 0.0f;
    int truncated = 0;
    for (int s = 0; s < f.spp; ++s) {
        // sample_base + s as int32 (wraps as XLA's add does)
        const int sample_index = (int)((uint32_t)f.sample_base + (uint32_t)s);
        V3 c;
        if (!trace_sample<S, L, STUB>(t, f, x, y, sample_index, c, count)) {
            ++truncated;
            continue;
        }
        ar = ar + c.x;
        ag = ag + c.y;
        ab = ab + c.z;
        if (o.l2) {
            const float lum = 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
            al2 = al2 + lum * lum;
        }
    }
    o.r[local] = ar;
    o.g[local] = ag;
    o.b[local] = ab;
    if (o.l2) o.l2[local] = al2;
    if (truncated) atomicAdd(o.n_truncated, truncated);
    count.flush(o.counts);
}

template <int S, int L, bool STUB>
int launch(const Tables& t, const Frame& f, const Out& o, cudaStream_t s) {
    const dim3 grid((unsigned)((f.n_pixels + kBlock - 1) / kBlock)), block(kBlock);
    if (o.counts)
        megakernel<S, L, STUB, true><<<grid, block, 0, s>>>(t, f, o);
    else
        megakernel<S, L, STUB, false><<<grid, block, 0, s>>>(t, f, o);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` (f32 per mega-table row) selects the layout.
// Adds abandoned samples to *n_truncated, and with a non-null `counts` runs
// the counting build, which adds its counters there.  Returns the launch's
// cudaError_t (0 = accepted), or -1 for a width no layout has.
extern "C" int pt_megakernel(
    const void* rows, int width, const void* wide_root, const void* root_base,
    const void* tri_pos, const void* inst_f, const void* inst_u, const void* tri_shade,
    const void* sf_cam, int n_cam, const void* sf_light, int n_light,
    const void* sf_tlas_offset, int n_tlas, const void* pixel_order, int n_pixels,
    int spp, int sample_base, int pixel_base, int image_width, int image_height,
    int max_bounces, int smbs, int student_id, float min_ray_dist, float max_ray_dist,
    float gamma, int max_steps, void* out_r, void* out_g, void* out_b, void* out_l2,
    void* n_truncated, void* counts, void* stream) {
    if (n_pixels <= 0) return 0;
    const Tables t = {(const float4*)rows, (const uint32_t*)wide_root,
                      (const int*)root_base, (const float4*)tri_pos,
                      (const float*)inst_f, (const int*)inst_u, (const float*)tri_shade,
                      (const float*)sf_cam, (const float*)sf_light,
                      (const int*)sf_tlas_offset, n_cam, n_light, n_tlas};
    const Frame f = {(const int*)pixel_order, n_pixels, spp, sample_base, pixel_base,
                     image_width, image_height, max_bounces, smbs, max_steps,
                     (uint32_t)student_id, min_ray_dist, max_ray_dist, gamma};
    const Out o = {(float*)out_r, (float*)out_g, (float*)out_b, (float*)out_l2,
                   (int*)n_truncated, (unsigned long long*)counts};
    cudaStream_t s = (cudaStream_t)stream;
    if (width == Layout<8, 4, false>::kWidth) return launch<8, 4, false>(t, f, o, s);
    if (width == Layout<16, 8, false>::kWidth) return launch<16, 8, false>(t, f, o, s);
    if (width == Layout<8, 8, true>::kWidth) return launch<8, 8, true>(t, f, o, s);
    return -1;
}

extern "C" int pt_megakernel_block_size(void) { return kBlock; }

extern "C" int pt_megakernel_count_slots(void) { return kNCounts; }

// Blocks of the layout's (timed) kernel one SM holds at once (negative: the
// CUDA error), or 0 for a width no layout has.
extern "C" int pt_megakernel_occupancy(int width) {
    if (width == Layout<8, 4, false>::kWidth)
        return resident_blocks_per_sm(megakernel<8, 4, false, false>, kBlock);
    if (width == Layout<16, 8, false>::kWidth)
        return resident_blocks_per_sm(megakernel<16, 8, false, false>, kBlock);
    if (width == Layout<8, 8, true>::kWidth)
        return resident_blocks_per_sm(megakernel<8, 8, true, false>, kBlock);
    return 0;
}
