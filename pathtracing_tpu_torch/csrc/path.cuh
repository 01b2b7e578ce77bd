// One pixel's samples of the reference's path loop, as a device function,
// shared by the megakernel (megakernel.cu, K2: pixel slots of a row-major
// frame, wide tables) and the wavefront kernel (wavefront.cu, K5: any (x, y)
// list, binary or wide tables).
//
// trace_sample is one sample (ops/integrator.path_trace_samples):
//   film draw; camera ray; primary closest walk; shade; conditional
//   atmosphere draw; then per bounce: NEE draw, BSDF draw, any-hit shadow
//   walk (when the NEE colour is not black), closest bounce walk, shade,
//   nee_finish, MIS, conditional atmosphere draw, regularisation.
// That is the per-lane draw order of the JAX package's megakernel and
// wavefront loops (film; cond-atmo; per bounce nee, bsdf, cond-atmo).  A
// path ends on a miss or after max_bounces.  The primary ray has tmin 0.
//
// It is a template on two policies:
//   Walk   how a ray is walked: WideWalk<S, L, STUB> (wide_walk.cuh, the
//          subframe's TLAS root from sf_tlas_offset) or BinaryWalk<Rows>
//          (binary_walk.cuh, the subframe's TLAS count and offset from
//          sf_tlas_count / sf_tlas_offset, the node rows nl8 or nl5);
//   Fetch  how a closest hit is shaded: PackedFetch (one tri_shade row) or
//          UnpackedFetch (tri_idx, vattr, tri_pos: the scan's fetch).
// The two fetches give the same bits (tests/test_torch_shade_packed.py).
//
// A third compile-time policy adds area-light NEE (ops/arealights.py; the
// JAX package's megakernel phase _PH_SHADOW2 and its wavefront's light
// branch):
//   Lights NoAreaLights (the sun only: every hook is empty, so those
//          instances compile as they did before the policy existed) or
//          AreaLights (the scene's lt_* tables): per bounce one more draw
//          after the NEE draw, a light sample (a binary search of lt_cdf, a
//          point on the triangle, its interpolated emission, bsdf_eval toward
//          it), an any-hit walk toward it after the sun's shadow walk, its
//          term added after the next closest hit and before the sun's term
//          (the scan's order), and the power-heuristic weight on emission
//          found by BSDF sampling.
//
// trace_samples folds a pixel's samples [sample_base, sample_base + spp):
// in sample order, in registers, from 0.0f, with the luminance-squared plane
// beside them when asked; a sample one of whose walks hits the step cap is
// abandoned (not folded) and counted.  No float atomics: two launches give
// the same bytes, and the order is the plain version's (a sample-ordered sum
// of path_trace_samples).
//
// Each subframe row index is clamped into its own table, as XLA clamps a
// gather index; a negative sample index uses subframe 0; sample_base + s
// wraps as int32.
//
// Parity: built with --fmad=false, IEEE division and square root, no
// fast-math, no flush-to-zero (ops/cuda_build.py); shading.cuh has the rules
// that keep a sample on the plain version's bits.
//
// It is also a template on a record policy (NoRecord, or ItemRecord for the
// megakernel's record build K6, below), and on a count policy: nothing (the
// timed builds), the counting builds' counters (PathCount), or the
// phase-cycle build's clocks (PhaseClock: each thread's clock64() cycles in
// each phase of the path; an instrument, like the counters).
//
// This header's bytes are part of the hash of every library that includes it
// (ops/cuda_build.py): an edit here rebuilds K2 (and K6) and K5.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "binary_walk.cuh"
#include "ray_common.cuh"
#include "shading.cuh"
#include "wide_walk.cuh"

namespace ptq {

// A subframe row index clamped into a table of n rows, as XLA clamps a
// gather index (ops/integrator.camera_sample).
__device__ __forceinline__ int clamp_row(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// What every sample reads besides the walk's and the fetch's tables.
struct PathParams {
    const float* sf_cam;    // (S, 18) f32
    const float* sf_light;  // (S, 7) f32
    int n_cam, n_light;
    int spp, sample_base, width, height, max_bounces, smbs, max_steps;
    uint32_t student_id;
    float min_ray_dist, max_ray_dist, gamma;
};

// ---------------------------------------------------------------- walks

template <int S, int L, bool STUB>
struct WideWalk {
    const float4* rows;         // (M, W) f32 mega-table
    const uint32_t* wide_root;  // (K, 8) root cursors
    const int* root_base;       // one int32, or null
    const float4* tri_pos;      // (T, 12) f32 (stub leaves)
    const int* inst_u;          // (I, 6) i32
    const int* sf_tlas_offset;  // (S,) i32
    int n_tlas;

    struct Root { int offset; };
    __device__ __forceinline__ Root root(int subframe) const {
        return {__ldg(sf_tlas_offset + clamp_row(subframe, n_tlas))};
    }
    template <class Count>
    __device__ __forceinline__ bool walk(Root r, V3 o, V3 d, bool any, float tmin,
                                        float& tmax, int& c_inst, int& c_prim,
                                        bool& occluded, int max_steps, Count& count) const {
        return wide_walk<S, L, STUB, true>(rows, tri_pos, inst_u,
                                           root_cursor(wide_root, root_base, r.offset, d), o,
                                           d, safe_inv(d), any, tmin, tmax, c_inst, c_prim,
                                           occluded, max_steps, count);
    }
};

template <class Rows>  // Nl8Rows or Nl5Rows (binary_walk.cuh)
struct BinaryWalk {
    Rows nodes;                 // nl8 (8N, 8) or nl5 (8N, 5) f32
    const float4* tri_pos;      // (T, 12) f32
    const float* inst_f;        // (I, 21) f32
    const int* inst_u;          // (I, 6) i32
    const int* sf_tlas_count;   // (S,) i32
    const int* sf_tlas_offset;  // (S,) i32
    int n_tlas_count, n_tlas;

    struct Root { int count, offset; };
    __device__ __forceinline__ Root root(int subframe) const {
        return {__ldg(sf_tlas_count + clamp_row(subframe, n_tlas_count)),
                __ldg(sf_tlas_offset + clamp_row(subframe, n_tlas))};
    }
    template <class Count>
    __device__ __forceinline__ bool walk(Root r, V3 o, V3 d, bool any, float tmin,
                                        float& tmax, int& c_inst, int& c_prim,
                                        bool& occluded, int max_steps, Count& count) const {
        return binary_walk<true>(nodes, tri_pos, inst_f, inst_u, r.count, r.offset, o, d,
                                 safe_inv(d), any, tmin, tmax, c_inst, c_prim, occluded,
                                 max_steps, count);
    }
};

// -------------------------------------------------------------- fetches

struct PackedFetch {
    const float* tri_shade;  // (T, 48) f32
    const float* inst_f;     // (I, 21) f32
    const int* inst_u;       // (I, 6) i32
    __device__ __forceinline__ HitInfo shade(const Light& light, int c_inst, int c_prim,
                                             float thit, V3 o, V3 d) const {
        return shade_hit_packed(tri_shade, inst_f, inst_u, light, c_inst, c_prim, thit, o, d);
    }
};

struct UnpackedFetch {
    const float4* tri_pos;  // (T, 12) f32
    const int* tri_idx;     // (T, 4) i32
    const float* vattr;     // (V, 12) f32
    const float* inst_f;    // (I, 21) f32
    const int* inst_u;      // (I, 6) i32
    __device__ __forceinline__ HitInfo shade(const Light& light, int c_inst, int c_prim,
                                             float thit, V3 o, V3 d) const {
        return shade_hit_unpacked(tri_pos, tri_idx, vattr, inst_f, inst_u, light, c_inst,
                                  c_prim, thit, o, d);
    }
};

// ------------------------------------------------------------- counting

// The counting builds' counters, in the order of COUNT_NAMES in
// ops/cuda_megakernel.py.
enum {
    kSamples, kNodeRows, kLeafRows, kInstRows, kSlabTests, kTriTests, kRays,
    kShadeHits, kShadeMisses, kAtmoMarches, kNeeEvals, kNeeMarches,
    kBsdfSamples, kLightSamples, kLightPdfs, kNCounts
};

// The phase-cycle build's phases, in the order of PHASE_NAMES in
// ops/cuda_megakernel.py: camera and RNG draws (the film draw, the camera
// ray, the BSDF draw), the closest walks, the shadow walks, the shading
// fetch, the atmosphere marches, nee_prepare and nee_finish, sample_bsdf, and
// the rest (the path's own arithmetic, the fold, the write).
enum {
    kPhCamera, kPhClosest, kPhShadow, kPhShade, kPhAtmo, kPhNee, kPhBsdf, kPhOther,
    kNPhases
};

// Every count policy has the walks' hooks, `add`, `phase` and `flush`; the
// empty ones compile away.
struct NoPathCount : NoWalkCount {
    __device__ __forceinline__ void add(int) {}
    __device__ __forceinline__ void phase(int) {}
    __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct PathCount {
    uint32_t c[kNCounts];
    __device__ __forceinline__ PathCount() {
#pragma unroll
        for (int k = 0; k < kNCounts; ++k) c[k] = 0;
    }
    __device__ __forceinline__ void phase(int) {}
    __device__ __forceinline__ void node_row(int slabs) {
        ++c[kNodeRows];
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

// The phase-cycle build: phase(k) adds the cycles since the last mark to
// phase k.  A thread's cycles are its warp's while the thread is in the
// phase, stalls and waits at divergence included; flush adds the thread's
// sums into kNPhases uint64 (the counting builds' flush).
struct PhaseClock : NoPathCount {
    unsigned long long acc[kNPhases];
    long long last;
    __device__ __forceinline__ PhaseClock() {
#pragma unroll
        for (int k = 0; k < kNPhases; ++k) acc[k] = 0;
        last = clock64();
    }
    __device__ __forceinline__ void phase(int k) {
        const long long now = clock64();
        acc[k] += (unsigned long long)(now - last);
        last = now;
    }
    __device__ __forceinline__ void flush(unsigned long long* out) {
        phase(kPhOther);
#pragma unroll
        for (int k = 0; k < kNPhases; ++k)
            if (acc[k]) atomicAdd(out + k, acc[k]);
    }
};

// -------------------------------------------------------------- records

// The record build (K6: the fast gradients' record pass,
// diff/render.make_fast_grad_frame_fn) writes each sample's hit topology
// beside its radiance, in the scan's record format (ops/integrator
// path_trace_samples(record=True)) packed as the JAX package's megakernel
// packs it: pk = (inst << 2) | (back << 1) | hit, and prim (0 on a miss).
// Work item k * n_slots + slot is sample k of pixel slot `slot` (sample-major,
// as JAX).  Indexing contract: the closest hit of iteration 0 goes to the
// primary planes; that of iteration b >= 1 (bounce ray b) to bounce row
// b - 1; the sun shadow ray traced at the end of iteration b to occ row b.
//
// Rows not reached keep zero: a path stops on a miss or at max_bounces, and
// traces the shadow ray only for a NEE colour that is not black, and the
// planes are zeroed by the caller; the kernel writes only the rows its path
// reaches (occ = 0 for a black NEE colour, as the scan's untraced lane).  A
// replay never reads those rows: its active mask comes from the re-derived
// thit.  ops/megakernel.path_trace_megakernel_plain(record=True) applies the
// same rule to the scan's records, so the two compare exactly on every row.
// A sample abandoned at the step cap keeps the rows it wrote.
struct NoRecord {
    __device__ __forceinline__ void begin(int) {}
    __device__ __forceinline__ void closest(int, int, int, const HitInfo&) {}
    __device__ __forceinline__ void shadow(int, bool) {}
};

struct ItemRecord {
    int* pk_p;         // (n_items,) i32: the primary hits
    int* prim_p;       // (n_items,) i32
    int* pk_b;         // (max_bounces * n_items,) i32: bounce rows
    int* prim_b;       // (max_bounces * n_items,) i32
    uint8_t* occ_b;    // (max_bounces * n_items,) u8
    int n_items, n_slots, slot;
    size_t item;

    __device__ __forceinline__ void begin(int k) { item = (size_t)k * n_slots + slot; }
    __device__ __forceinline__ void closest(int b, int c_inst, int c_prim, const HitInfo& info) {
        const bool hit = c_inst >= 0;
        // back = hit && eta > 1: shade_hit's eta is 1.5 on a back face
        const int pk = (int)(((uint32_t)c_inst << 2) | (hit && info.m.eta > 1.0f ? 2u : 0u) |
                             (hit ? 1u : 0u));
        const int prim = hit ? c_prim : 0;
        if (b == 0) {
            pk_p[item] = pk;
            prim_p[item] = prim;
        } else {
            const size_t i = (size_t)(b - 1) * n_items + item;
            pk_b[i] = pk;
            prim_b[i] = prim;
        }
    }
    __device__ __forceinline__ void shadow(int b, bool occluded) {
        occ_b[(size_t)b * n_items + item] = occluded ? 1 : 0;
    }
};

// ----------------------------------------------------------- area lights

// The sun only: no light tables, nothing drawn, traced or added.
struct NoAreaLights {
    static constexpr bool kLit = false;
    struct Sample {};
    template <class Count>
    __device__ __forceinline__ void sample(Seed&, const HitInfo&, const Material&, V3, Sample&,
                                           Count&) const {}
    template <class Walk, class Count>
    __device__ __forceinline__ bool shadow(const Walk&, const typename Walk::Root&, V3,
                                           Sample&, const PathParams&, Count&) const {
        return true;
    }
    __device__ __forceinline__ V3 add(V3 contrib, V3, const Sample&) const { return contrib; }
    template <class Count>
    __device__ __forceinline__ float emission(const HitInfo& info, int, int, V3, float,
                                              Count&) const {
        return info.emission;
    }
};

// Area-light NEE over the scene's light tables (ops/arealights.py: the
// functions named beside each step, in their operand order).
struct AreaLights {
    static constexpr bool kLit = true;
    const float* lt_tris;  // (L, 9) f32 world-space vertices
    const int* lt_rows;    // (L,) i32 tri-table rows
    const float* lt_cdf;   // (L,) f32 inclusive area prefix sum
    const int* lt_seg;     // (I,) i32 per-instance first light row, or -1
    const int* lt_rank;    // (T,) i32 per-triangle emissive rank, or -1
    const int* tri_idx;    // (T, 4) i32 vertex ids
    const float* vattr;    // (V, 12) f32 vertex attributes
    const int* inst_u;     // (I, 6) i32
    int n_lights;          // L

    // what a bounce's light sample leaves for the next closest hit
    struct Sample {
        V3 c;        // bsdf * radiance * weighted_pdf
        V3 wi;       // toward the light point
        float dist;  // to it
        bool live;   // shadow_active, then & !occluded
    };

    __device__ __forceinline__ void verts(int j, V3& v0, V3& v1, V3& v2) const {
        const float* __restrict__ t = lt_tris + 9 * (size_t)j;
        v0 = {__ldg(t + 0), __ldg(t + 1), __ldg(t + 2)};
        v1 = {__ldg(t + 3), __ldg(t + 4), __ldg(t + 5)};
        v2 = {__ldg(t + 6), __ldg(t + 7), __ldg(t + 8)};
    }

    // _solid_angle_pdf: area measure -> solid angle at `dist` along d
    __device__ __forceinline__ static float solid_angle_pdf(V3 v0, V3 v1, V3 v2, V3 d,
                                                            float dist, float total) {
        const V3 ng = cross(v1 - v0, v2 - v0);
        const float nglen = length3(ng);
        const float cos_l = fabsf(dot3(ng, d)) / (nglen == 0.0f ? 1.0f : nglen);
        const float denom = cos_l * total;
        return denom > 0.0f ? dist * dist / denom : 0.0f;
    }

    // the ua draw and sample_area_light for a live path at `info`
    template <class Count>
    __device__ __forceinline__ void sample(Seed& seed, const HitInfo& info, const Material& m,
                                           V3 view, Sample& s, Count& count) const {
        const F4 u = uniform4(seed);
        const float total = __ldg(lt_cdf + n_lights - 1);
        // min(u.x, f32(1) - f32(1e-7)) * total, then searchsorted(side="right")
        const float r = fminf(u.x, 0x1.fffffcp-1f) * total;
        int lo = 0, hi = n_lights;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(lt_cdf + mid) <= r)
                lo = mid + 1;
            else
                hi = mid;
        }
        const int j = lo < n_lights - 1 ? lo : n_lights - 1;
        V3 v0, v1, v2;
        verts(j, v0, v1, v2);
        const float su = sqrtf(u.y);
        const float b0 = 1.0f - su, b1 = su * (1.0f - u.z), b2 = su * u.z;
        const V3 pt = (v0 * b0 + v1 * b1) + v2 * b2;
        const V3 dvec = pt - info.pos;
        s.dist = length3(dvec);
        s.wi = dvec / (s.dist == 0.0f ? 1.0f : s.dist);
        const float p_area = solid_angle_pdf(v0, v1, v2, s.wi, s.dist, total);
        // the emission interpolated at the point (columns 3-5 and 10)
        const int* __restrict__ ti = tri_idx + 4 * (size_t)__ldg(lt_rows + j);
        const float* __restrict__ a0 = vattr + 12 * (size_t)__ldg(ti + 0);
        const float* __restrict__ a1 = vattr + 12 * (size_t)__ldg(ti + 1);
        const float* __restrict__ a2 = vattr + 12 * (size_t)__ldg(ti + 2);
        float attr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int c = k < 3 ? 3 + k : 10;
            attr[k] = (__ldg(a0 + c) * b0 + __ldg(a1 + c) * b1) + __ldg(a2 + c) * b2;
        }
        const V3 radiance = V3{attr[0], attr[1], attr[2]} * attr[3];
        V3 color;
        float b_pdf;
        bsdf_eval(info.tbn.vec_mul(s.wi), view, m, color, b_pdf);
        // one-sample power heuristic folded with the 1/p_area factor
        const float denom = p_area * p_area + b_pdf * b_pdf;
        const float w =
            (p_area > 0.0f && isfinite(p_area) && denom > 0.0f) ? p_area / denom : 0.0f;
        s.live = (radiance.x > 0.0f || radiance.y > 0.0f || radiance.z > 0.0f) && w > 0.0f &&
                 (color.x > 0.0f || color.y > 0.0f || color.z > 0.0f) && s.dist > 0.0f;
        if (s.live) s.c = color * radiance * w;
        count.add(kLightSamples);
    }

    // the any-hit walk toward the light point, tmax just short of it (the
    // scan's dist * (1 - 1e-3)); false when the walk hit the step cap
    template <class Walk, class Count>
    __device__ __forceinline__ bool shadow(const Walk& w, const typename Walk::Root& root,
                                           V3 pos, Sample& s, const PathParams& p,
                                           Count& count) const {
        if (!s.live) return true;
        float tmax = s.dist * 0x1.ff7ceep-1f;  // f32(1 - 1e-3)
        int unused_inst, unused_prim;
        bool occluded = false;
        count.add(kRays);
        count.phase(kPhOther);
        const bool walked = w.walk(root, pos, s.wi, true, p.min_ray_dist, tmax, unused_inst,
                                   unused_prim, occluded, p.max_steps, count);
        count.phase(kPhShadow);
        s.live = !occluded;
        return walked;
    }

    // area_nee_color, added as the scan adds it (attenuation times the
    // colour or a zero)
    __device__ __forceinline__ V3 add(V3 contrib, V3 attenuation, const Sample& s) const {
        return contrib + attenuation * (s.live ? s.c : V3{0.0f, 0.0f, 0.0f});
    }

    // info.emission * w_area: light_pdf_of_hit of the closest hit (c_inst,
    // c_prim) along d, and the BSDF side of the power heuristic
    template <class Count>
    __device__ __forceinline__ float emission(const HitInfo& info, int c_inst, int c_prim, V3 d,
                                              float bsdf_pdf, Count& count) const {
        float pl = 0.0f;
        if (c_inst >= 0) {
            const int tri_row = __ldg(inst_u + 6 * (size_t)c_inst + 4) + c_prim;
            const int rank = __ldg(lt_rank + tri_row), seg = __ldg(lt_seg + c_inst);
            if (rank >= 0 && seg >= 0) {
                V3 v0, v1, v2;
                verts(seg + rank, v0, v1, v2);
                const float pdf = solid_angle_pdf(v0, v1, v2, d, info.thit,
                                                  __ldg(lt_cdf + n_lights - 1));
                pl = isfinite(pdf) ? pdf : 0.0f;
                count.add(kLightPdfs);
            }
        }
        const float pdf_safe = bsdf_pdf == 0.0f ? 1.0f : bsdf_pdf;
        const float b2 = pdf_safe * pdf_safe;
        const float denom = b2 + pl * pl;
        const float w_area = bsdf_pdf < 0.0f ? 1.0f : (denom > 0.0f ? b2 / denom : 1.0f);
        return info.emission * w_area;
    }
};

// ---------------------------------------------------------------- paths

// One sample of one pixel (ops/integrator.path_trace_samples); false when a
// walk hit the step cap (the sample is then abandoned).
template <class Walk, class Fetch, class Lights, class Count, class Rec>
__device__ __forceinline__ bool trace_sample(const Walk& w, const Fetch& fe, const Lights& lt,
                                             const PathParams& p, int x, int y,
                                             int sample_index, V3& contrib, Count& count,
                                             Rec& rec) {
    // ---- camera_sample: seed warm-up, film/aperture draw, camera ray ----
    count.phase(kPhOther);
    const int subframe = sample_index < 0 ? 0 : sample_index / p.smbs;
    Seed seed = pcg4d({(uint32_t)x, (uint32_t)y, (uint32_t)sample_index, p.student_id});
    const F4 u = uniform4(seed);
    const V2 film = sample_gaussian_weighted_disk_04(u.x, u.y);
    const Camera cam = camera_from_row(p.sf_cam + 18 * (size_t)clamp_row(subframe, p.n_cam));
    const Light light = light_from_row(p.sf_light + 7 * (size_t)clamp_row(subframe, p.n_light));
    const typename Walk::Root root = w.root(subframe);
    V3 ray_o, ray_d;
    get_camera_ray(cam, u.z, u.w, (float)x + (film.x + 0.5f), (float)y + (film.y + 0.5f),
                   p.width, p.height, ray_d, ray_o);
    count.add(kSamples);
    count.phase(kPhCamera);

    contrib = {0.0f, 0.0f, 0.0f};
    V3 attenuation = {1.0f, 1.0f, 1.0f}, bsdf_atten = {0.0f, 0.0f, 0.0f};
    float regularization = 1.0f, roughness = 0.0f, bsdf_pdf = 0.0f;
    float tmin = 0.0f;  // the primary ray's (trace_ray passes 0)
    NeeState nee;
    typename Lights::Sample area;
    bool occluded = false;
    for (int b = 0;; ++b) {
        // ---- the closest ray: primary (b == 0) or bounce b ----
        float tmax = p.max_ray_dist;
        int c_inst, c_prim;
        bool unused;
        count.add(kRays);
        const bool walked = w.walk(root, ray_o, ray_d, false, tmin, tmax, c_inst, c_prim,
                                   unused, p.max_steps, count);
        count.phase(kPhClosest);
        if (!walked) return false;
        const HitInfo info =
            fe.shade(light, c_inst, c_prim, c_inst >= 0 ? tmax : -1.0f, ray_o, ray_d);
        count.add(c_inst >= 0 ? kShadeHits : kShadeMisses);
        count.phase(kPhShade);
        rec.closest(b, c_inst, c_prim, info);
        V3 atmo_att, in_scatter;
        if (b == 0) {
            count.phase(kPhOther);
            if (atmosphere_scattering(seed, light.direction, light.color, ray_o, ray_d,
                                      info.thit, atmo_att, in_scatter))
                count.add(kAtmoMarches);
            count.phase(kPhAtmo);
            contrib = (contrib + in_scatter) + atmo_att * info.m.albedo * info.emission;
            attenuation = atmo_att;
            roughness = info.m.roughness;
        } else {
            // area-light NEE of the previous hit, then its sun NEE (its
            // position is this ray's origin)
            contrib = lt.add(contrib, attenuation, area);
            V3 nee_color;
            count.phase(kPhOther);
            if (nee_finish(nee, light, ray_o, occluded, p.max_ray_dist, nee_color))
                count.add(kNeeMarches);
            count.phase(kPhNee);
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
            count.phase(kPhOther);
            if (atmosphere_scattering(seed, light.direction, light.color, ray_o, ray_d,
                                      info.thit, atmo_att, in_scatter))
                count.add(kAtmoMarches);
            count.phase(kPhAtmo);
            const float inv_mis = isinf(mis_pdf) ? 0.0f : 1.0f / mis_pdf;
            const float emission = lt.emission(info, c_inst, c_prim, ray_d, bsdf_pdf, count);
            contrib = contrib +
                      attenuation * (in_scatter + atmo_att * info.m.albedo * emission) *
                          inv_mis;
            const float inv_abs_pdf = bsdf_pdf == 0.0f ? f_inf() : 1.0f / fabsf(pdf_safe);
            attenuation = attenuation * atmo_att * inv_abs_pdf;
            // path-space regularization (reference: path_tracer.hh:734-737);
            // RECIP: gamma / pow(pdf, 0.25) is reciprocal(pow) * gamma
            if (bsdf_pdf > 0.0f)
                regularization =
                    regularization *
                    clamp_min(1.0f - (1.0f / powf(bsdf_pdf, 0.25f)) * p.gamma, 0.0f);
            roughness = 1.0f - (1.0f - info.m.roughness) * regularization;
        }
        if (b == p.max_bounces || !(info.thit > 0.0f)) return true;

        // ---- bounce b + 1: tangent-space view, NEE and BSDF draws ----
        V3 view = info.tbn.vec_mul(-ray_d);
        view.z = view.z < 1e-7f ? 1e-7f : view.z;
        view = normalize3(view);
        Material m = info.m;
        m.roughness = roughness;
        count.phase(kPhOther);
        nee = nee_prepare(seed, light, info, m, view);
        count.add(kNeeEvals);
        lt.sample(seed, info, m, view, area, count);
        count.phase(kPhNee);
        const F4 ub = uniform4(seed);
        count.phase(kPhCamera);
        const BsdfSample smp = sample_bsdf(ub.x, ub.y, ub.z, view, m);
        count.add(kBsdfSamples);
        count.phase(kPhBsdf);
        bsdf_atten = smp.attenuation;
        bsdf_pdf = smp.pdf;
        ray_o = info.pos;
        ray_d = normalize3(info.tbn.mul_vec(smp.direction));
        tmin = p.min_ray_dist;

        // ---- the any-hit shadow ray, only for a NEE colour that is not black
        occluded = false;
        if (!nee.black) {
            float tmax_s = p.max_ray_dist;
            int unused_inst, unused_prim;
            count.add(kRays);
            count.phase(kPhOther);
            const bool walked_s = w.walk(root, info.pos, nee.light_dir, true, p.min_ray_dist,
                                         tmax_s, unused_inst, unused_prim, occluded,
                                         p.max_steps, count);
            count.phase(kPhShadow);
            if (!walked_s) return false;
        }
        rec.shadow(b, occluded);
        if (!lt.shadow(w, root, info.pos, area, p, count)) return false;
        count.phase(kPhOther);
    }
}

// Per-pixel sums of a thread's samples, and the samples it abandoned.
struct Sums {
    float r, g, b, l2;
    int truncated;
};

// Samples [p.sample_base, p.sample_base + p.spp) of pixel (x, y), folded in
// sample order from 0.0f; the luminance-squared sum only `with_l2`.
// With an ItemRecord `rec`, the record build (K6) also writes each sample's
// hit topology; the other builds pass NoRecord, whose hooks are empty.
template <class Walk, class Fetch, class Lights, class Count, class Rec>
__device__ __forceinline__ Sums trace_samples(const Walk& w, const Fetch& fe, const Lights& lt,
                                              const PathParams& p, int x, int y,
                                              bool with_l2, Count& count, Rec& rec) {
    Sums s = {0.0f, 0.0f, 0.0f, 0.0f, 0};
    for (int k = 0; k < p.spp; ++k) {
        // sample_base + k as int32 (wraps as XLA's add does)
        const int sample_index = (int)((uint32_t)p.sample_base + (uint32_t)k);
        V3 c;
        rec.begin(k);
        if (!trace_sample(w, fe, lt, p, x, y, sample_index, c, count, rec)) {
            ++s.truncated;
            continue;
        }
        s.r = s.r + c.x;
        s.g = s.g + c.y;
        s.b = s.b + c.z;
        if (with_l2) {
            const float lum = 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
            s.l2 = s.l2 + lum * lum;
        }
    }
    return s;
}

template <class Walk, class Fetch, class Lights, class Count>
__device__ __forceinline__ Sums trace_samples(const Walk& w, const Fetch& fe, const Lights& lt,
                                              const PathParams& p, int x, int y,
                                              bool with_l2, Count& count) {
    NoRecord none;
    return trace_samples(w, fe, lt, p, x, y, with_l2, count, none);
}

// Where a path kernel writes: one entry's sums, once.
struct Out {
    float *r, *g, *b, *l2;       // (n,) sums; l2 null without stats
    int* n_truncated;            // one int32, added to
    unsigned long long* counts;  // kNCounts (counting build) or kNPhases (phase
                                 // build), added to; null in the other builds

    __device__ __forceinline__ void write(int i, const Sums& s) const {
        r[i] = s.r;
        g[i] = s.g;
        b[i] = s.b;
        if (l2) l2[i] = s.l2;
        if (s.truncated) atomicAdd(n_truncated, s.truncated);
    }
};

// The path kernels' designs: the first (128 threads a block) and the wide
// block (512 threads, one block an SM).
enum Design { kFirst = 0, kWide = 1 };

}  // namespace ptq
