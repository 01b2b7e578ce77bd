// The megakernel (K2): whole paths, one thread per pixel slot: sun NEE, and
// area-light NEE where the scene carries light tables.
//
// Replaces the JAX package's persistent-lane renderer
// the JAX package's ops/megakernel.py::path_trace_megakernel (with _service
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
// order: path.cuh's trace_samples with the wide walk (wide_walk.cuh) and the
// packed shading fetch (one tri_shade row per hit), both inlined.  The
// wavefront kernel (wavefront.cu, K5) runs the same body over an (x, y)
// list.
//
// The fold.  A thread adds its samples into r, g, b (and lum^2) registers
// starting from 0.0f, in sample order, and writes each pixel once: the sums
// are deterministic and in the plain version's order (a sample-ordered sum of
// path_trace_samples), with no float atomics.  Two launches give the same
// bytes.
//
// The step cap.  JAX caps its while-loop's periods; here each ray's walk is
// capped at `max_steps` row visits (the wrapper's default is derived from the
// tables: a bound no walk that ends can pass, ops/cuda_megakernel.step_cap).
// A sample one of whose rays hits the cap is abandoned (not folded) and
// counted in n_truncated.
//
// What bounds it on an H100: issue and latency.  The golden scene's tables
// (~1.5 MB) sit in L2 and the output is 12-16 B per pixel; a sample is ~11
// dependent walks of tens of row visits each plus ~1,000 flops of shading
// per bounce (the atmosphere march dominates), and a warp runs as long as
// its longest path.
//
// Two designs, one body, one thread per slot: the kernel is a template on
// its threads a block.  The first design runs 128 threads a block, four
// blocks an SM at 128 registers.  The wide block runs 512 threads, one
// block an SM: the same 16 warps, but on 512 adjacent slots, so the rays an
// SM holds at once are coherent and share the rows in its L1 (the first
// design's four blocks on an SM are launched 132 blocks apart).  A slot's
// samples run in one thread in sample order and its sums are written once
// in both, so both give the same bytes.  The wrapper picks the design per
// layout (ops/cuda_megakernel.DESIGN_BY_WIDTH): on the card the wide block
// is the faster on every layout (PERF.md).  Staging the hottest mega-table
// rows in the wide block's shared memory was slower than the same block
// without it (the hot rows are in L1 already), and a persistent grid of
// 512-thread blocks taking slots at a static stride was slower than both;
// neither is kept.
//
// The counting build (PathCount) adds each thread's row visits, tests and
// shading calls into a uint64 array at its end; chip_smoke.py turns them
// into the bound.  The phase-cycle build (PhaseClock) adds each thread's
// clock64() cycles per phase of the path.  Both are instruments, separate
// instantiations: the timed kernels count nothing.
//
// The record build (K6, megakernel_record, in the same two designs) is
// the same paths, plus each work item's hit topology for the fast
// gradients' replay (diff/render.make_fast_grad_frame_fn; JAX:
// path_trace_megakernel with record=True,
// the JAX package's ops/megakernel.py:554, capture :330-375).  Per work item
// it adds 8 B of stores to K2's work, and 9 B per bounce row its path
// reaches.
//
// Area lights.  A scene with light tables (ops/arealights.py) launches the
// AreaLights instances of path.cuh's light policy (the JAX megakernel's
// _PH_SHADOW2 phase: one more draw, a light sample and an any-hit walk
// toward it per bounce, the terms added in the scan's order); the sun-only
// instances are the NoAreaLights ones, whose hooks are empty, so they
// compile as before.  The light instances are built into a library of their
// own from this source (-DPT_AREA_LIGHTS=1, ops/cuda_megakernel.py's
// LIT_LIBRARY), so that the two compile side by side; they exist for the
// timed designs and the counting build.  The record build (K6) refuses light
// tables, as the JAX package's record mode does, and the phase-cycle build
// has none.
//
// Parity: built with --fmad=false, IEEE division and square root, no
// fast-math, no flush-to-zero (ops/cuda_build.py); shading.cuh has the rules
// that keep a sample on the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binary_walk.cuh"
#include "path.cuh"
#include "ray_common.cuh"
#include "shading.cuh"
#include "wide_walk.cuh"

#ifndef PT_AREA_LIGHTS
#define PT_AREA_LIGHTS 0  // 1: the area-light instances (AreaLights), 0: the sun-only ones
#endif

namespace {

using namespace ptq;

// The light policy this library instantiates.
using Lit = std::conditional_t<PT_AREA_LIGHTS != 0, AreaLights, NoAreaLights>;

constexpr int kBlock = 128;      // the first design: four blocks an SM
constexpr int kWideBlock = 512;  // the wide block: one block an SM

// The frame's pixel slots: slot i renders pixel pixel_base + pixel_order[i]
// (or pixel_base + i) of a row-major frame `width` pixels wide.
struct Slots {
    const int* pixel_order;  // (n_pixels,) i32 permutation, or null
    int n_pixels, pixel_base;
};

template <class Count, class Walk, class Lights>
__device__ __forceinline__ void render_slot(const Walk& w, const PackedFetch& fe,
                                            const Lights& lt, const PathParams& p,
                                            const Slots& sl, const Out& o, int slot) {
    const int local = sl.pixel_order ? __ldg(sl.pixel_order + slot) : slot;
    const int pixel = sl.pixel_base + local;
    Count count;
    o.write(local, trace_samples(w, fe, lt, p, pixel % p.width, pixel / p.width,
                                 o.l2 != nullptr, count));
    count.flush(o.counts);
}

// One slot per thread, kThreads a block.
template <int kThreads, int S, int L, bool STUB, class Count, class Lights>
__global__ void __launch_bounds__(kThreads) megakernel(WideWalk<S, L, STUB> w, PackedFetch fe,
                                                       PathParams p, Slots sl, Out o,
                                                       Lights lt) {
    const int slot = blockIdx.x * kThreads + threadIdx.x;
    if (slot < sl.n_pixels) render_slot<Count>(w, fe, lt, p, sl, o, slot);
}

// The record build (K6): the same paths and sums as the timed build, bit
// for bit, plus each work item's hit topology (path.cuh's ItemRecord).  Slot
// i renders pixel pixel_base + i (records are indexed by work item, and the
// replay assumes that map: no pixel order).  Kernels of their own, so the
// timed builds' code and registers do not change.
template <class Walk>
__device__ __forceinline__ void record_slot(const Walk& w, const PackedFetch& fe,
                                            const PathParams& p, const Slots& sl, const Out& o,
                                            const ItemRecord& rec0, int slot) {
    const int pixel = sl.pixel_base + slot;
    NoPathCount count;
    ItemRecord rec = rec0;
    rec.slot = slot;
    o.write(slot, trace_samples(w, fe, NoAreaLights{}, p, pixel % p.width, pixel / p.width,
                                false, count, rec));
}

template <int kThreads, int S, int L, bool STUB>
__global__ void __launch_bounds__(kThreads) megakernel_record(WideWalk<S, L, STUB> w,
                                                              PackedFetch fe, PathParams p,
                                                              Slots sl, Out o, ItemRecord rec0) {
    const int slot = blockIdx.x * kThreads + threadIdx.x;
    if (slot < sl.n_pixels) record_slot(w, fe, p, sl, o, rec0, slot);
}

// The build a launch asks for.
enum Build { kTimed, kCounting, kPhases, kRecord };

// One design's kernels: kThreads a block.  The light instances: the timed
// and the counting build only (the caller refuses the others).
template <int kThreads, int S, int L, bool STUB, class Lights>
int launch_design(const WideWalk<S, L, STUB>& w, const PackedFetch& fe, const Lights& lt,
                  const PathParams& p, const Slots& sl, const Out& o, const ItemRecord& rec,
                  Build build, cudaStream_t s) {
    const dim3 grid((unsigned)((sl.n_pixels + kThreads - 1) / kThreads)), block(kThreads);
    if constexpr (!Lights::kLit) {
        if (build == kRecord) {
            megakernel_record<kThreads, S, L, STUB><<<grid, block, 0, s>>>(w, fe, p, sl, o, rec);
            return (int)cudaGetLastError();
        }
        if (build == kPhases) {
            megakernel<kThreads, S, L, STUB, PhaseClock, Lights>
                <<<grid, block, 0, s>>>(w, fe, p, sl, o, lt);
            return (int)cudaGetLastError();
        }
    }
    if (build == kCounting)
        megakernel<kThreads, S, L, STUB, PathCount, Lights>
            <<<grid, block, 0, s>>>(w, fe, p, sl, o, lt);
    else
        megakernel<kThreads, S, L, STUB, NoPathCount, Lights>
            <<<grid, block, 0, s>>>(w, fe, p, sl, o, lt);
    return (int)cudaGetLastError();
}

// The counting build runs the first design (an instrument); the others the
// design asked for.
template <int S, int L, bool STUB, class Lights>
int launch(const WideWalk<S, L, STUB>& w, const PackedFetch& fe, const Lights& lt,
           const PathParams& p, const Slots& sl, const Out& o, const ItemRecord& rec,
           Build build, int design, cudaStream_t s) {
    if (build == kCounting || design == kFirst)
        return launch_design<kBlock>(w, fe, lt, p, sl, o, rec, build, s);
    return launch_design<kWideBlock>(w, fe, lt, p, sl, o, rec, build, s);
}

// The library's light policy from the launch's light tables.
template <class Lights>
Lights lit_policy(const AreaLights& lights);
template <>
AreaLights lit_policy<AreaLights>(const AreaLights& lights) { return lights; }
template <>
NoAreaLights lit_policy<NoAreaLights>(const AreaLights&) { return {}; }

template <int S, int L, bool STUB>
WideWalk<S, L, STUB> wide_walk_of(const void* rows, const void* wide_root,
                                  const void* root_base, const void* tri_pos,
                                  const void* inst_u, const void* sf_tlas_offset, int n_tlas) {
    return {(const float4*)rows, (const uint32_t*)wide_root, (const int*)root_base,
            (const float4*)tri_pos, (const int*)inst_u, (const int*)sf_tlas_offset, n_tlas};
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` (f32 per mega-table row) selects the layout.
// Adds abandoned samples to *n_truncated.  With a non-null `counts` it runs
// the counting build, which adds its counters there; with a non-null
// `phases` the phase-cycle build, which adds kNPhases cycle sums there.
// With a non-null `rec_pk_p` it runs the record build (K6), which writes the
// records into the five planes (zeroed by the caller; n_pixels * spp items,
// sample-major): primary pk and prim (n_items,), bounce pk, prim and occ
// (max_bounces * n_items,).  `design`: 0 the first design, 1 the wide block;
// the counting build runs the first design.  The area-light library
// (PT_AREA_LIGHTS) takes a non-null `lt_tris` (the five lt_* tables, L =
// n_lights rows, and tri_idx / vattr for the emission at a light point), the
// sun-only one a null one.  Returns the launch's cudaError_t (0 =
// accepted), -1 for a width no layout has, -2 for records asked with counts,
// phases, l2, a pixel order or light tables, counts with phases, phases with
// light tables, no light rows, or a design that does not exist, -3 for light
// tables this library does not take (or their absence).
extern "C" int pt_megakernel(
    const void* rows, int width, const void* wide_root, const void* root_base,
    const void* tri_pos, const void* inst_f, const void* inst_u, const void* tri_shade,
    const void* sf_cam, int n_cam, const void* sf_light, int n_light,
    const void* sf_tlas_offset, int n_tlas, const void* pixel_order, int n_pixels,
    int spp, int sample_base, int pixel_base, int image_width, int image_height,
    int max_bounces, int smbs, int student_id, float min_ray_dist, float max_ray_dist,
    float gamma, int max_steps, void* out_r, void* out_g, void* out_b, void* out_l2,
    void* n_truncated, void* counts, void* phases, int design, void* rec_pk_p,
    void* rec_prim_p, void* rec_pk_b, void* rec_prim_b, void* rec_occ_b,
    const void* lt_tris, const void* lt_rows, const void* lt_cdf, const void* lt_seg,
    const void* lt_rank, int n_lights, const void* tri_idx, const void* vattr, void* stream) {
    if (rec_pk_p && (counts || phases || out_l2 || pixel_order || lt_tris)) return -2;
    if ((counts && phases) || design < kFirst || design > kWide) return -2;
    if (lt_tris && (phases || n_lights <= 0)) return -2;
    if ((lt_tris != nullptr) != Lit::kLit) return -3;
    if (n_pixels <= 0) return 0;
    const PackedFetch fe = {(const float*)tri_shade, (const float*)inst_f, (const int*)inst_u};
    const PathParams p = {(const float*)sf_cam, (const float*)sf_light, n_cam, n_light,
                          spp, sample_base, image_width, image_height, max_bounces, smbs,
                          max_steps, (uint32_t)student_id, min_ray_dist, max_ray_dist, gamma};
    const Slots sl = {(const int*)pixel_order, n_pixels, pixel_base};
    const Out o = {(float*)out_r, (float*)out_g, (float*)out_b, (float*)out_l2,
                   (int*)n_truncated, (unsigned long long*)(phases ? phases : counts)};
    const ItemRecord rec = {(int*)rec_pk_p, (int*)rec_prim_p, (int*)rec_pk_b,
                            (int*)rec_prim_b, (uint8_t*)rec_occ_b, n_pixels * spp, n_pixels,
                            0, 0};
    const Build build = rec_pk_p ? kRecord : (counts ? kCounting : (phases ? kPhases : kTimed));
    const AreaLights lights = {(const float*)lt_tris, (const int*)lt_rows, (const float*)lt_cdf,
                               (const int*)lt_seg,    (const int*)lt_rank, (const int*)tri_idx,
                               (const float*)vattr,   (const int*)inst_u,  n_lights};
    cudaStream_t s = (cudaStream_t)stream;
#define PT_MK_LAUNCH(S, L, STUB)                                                          \
    if (width == Layout<S, L, STUB>::kWidth) {                                            \
        const WideWalk<S, L, STUB> w = wide_walk_of<S, L, STUB>(                          \
            rows, wide_root, root_base, tri_pos, inst_u, sf_tlas_offset, n_tlas);         \
        return launch(w, fe, lit_policy<Lit>(lights), p, sl, o, rec, build, design, s);  \
    }
    PT_MK_LAUNCH(8, 4, false)   // w8
    PT_MK_LAUNCH(16, 8, false)  // w16
    PT_MK_LAUNCH(8, 8, true)    // s8
#undef PT_MK_LAUNCH
    return -1;
}

extern "C" int pt_megakernel_block_size(int design) {
    return design == kFirst ? kBlock : kWideBlock;
}

extern "C" int pt_megakernel_count_slots(void) { return kNCounts; }

extern "C" int pt_megakernel_phase_slots(void) { return kNPhases; }

// Blocks of the layout's timed kernel in `design` (this library's light
// policy) one SM holds at once (negative: the CUDA error), or 0 for a width
// no layout has.
extern "C" int pt_megakernel_occupancy(int width, int design) {
#define PT_MK_OCC(S, L, STUB)                                                       \
    if (width == Layout<S, L, STUB>::kWidth)                                        \
        return design == kFirst                                                     \
                   ? resident_blocks_per_sm(                                        \
                         megakernel<kBlock, S, L, STUB, NoPathCount, Lit>, kBlock)  \
                   : resident_blocks_per_sm(                                        \
                         megakernel<kWideBlock, S, L, STUB, NoPathCount, Lit>, kWideBlock);
    PT_MK_OCC(8, 4, false)
    PT_MK_OCC(16, 8, false)
    PT_MK_OCC(8, 8, true)
#undef PT_MK_OCC
    return 0;
}
