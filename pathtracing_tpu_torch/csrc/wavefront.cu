// The wavefront renderer (K5): whole paths for any list of pixels, on the
// binary or the wide tables, one thread per list entry: sun NEE, and
// area-light NEE where the scene carries light tables.
//
// Replaces the JAX package's path-regeneration renderer
// the JAX package's ops/wavefront.py::path_trace_wavefront, an XLA while-loop
// there (R lanes, one per list entry; a lane whose path dies respawns its
// pixel's next sample, and the sample folds into the lane's sums when its
// path dies).  It computes the same function: for entry i of (xs, ys), the
// sums of the samples [sample_base, sample_base + spp) of the reference's
// path loop at pixel (xs[i], ys[i]) (reference: path_tracer.hh:637-741), and
// with with_stats the sums of each sample's luminance squared.  The output is
// per entry: a pixel listed twice gets its sums twice.
//
// Design.  The JAX loop regenerates paths so that its SIMD lanes stay busy
// while they step together.  A CUDA thread leaves its own loop, so thread i
// runs entry i's samples in order, each one path.cuh's trace_sample, and
// adds them in registers from 0.0f: the fold is in sample order (the JAX
// loop's order too, since a lane's samples die in order), deterministic,
// with no float atomics; each entry is written once.  Four instantiations:
// the binary walk (binary_walk.cuh, the TLAS count and offset of the
// sample's subframe row; nl8 or nl5 rows, below) with the unpacked shading fetch (tri_idx, vattr,
// tri_pos: binary scenes carry no tri_shade rows), and the wide walk
// (wide_walk.cuh) in the w8, w16 and s8 layouts with the packed fetch, which
// is K2's body (megakernel.cu) over a list.
//
// The step cap: each ray's walk is capped at `max_steps` row visits (the
// wrapper's default is a bound derived from the tables that no walk that
// ends can pass, ops/cuda_megakernel.step_cap); a sample that hits it is
// abandoned, not folded, and counted in n_truncated.
//
// What bounds it on an H100: issue and latency, as K2.  The golden scene's
// tables (~1.5 MB) sit in L2, the list is 8 B and the output 12-16 B per
// entry; a sample is a few dependent walks of tens of row visits each plus
// ~1,000 flops of shading per bounce (the atmosphere march dominates), and a
// warp runs as long as its longest path.
//
// Two designs, as K2's (megakernel.cu), one thread per entry: the first
// (128 threads a block, four an SM) and the wide block (512 threads, one an
// SM, its warps on 512 adjacent entries).  Both give the same bytes; the
// wrapper picks the design per table kind: on the card the first design is
// the faster on the binary tables, the wide block on the mega-tables.
//
// The counting build (PathCount) adds each thread's row visits, tests and
// shading calls into a uint64 array; chip_smoke.py turns them into the
// bound.  The phase-cycle build (PhaseClock) adds each thread's clock64()
// cycles per phase of the path.  The timed kernels count nothing.
//
// Node rows.  A library walks the binary tables in one row format,
// PT_NODE_ROWS = 8 (nl8, the default) or 5 (the bf16 rows of
// scene/device.with_bf16_nodes, binary_walk.cuh's Nl5Rows); a library of
// nl5 rows has no wide instances (a scene with wide tables walks them and
// ignores nl5).  The nl5 instances build into libraries of their own
// (ops/cuda_wavefront.py's NL5_LIBRARY, NL5_LIT_LIBRARY), beside the others.
//
// Area lights.  A scene with light tables launches the AreaLights instances
// of path.cuh's light policy (the JAX wavefront's light branch), the timed
// designs and the counting build of every table kind; the sun-only
// instances (NoAreaLights) compile as before.  The light instances are built
// into a library of their own from this source (-DPT_AREA_LIGHTS=1,
// ops/cuda_wavefront.py's LIT_LIBRARY), so that the two compile side by
// side.
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
#ifndef PT_NODE_ROWS
#define PT_NODE_ROWS 8  // the binary walk's node rows: 8 nl8 (and the wide walks), 5 nl5
#endif
static_assert(PT_NODE_ROWS == 8 || PT_NODE_ROWS == 5, "PT_NODE_ROWS: 8 or 5");

namespace {

using namespace ptq;

// The light policy this library instantiates.
using Lit = std::conditional_t<PT_AREA_LIGHTS != 0, AreaLights, NoAreaLights>;
// The binary walk this library instantiates, and its node rows' pointer type.
using Rows = std::conditional_t<PT_NODE_ROWS == 5, Nl5Rows, Nl8Rows>;
using Binary = BinaryWalk<Rows>;
using RowPtr = decltype(Rows::rows);

constexpr int kBlock = 128;      // the first design: four blocks an SM
constexpr int kWideBlock = 512;  // the wide block: one block an SM

// The pixel list: entry i is pixel (xs[i], ys[i]).
struct List {
    const int* xs;  // (n,) i32
    const int* ys;  // (n,) i32
    int n;
};

template <class Count, class Walk, class Fetch, class Lights>
__device__ __forceinline__ void render_entry(const Walk& w, const Fetch& fe, const Lights& lt,
                                             const PathParams& p, const List& l, const Out& o,
                                             int i) {
    Count count;
    o.write(i, trace_samples(w, fe, lt, p, __ldg(l.xs + i), __ldg(l.ys + i),
                             o.l2 != nullptr, count));
    count.flush(o.counts);
}

// One entry per thread, kThreads a block.
template <int kThreads, class Walk, class Fetch, class Count, class Lights>
__global__ void __launch_bounds__(kThreads) wavefront(Walk w, Fetch fe, PathParams p, List l,
                                                      Out o, Lights lt) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < l.n) render_entry<Count>(w, fe, lt, p, l, o, i);
}

// The build a launch asks for.
enum Build { kTimed, kCounting, kPhases };

// One design's kernels: kThreads a block.  The light instances: the timed
// and the counting build only (the caller refuses phases with lights).
template <int kThreads, class Walk, class Fetch, class Lights>
int launch_design(const Walk& w, const Fetch& fe, const Lights& lt, const PathParams& p,
                  const List& l, const Out& o, Build build, cudaStream_t s) {
    const dim3 grid((unsigned)((l.n + kThreads - 1) / kThreads)), block(kThreads);
    if constexpr (!Lights::kLit) {
        if (build == kPhases) {
            wavefront<kThreads, Walk, Fetch, PhaseClock, Lights>
                <<<grid, block, 0, s>>>(w, fe, p, l, o, lt);
            return (int)cudaGetLastError();
        }
    }
    if (build == kCounting)
        wavefront<kThreads, Walk, Fetch, PathCount, Lights>
            <<<grid, block, 0, s>>>(w, fe, p, l, o, lt);
    else
        wavefront<kThreads, Walk, Fetch, NoPathCount, Lights>
            <<<grid, block, 0, s>>>(w, fe, p, l, o, lt);
    return (int)cudaGetLastError();
}

// The counting build runs the first design (an instrument); the others the
// design asked for.
template <class Walk, class Fetch, class Lights>
int launch(const Walk& w, const Fetch& fe, const Lights& lt, const PathParams& p,
           const List& l, const Out& o, Build build, int design, cudaStream_t s) {
    if (build == kCounting || design == kFirst)
        return launch_design<kBlock>(w, fe, lt, p, l, o, build, s);
    return launch_design<kWideBlock>(w, fe, lt, p, l, o, build, s);
}

// The library's light policy from the launch's light tables.
template <class Lights>
Lights lit_policy(const AreaLights& lights);
template <>
AreaLights lit_policy<AreaLights>(const AreaLights& lights) { return lights; }
template <>
NoAreaLights lit_policy<NoAreaLights>(const AreaLights&) { return {}; }

template <class Walk, class Fetch>
int launch_lit(const Walk& w, const Fetch& fe, const AreaLights& lights, const PathParams& p,
               const List& l, const Out& o, Build build, int design, cudaStream_t s) {
    return launch(w, fe, lit_policy<Lit>(lights), p, l, o, build, design, s);
}

template <class Walk, class Fetch>
int occupancy(int design) {
    return design == kFirst
               ? resident_blocks_per_sm(wavefront<kBlock, Walk, Fetch, NoPathCount, Lit>,
                                        kBlock)
               : resident_blocks_per_sm(
                     wavefront<kWideBlock, Walk, Fetch, NoPathCount, Lit>, kWideBlock);
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` (f32 per mega-table row) selects the wide
// layout, and 0 the binary walk (then `rows`, `wide_root`, `root_base` and
// `tri_shade` are not read; otherwise `nodes`, `tri_idx`, `vattr` and
// `sf_tlas_count` are not).  `nodes`: the binary node table in this
// library's format (pt_wavefront_node_words); a library of nl5 rows takes
// width 0 only.  Adds abandoned samples to *n_truncated.  With a
// non-null `counts` it runs the counting build, which adds its counters
// there; with a non-null `phases` the phase-cycle build, which adds
// kNPhases cycle sums there.  `design`: 0 the first design, 1 the wide
// block; the counting build runs the first design.  The area-light library
// (PT_AREA_LIGHTS) takes a non-null `lt_tris` (the five lt_* tables, L =
// n_lights rows; tri_idx and vattr are then read on either walk, for the
// emission at a light point), the sun-only one a null one.  Returns the
// launch's cudaError_t (0 = accepted), -1 for a width no layout has, -2 for
// counts with phases, phases with light tables, no light rows, or a design
// that does not exist, -3 for light tables this library does not take (or
// their absence).
extern "C" int pt_wavefront(
    const void* rows, int width, const void* wide_root, const void* root_base,
    const void* tri_shade, const void* nodes, const void* tri_idx, const void* vattr,
    const void* sf_tlas_count, int n_tlas_count, const void* tri_pos, const void* inst_f,
    const void* inst_u, const void* sf_cam, int n_cam, const void* sf_light, int n_light,
    const void* sf_tlas_offset, int n_tlas, const void* xs, const void* ys, int n, int spp,
    int sample_base, int image_width, int image_height, int max_bounces, int smbs,
    int student_id, float min_ray_dist, float max_ray_dist, float gamma, int max_steps,
    void* out_r, void* out_g, void* out_b, void* out_l2, void* n_truncated, void* counts,
    void* phases, int design, const void* lt_tris, const void* lt_rows, const void* lt_cdf,
    const void* lt_seg, const void* lt_rank, int n_lights, void* stream) {
    if ((counts && phases) || design < kFirst || design > kWide) return -2;
    if (lt_tris && (phases || n_lights <= 0)) return -2;
    if ((lt_tris != nullptr) != Lit::kLit) return -3;
    if (n <= 0) return 0;
    const PathParams p = {(const float*)sf_cam, (const float*)sf_light, n_cam, n_light,
                          spp, sample_base, image_width, image_height, max_bounces, smbs,
                          max_steps, (uint32_t)student_id, min_ray_dist, max_ray_dist, gamma};
    const List l = {(const int*)xs, (const int*)ys, n};
    const Out o = {(float*)out_r, (float*)out_g, (float*)out_b, (float*)out_l2,
                   (int*)n_truncated, (unsigned long long*)(phases ? phases : counts)};
    const Build build = counts ? kCounting : (phases ? kPhases : kTimed);
    const AreaLights lights = {(const float*)lt_tris, (const int*)lt_rows, (const float*)lt_cdf,
                               (const int*)lt_seg,    (const int*)lt_rank, (const int*)tri_idx,
                               (const float*)vattr,   (const int*)inst_u,  n_lights};
    cudaStream_t s = (cudaStream_t)stream;
    if (width == 0) {
        const Binary w = {{static_cast<RowPtr>(nodes)}, (const float4*)tri_pos,
                          (const float*)inst_f, (const int*)inst_u, (const int*)sf_tlas_count,
                          (const int*)sf_tlas_offset, n_tlas_count, n_tlas};
        const UnpackedFetch fe = {(const float4*)tri_pos, (const int*)tri_idx,
                                  (const float*)vattr, (const float*)inst_f,
                                  (const int*)inst_u};
        return launch_lit(w, fe, lights, p, l, o, build, design, s);
    }
#if PT_NODE_ROWS == 8
    const PackedFetch fe = {(const float*)tri_shade, (const float*)inst_f, (const int*)inst_u};
#define PT_WF_LAUNCH(S, L, STUB)                                                          \
    if (width == Layout<S, L, STUB>::kWidth)                                              \
        return launch_lit(                                                                \
            WideWalk<S, L, STUB>{(const float4*)rows, (const uint32_t*)wide_root,         \
                                 (const int*)root_base, (const float4*)tri_pos,           \
                                 (const int*)inst_u, (const int*)sf_tlas_offset, n_tlas}, \
            fe, lights, p, l, o, build, design, s);
    PT_WF_LAUNCH(8, 4, false)   // w8
    PT_WF_LAUNCH(16, 8, false)  // w16
    PT_WF_LAUNCH(8, 8, true)    // s8
#undef PT_WF_LAUNCH
#endif
    return -1;
}

extern "C" int pt_wavefront_block_size(int design) {
    return design == kFirst ? kBlock : kWideBlock;
}

extern "C" int pt_wavefront_count_slots(void) { return kNCounts; }

// f32 words of a binary node row in this library's format: 8 (nl8) or 5 (nl5).
extern "C" int pt_wavefront_node_words(void) { return PT_NODE_ROWS; }

extern "C" int pt_wavefront_phase_slots(void) { return kNPhases; }

// Blocks of the timed kernel for this row width (0: the binary walk) in
// `design` (this library's light policy) one SM holds at once (negative:
// the CUDA error), or 0 for a width no layout has.
extern "C" int pt_wavefront_occupancy(int width, int design) {
    if (width == 0) return occupancy<Binary, UnpackedFetch>(design);
#if PT_NODE_ROWS == 8
    if (width == Layout<8, 4, false>::kWidth)
        return occupancy<WideWalk<8, 4, false>, PackedFetch>(design);
    if (width == Layout<16, 8, false>::kWidth)
        return occupancy<WideWalk<16, 8, false>, PackedFetch>(design);
    if (width == Layout<8, 8, true>::kWidth)
        return occupancy<WideWalk<8, 8, true>, PackedFetch>(design);
#endif
    return 0;
}
