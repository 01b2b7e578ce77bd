// The wavefront renderer (K5): whole sun-NEE paths for any list of pixels,
// on the binary or the wide tables, one thread per list entry.
//
// Replaces the JAX package's path-regeneration renderer
// pathtracing_tpu/ops/wavefront.py::path_trace_wavefront, an XLA while-loop
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
// sample's subframe row) with the unpacked shading fetch (tri_idx, vattr,
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
// warp runs as long as its longest path.  This first design is K2's: no
// queue, no regrouping of rays between bounces; registers and spills are
// reported by the build (chip_smoke.py), not chased.
//
// The counting build (kCount) adds each thread's row visits, tests and
// shading calls into a uint64 array (path.cuh, PathCount); chip_smoke.py
// turns them into the bound.  The timed kernel counts nothing.
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

namespace {

using namespace ptq;

constexpr int kBlock = 128;

// The pixel list: entry i is pixel (xs[i], ys[i]).
struct List {
    const int* xs;  // (n,) i32
    const int* ys;  // (n,) i32
    int n;
};

template <class Walk, class Fetch, bool kCount>
__global__ void __launch_bounds__(kBlock) wavefront(Walk w, Fetch fe, PathParams p, List l,
                                                    Out o) {
    const int i = blockIdx.x * kBlock + threadIdx.x;
    if (i >= l.n) return;
    typename std::conditional<kCount, PathCount, NoPathCount>::type count;
    o.write(i, trace_samples(w, fe, p, __ldg(l.xs + i), __ldg(l.ys + i), o.l2 != nullptr,
                             count));
    count.flush(o.counts);
}

template <class Walk, class Fetch>
int launch(const Walk& w, const Fetch& fe, const PathParams& p, const List& l, const Out& o,
           cudaStream_t s) {
    const dim3 grid((unsigned)((l.n + kBlock - 1) / kBlock)), block(kBlock);
    if (o.counts)
        wavefront<Walk, Fetch, true><<<grid, block, 0, s>>>(w, fe, p, l, o);
    else
        wavefront<Walk, Fetch, false><<<grid, block, 0, s>>>(w, fe, p, l, o);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` (f32 per mega-table row) selects the wide
// layout, and 0 the binary walk (then `rows`, `wide_root`, `root_base` and
// `tri_shade` are not read; otherwise `nl8`, `tri_idx`, `vattr` and
// `sf_tlas_count` are not).  Adds abandoned samples to *n_truncated, and with
// a non-null `counts` runs the counting build, which adds its counters there.
// Returns the launch's cudaError_t (0 = accepted), or -1 for a width no
// layout has.
extern "C" int pt_wavefront(
    const void* rows, int width, const void* wide_root, const void* root_base,
    const void* tri_shade, const void* nl8, const void* tri_idx, const void* vattr,
    const void* sf_tlas_count, int n_tlas_count, const void* tri_pos, const void* inst_f,
    const void* inst_u, const void* sf_cam, int n_cam, const void* sf_light, int n_light,
    const void* sf_tlas_offset, int n_tlas, const void* xs, const void* ys, int n, int spp,
    int sample_base, int image_width, int image_height, int max_bounces, int smbs,
    int student_id, float min_ray_dist, float max_ray_dist, float gamma, int max_steps,
    void* out_r, void* out_g, void* out_b, void* out_l2, void* n_truncated, void* counts,
    void* stream) {
    if (n <= 0) return 0;
    const PathParams p = {(const float*)sf_cam, (const float*)sf_light, n_cam, n_light,
                          spp, sample_base, image_width, image_height, max_bounces, smbs,
                          max_steps, (uint32_t)student_id, min_ray_dist, max_ray_dist, gamma};
    const List l = {(const int*)xs, (const int*)ys, n};
    const Out o = {(float*)out_r, (float*)out_g, (float*)out_b, (float*)out_l2,
                   (int*)n_truncated, (unsigned long long*)counts};
    cudaStream_t s = (cudaStream_t)stream;
    if (width == 0) {
        const BinaryWalk w = {(const float4*)nl8, (const float4*)tri_pos, (const float*)inst_f,
                              (const int*)inst_u, (const int*)sf_tlas_count,
                              (const int*)sf_tlas_offset, n_tlas_count, n_tlas};
        const UnpackedFetch fe = {(const float4*)tri_pos, (const int*)tri_idx,
                                  (const float*)vattr, (const float*)inst_f,
                                  (const int*)inst_u};
        return launch(w, fe, p, l, o, s);
    }
    const PackedFetch fe = {(const float*)tri_shade, (const float*)inst_f, (const int*)inst_u};
#define PT_WF_LAUNCH(S, L, STUB)                                                          \
    if (width == Layout<S, L, STUB>::kWidth)                                              \
        return launch(WideWalk<S, L, STUB>{(const float4*)rows, (const uint32_t*)wide_root, \
                                           (const int*)root_base, (const float4*)tri_pos,   \
                                           (const int*)inst_u, (const int*)sf_tlas_offset,  \
                                           n_tlas},                                         \
                      fe, p, l, o, s);
    PT_WF_LAUNCH(8, 4, false)   // w8
    PT_WF_LAUNCH(16, 8, false)  // w16
    PT_WF_LAUNCH(8, 8, true)    // s8
#undef PT_WF_LAUNCH
    return -1;
}

extern "C" int pt_wavefront_block_size(void) { return kBlock; }

extern "C" int pt_wavefront_count_slots(void) { return kNCounts; }

// Blocks of the (timed) kernel for this row width (0: the binary walk) one
// SM holds at once (negative: the CUDA error), or 0 for a width no layout has.
extern "C" int pt_wavefront_occupancy(int width) {
    if (width == 0)
        return resident_blocks_per_sm(wavefront<BinaryWalk, UnpackedFetch, false>, kBlock);
    if (width == Layout<8, 4, false>::kWidth)
        return resident_blocks_per_sm(wavefront<WideWalk<8, 4, false>, PackedFetch, false>,
                                      kBlock);
    if (width == Layout<16, 8, false>::kWidth)
        return resident_blocks_per_sm(wavefront<WideWalk<16, 8, false>, PackedFetch, false>,
                                      kBlock);
    if (width == Layout<8, 8, true>::kWidth)
        return resident_blocks_per_sm(wavefront<WideWalk<8, 8, true>, PackedFetch, false>,
                                      kBlock);
    return 0;
}
