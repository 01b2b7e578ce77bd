// Ray query on the wide-BVH mega-table: one thread per ray.
//
// Replaces the JAX package's XLA while-loop walk
// the JAX package's ops/wide_traversal.py::wide_ray_query (_wide_init,
// _wide_step, _leaf_block, _wide_drain), at its one-speed setting
// (leaf_every=None, no compaction).  It computes the same function: per ray
// the stackless mega-table walk of wide_walk.cuh (one row per step, branching
// on the cursor's kind), which the megakernel (megakernel.cu) runs too, then
// _finalize_hit as in ray_query.cu.
//
// What bounds it on an H100: issue and latency, not device memory.  The
// golden scene's tables (~1 MB) sit in the 50 MB L2; a WIDE row is up to
// ~220 flops of slab tests, every row address depends on the row before it,
// and a warp runs as long as its longest ray.  What the design does:
//   * The XLA loop stepped all lanes together, so it masked three row kinds
//     per step, parked leaf rows and compacted lanes to fight batch-wide
//     skew.  Here a thread branches on its own row kind and leaves its own
//     loop: the state (cursor, two resume cursors, the BLAS-space ray) lives
//     in registers, and those schedules have nothing left to do, so the
//     wrapper takes neither knob.
//   * Rows are 16-byte aligned multiples of 16 bytes and are read through
//     the read-only path as float4 (a w8 WIDE row: 8 loads + the exit word).
//     A table of a few hundred KB stays in L2; a larger one is served from
//     device memory, no table size is refused.
//   * One template over (slots, leaf triangles, stub) serves the three
//     shipped layouts; the wrapper picks by row width.
//   * Tried on the card and taken out again (PERF.md): persistent warps
//     over an active-ray queue in shared memory (1.2-2.1x slower on both
//     main-path batches at every refill threshold tried: the batches' lanes
//     already fill a warp to 87 % / 58 %, and inactive lanes come in whole
//     warps), a WIDE visit that tests only the slots from the start slot's
//     group on and reads a link word only for a slot that passed (no gain
//     resolved from the noise), a 64-register cap for w8 (232 B of spills,
//     no gain), and the walk as a per-step function (1.4-1.8x slower even
//     without the queue).  Of Hopper's additions none fits: tensor cores
//     have no matrix product to do in a walk, and TMA has no tile to fetch
//     ahead, since each row's address depends on the slab test of the row
//     before it.
//
// Parity: built with --fmad=false, IEEE division, no fast-math, no
// flush-to-zero (ops/cuda_build.py); wide_walk.cuh has the walk's bit rules.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"
#include "wide_walk.cuh"

namespace {

using namespace ptq;

constexpr int kBlock = 128;

template <int S, int L, bool STUB>
__global__ void __launch_bounds__(kBlock) wide_ray_query_kernel(
    const float4* __restrict__ rows,     // (M, W) f32 as W/4 float4 per row
    const uint32_t* __restrict__ wide_root,  // (K, 8) root cursors
    const int* __restrict__ root_base,   // one int32, or null
    const float4* __restrict__ tri_pos,  // (T, 12) f32 as 3 x float4 per row
    const float* __restrict__ inst_f,    // (I, 21) f32
    const int* __restrict__ inst_u,      // (I, 6) i32
    const int* __restrict__ tlas_offset,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin_lane,       // per-lane tmin, or null
    const float* __restrict__ tmax_lane,       // per-lane tmax0, or null
    const uint8_t* __restrict__ active,        // bool per lane
    const uint8_t* __restrict__ anyhit_lane,   // bool per lane, or null
    float tmin_all, float tmax_all, int anyhit_all,
    HitOut out, int R) {
    const int r = blockIdx.x * kBlock + threadIdx.x;
    if (r >= R) return;

    // An inactive lane reads its `active` byte and nothing else, and writes
    // a miss: the batches of a bounce hold many such lanes.
    if (active[r] == 0) {
        write_miss(out, r);
        return;
    }

    const V3 org = {ox[r], oy[r], oz[r]};
    const V3 dir = {dx[r], dy[r], dz[r]};
    const bool any = anyhit_lane ? anyhit_lane[r] != 0 : anyhit_all != 0;
    const float tmin = tmin_lane ? tmin_lane[r] : tmin_all;
    float tmax = tmax_lane ? tmax_lane[r] : tmax_all;
    int c_inst, c_prim;
    bool occluded;
    NoWalkCount count;
    wide_walk<S, L, STUB, false>(
        rows, tri_pos, inst_u, root_cursor(wide_root, root_base, tlas_offset[r], dir),
        org, dir, safe_inv(dir), any, tmin, tmax, c_inst, c_prim, occluded, 0, count);
    finalize_hit(tri_pos, inst_f, inst_u, org, dir, c_inst, c_prim, tmax,
                 occluded, out, r);
}

template <int S, int L, bool STUB>
int launch(const void* rows, const void* wide_root, const void* root_base,
           const void* tri_pos, const void* inst_f, const void* inst_u,
           const void* tlas_offset, const void* ox, const void* oy,
           const void* oz, const void* dx, const void* dy, const void* dz,
           const void* tmin_lane, const void* tmax_lane, const void* active,
           const void* anyhit_lane, float tmin_all, float tmax_all,
           int anyhit_all, HitOut out, int R, cudaStream_t s) {
    const dim3 grid((unsigned)((R + kBlock - 1) / kBlock)), block(kBlock);
    wide_ray_query_kernel<S, L, STUB><<<grid, block, 0, s>>>(
        (const float4*)rows, (const uint32_t*)wide_root, (const int*)root_base,
        (const float4*)tri_pos, (const float*)inst_f, (const int*)inst_u,
        (const int*)tlas_offset, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy, (const float*)dz,
        (const float*)tmin_lane, (const float*)tmax_lane,
        (const uint8_t*)active, (const uint8_t*)anyhit_lane, tmin_all,
        tmax_all, anyhit_all, out, R);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` (f32 per row) selects the layout.  Returns the
// launch's cudaError_t (0 = accepted), or -1 for a width no layout has.
extern "C" int pt_wide_ray_query(
    const void* rows, int width, const void* wide_root, const void* root_base,
    const void* tri_pos, const void* inst_f, const void* inst_u,
    const void* tlas_offset,
    const void* ox, const void* oy, const void* oz,
    const void* dx, const void* dy, const void* dz,
    const void* tmin_lane, const void* tmax_lane, const void* active,
    const void* anyhit_lane, float tmin_all, float tmax_all, int anyhit_all,
    void* thit, void* bu, void* bv, void* out_inst, void* out_prim,
    void* out_back, void* out_occ, int R, void* stream) {
    if (R <= 0) return 0;
    const HitOut out = {(float*)thit, (float*)bu, (float*)bv, (int*)out_inst,
                        (int*)out_prim, (uint8_t*)out_back, (uint8_t*)out_occ};
    cudaStream_t s = (cudaStream_t)stream;
#define PT_WIDE_LAUNCH(S, L, STUB)                                            \
    if (width == Layout<S, L, STUB>::kWidth)                                  \
        return launch<S, L, STUB>(rows, wide_root, root_base, tri_pos,        \
                                  inst_f, inst_u, tlas_offset, ox, oy, oz,    \
                                  dx, dy, dz, tmin_lane, tmax_lane, active,   \
                                  anyhit_lane, tmin_all, tmax_all,            \
                                  anyhit_all, out, R, s);
    PT_WIDE_LAUNCH(8, 4, false)   // w8: 48 columns
    PT_WIDE_LAUNCH(16, 8, false)  // w16: 88 columns
    PT_WIDE_LAUNCH(8, 8, true)    // s8: 40 columns
#undef PT_WIDE_LAUNCH
    return -1;
}

extern "C" int pt_wide_ray_query_block_size(void) { return kBlock; }

// Blocks of the layout's kernel one SM holds at once (negative: the CUDA
// error), or 0 for a width no layout has.
extern "C" int pt_wide_ray_query_occupancy(int width) {
    if (width == Layout<8, 4, false>::kWidth)
        return resident_blocks_per_sm(wide_ray_query_kernel<8, 4, false>, kBlock);
    if (width == Layout<16, 8, false>::kWidth)
        return resident_blocks_per_sm(wide_ray_query_kernel<16, 8, false>, kBlock);
    if (width == Layout<8, 8, true>::kWidth)
        return resident_blocks_per_sm(wide_ray_query_kernel<8, 8, true>, kBlock);
    return 0;
}

// Row width of a layout as this source computes it, for the wrapper's check
// against accel/wide.py (0 = not instantiated).
extern "C" int pt_wide_ray_query_width(int slots, int leaf_tris, int stub) {
    if (slots == 8 && leaf_tris == 4 && !stub) return Layout<8, 4, false>::kWidth;
    if (slots == 16 && leaf_tris == 8 && !stub) return Layout<16, 8, false>::kWidth;
    if (slots == 8 && leaf_tris == 8 && stub) return Layout<8, 8, true>::kWidth;
    return 0;
}
