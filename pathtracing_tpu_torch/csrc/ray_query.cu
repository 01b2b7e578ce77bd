// Ray query on the two-level binary BVH: one thread per ray.
//
// Replaces the TPU kernel of the JAX package's ops/pallas_traversal.py::_kernel
// (launched by ray_query_pallas).  It computes the same function: for each
// ray the one-speed state machine of ops/traversal.py::_full_step, which is
// the walk of binary_walk.cuh (shared with the wavefront kernel,
// wavefront.cu), then _finalize_hit (thit = tmax; u, v, back re-derived from
// the hit ids by one more triangle test; miss -> thit -1, inst -1, prim 0).
//
// What bounds it on an H100: issue and latency, not device memory.  The
// golden scene's tables (1.5 MB) sit in the 50 MB L2; a node visit reads
// one dependent 32 B row and does ~30 flops, a triangle test one 48 B row
// and ~50 flops, and neighbouring rays of a warp leave the loop at different
// times.  What the design does about it:
//   * The Pallas kernel kept the four tables in on-chip memory per block and
//     ended each block's loop on its own.  Here the loop's exit is per thread,
//     the state (~25 words) lives in registers, and the tables are read
//     through the read-only path as 16 B vectors (an nl8 row is 2 x float4,
//     a tri_pos row 3 x float4): tables of a few MB stay resident in the
//     50 MB L2 across the batch, larger ones are served from device memory,
//     so no table size is refused.  inst_f rows are 84 B and only 4 B
//     aligned: scalar loads, once per BLAS entry.
//   * Blocks are small (128 threads) so that a block's slowest ray holds few
//     others' registers; the per-thread `while` needs no batch-wide step
//     count and no lane compaction.
//   * The block size and the TPU kernel's `leaf_every` were schedule knobs
//     whose results are identical by construction; the wrapper takes neither.
//     `vmem_fits` gated a fallback that does not exist here; the wrapper
//     keeps only a helper that reports the tables' bytes.
//   * Tried on the card and taken out again (PERF.md): persistent
//     warps over an active-ray queue in shared memory, and a TLAS loop with
//     an inner BLAS loop; neither was faster on either main-path batch.  Of
//     Hopper's additions none fits: tensor cores have no matrix product to
//     do in a walk, and TMA has no tile to fetch ahead, since each row's
//     address depends on the slab test of the row before it.
//
// The bounded query (ops/traversal.py's max_steps / return_state) is a
// second kernel of the same library, ray_query_bounded_kernel: each lane
// runs binary_walk_bounded below (JAX's step count, at most max_steps
// steps) and writes either its whole walk state, one int32 plane per
// _TravState field (kStateFields x R words, floats and bools as their bits /
// 0 or 1), or the hit finalized from that state.  The unbounded kernel and
// binary_walk.cuh do not change.
//
// The node rows: a library builds one format, PT_NODE_ROWS = 8 (nl8, the
// default) or 5 (the bf16 rows of scene/device.with_bf16_nodes); the row
// read is binary_walk.cuh's policy, and the rest of the kernel is the same.
// The wrapper takes the library of the scene's rows (ops/cuda_traversal.py).
//
// Parity: built with --fmad=false (the oracle goldens were made without FMA
// contraction; contraction in the triangle test flips equal-t ties between
// coincident triangles), IEEE division, no fast-math, no flush-to-zero.  The
// int32 link words live in float columns of nl8 and are only ever bit-cast.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binary_walk.cuh"
#include "ray_common.cuh"

#ifndef PT_NODE_ROWS
#define PT_NODE_ROWS 8  // 8: nl8 rows, 5: nl5 rows
#endif
static_assert(PT_NODE_ROWS == 8 || PT_NODE_ROWS == 5, "PT_NODE_ROWS: 8 or 5");

namespace {

using namespace ptq;

// The node rows this library walks, and their pointer type.
using Rows = std::conditional_t<PT_NODE_ROWS == 5, Nl5Rows, Nl8Rows>;
using RowPtr = decltype(Rows::rows);

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock) ray_query_kernel(
    RowPtr __restrict__ rows,            // nl8 (8N, 8) or nl5 (8N, 5) f32
    const float4* __restrict__ tri_pos,  // (T, 12) f32 as 3 x float4 per row
    const float* __restrict__ inst_f,    // (I, 21) f32
    const int* __restrict__ inst_u,      // (I, 6) i32
    const int* __restrict__ tlas_count, const int* __restrict__ tlas_offset,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax_lane,       // per-lane tmax0, or null
    const uint8_t* __restrict__ active,        // bool per lane
    const uint8_t* __restrict__ anyhit_lane,   // bool per lane, or null
    float tmin, float tmax_all, int anyhit_all,
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
    float tmax = tmax_lane ? tmax_lane[r] : tmax_all;
    int c_inst, c_prim;
    bool occluded;
    NoWalkCount count;
    binary_walk<false>(Rows{rows}, tri_pos, inst_f, inst_u, tlas_count[r], tlas_offset[r], org,
                       dir, safe_inv(dir), any, tmin, tmax, c_inst, c_prim, occluded, 0,
                       count);
    finalize_hit(tri_pos, inst_f, inst_u, org, dir, c_inst, c_prim, tmax,
                 occluded, out, r);
}

// The whole state of a walk: ops/traversal.py's _TravState, whose fields
// the bounded kernel writes in this order.
struct WalkState {
    int t_node = 0;
    bool in_blas = false;
    int b_node = 0, b_count = 0, b_link_off = 0;
    V3 b_org = {0.f, 0.f, 0.f}, b_inv = {0.f, 0.f, 0.f}, b_S = {0.f, 0.f, 0.f};
    int b_axis = 2, tri_offset = 0, cand_inst = -1;
    bool done = false;
    float tmax = 0.f;
    bool occluded = false;
    int c_inst = -1, c_prim = 0;
};
constexpr int kStateFields = 22;

// binary_walk (binary_walk.cuh) from state `s`, bounded: at most max_steps
// steps of _full_step, a step being a node visit, a pop from an exhausted
// BLAS or the end of the exhausted TLAS (JAX's count: binary_walk's cap
// counts node rows only).  A lane that is done takes no step.  The node
// visit is binary_walk's, expression for expression, written out again:
// moving it into a function both walks call took the query kernel from 52
// to 54 registers, so binary_walk is left as it compiles for P1's query
// and the path kernels.
__device__ __forceinline__ void binary_walk_bounded(
    const Rows& nodes, const float4* __restrict__ tri_pos,
    const float* __restrict__ inst_f, const int* __restrict__ inst_u, int t_count,
    int t_offset, V3 org, V3 dir, V3 t_inv, bool any, float tmin, int max_steps,
    WalkState& s) {
    const int t_link_off = t_offset * 8 + octant(dir) * t_count;
    for (int step = 0; step < max_steps && !s.done; ++step) {
        const int count_n = s.in_blas ? s.b_count : t_count;
        const int node = s.in_blas ? s.b_node : s.t_node;
        if (!(node >= 0 && node < count_n)) {
            if (s.in_blas) s.in_blas = false; else s.done = true;
            continue;
        }
        const size_t lidx = (size_t)((s.in_blas ? s.b_link_off : t_link_off) + node);
        const NodeRow n = nodes.read(lidx);
        const V3 o = s.in_blas ? s.b_org : org;
        const V3 inv = s.in_blas ? s.b_inv : t_inv;
        const float t0x = (n.nmin.x - o.x) * inv.x;
        const float t0y = (n.nmin.y - o.y) * inv.y;
        const float t0z = (n.nmin.z - o.z) * inv.z;
        const float t1x = (n.nmax.x - o.x) * inv.x;
        const float t1y = (n.nmax.y - o.y) * inv.y;
        const float t1z = (n.nmax.z - o.z) * inv.z;
        const float tnear = fmaxf(fminf(t0x, t1x),
                                  fmaxf(fminf(t0y, t1y), fminf(t0z, t1z)));
        const float tfar = fminf(fmaxf(t0x, t1x),
                                 fminf(fmaxf(t0y, t1y), fmaxf(t0z, t1z)));
        const bool hit = tnear <= tfar && tfar > tmin && tnear < s.tmax;
        const bool is_leaf = n.accept < 0;
        const int payload = n.accept & 0x7FFFFFFF;
        const int next = (hit && !is_leaf) ? n.accept : n.cancel;
        if (s.in_blas) s.b_node = next; else s.t_node = next;
        if (!(hit && is_leaf)) continue;

        if (!s.in_blas) {
            const int* iu = inst_u + 6 * (size_t)payload;
            V3 bd;
            instance_ray(inst_f + 21 * (size_t)payload, org, dir, s.b_org, bd);
            s.b_count = __ldg(iu + 0);
            s.b_link_off = __ldg(iu + 1) * 8 + octant(bd) * s.b_count;
            s.tri_offset = __ldg(iu + 4);
            s.b_inv = safe_inv(bd);
            tri_preprocess(bd, s.b_axis, s.b_S);
            s.b_node = 0;
            s.cand_inst = payload;
            s.in_blas = true;
        } else {
            V3 p0, p1, p2;
            load_tri(tri_pos, s.tri_offset + payload, p0, p1, p2);
            float u, v, t;
            bool back;
            const bool ok = tri_intersect(s.b_org, s.b_axis, s.b_S, p0, p1, p2, u, v, t, back);
            if (ok && t < s.tmax && t > tmin) {
                if (any) {
                    s.occluded = true;
                    s.done = true;
                } else {
                    s.c_inst = s.cand_inst;
                    s.c_prim = payload;
                    s.tmax = t;
                }
            }
        }
    }
}

__global__ void __launch_bounds__(kBlock) ray_query_bounded_kernel(
    RowPtr __restrict__ rows, const float4* __restrict__ tri_pos,
    const float* __restrict__ inst_f, const int* __restrict__ inst_u,
    const int* __restrict__ tlas_count, const int* __restrict__ tlas_offset,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmax_lane, const uint8_t* __restrict__ active,
    const uint8_t* __restrict__ anyhit_lane, float tmin, float tmax_all, int anyhit_all,
    int max_steps,
    int* __restrict__ state,  // (kStateFields, R) planes, or null: write `out`
    HitOut out, int R) {
    const int r = blockIdx.x * kBlock + threadIdx.x;
    if (r >= R) return;

    const V3 org = {ox[r], oy[r], oz[r]};
    const V3 dir = {dx[r], dy[r], dz[r]};
    const bool any = anyhit_lane ? anyhit_lane[r] != 0 : anyhit_all != 0;
    WalkState s;
    s.tmax = tmax_lane ? tmax_lane[r] : tmax_all;
    s.done = active[r] == 0;
    binary_walk_bounded(Rows{rows}, tri_pos, inst_f, inst_u, tlas_count[r], tlas_offset[r],
                        org, dir, safe_inv(dir), any, tmin, max_steps, s);
    if (state == nullptr) {
        finalize_hit(tri_pos, inst_f, inst_u, org, dir, s.c_inst, s.c_prim, s.tmax,
                     s.occluded, out, r);
        return;
    }
    const int words[kStateFields] = {
        s.t_node, s.in_blas, s.b_node, s.b_count, s.b_link_off,
        __float_as_int(s.b_org.x), __float_as_int(s.b_org.y), __float_as_int(s.b_org.z),
        __float_as_int(s.b_inv.x), __float_as_int(s.b_inv.y), __float_as_int(s.b_inv.z),
        __float_as_int(s.b_S.x), __float_as_int(s.b_S.y), __float_as_int(s.b_S.z),
        s.b_axis, s.tri_offset, s.cand_inst, s.done, __float_as_int(s.tmax), s.occluded,
        s.c_inst, s.c_prim};
#pragma unroll
    for (int f = 0; f < kStateFields; ++f) state[(size_t)f * R + r] = words[f];
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `nodes`: the node table in this library's format
// (pt_ray_query_node_words).  Returns the launch's cudaError_t (0 =
// accepted).
extern "C" int pt_ray_query(
    const void* nodes, const void* tri_pos, const void* inst_f, const void* inst_u,
    const void* tlas_count, const void* tlas_offset,
    const void* ox, const void* oy, const void* oz,
    const void* dx, const void* dy, const void* dz,
    const void* tmax_lane, const void* active, const void* anyhit_lane,
    float tmin, float tmax_all, int anyhit_all,
    void* thit, void* bu, void* bv, void* out_inst, void* out_prim,
    void* out_back, void* out_occ, int R, void* stream) {
    if (R <= 0) return 0;
    const dim3 grid((unsigned)((R + kBlock - 1) / kBlock)), block(kBlock);
    cudaStream_t s = (cudaStream_t)stream;
    ray_query_kernel<<<grid, block, 0, s>>>(
        static_cast<RowPtr>(nodes), (const float4*)tri_pos, (const float*)inst_f,
        (const int*)inst_u, (const int*)tlas_count, (const int*)tlas_offset,
        (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax_lane,
        (const uint8_t*)active, (const uint8_t*)anyhit_lane, tmin, tmax_all,
        anyhit_all,
        HitOut{(float*)thit, (float*)bu, (float*)bv, (int*)out_inst,
               (int*)out_prim, (uint8_t*)out_back, (uint8_t*)out_occ},
        R);
    return (int)cudaGetLastError();
}

// The bounded query: the inputs of pt_ray_query, then the step bound and
// `state` ((pt_ray_query_state_fields(), R) int32 planes, or null: write the
// hit outputs instead, which are ignored otherwise).
extern "C" int pt_ray_query_bounded(
    const void* nodes, const void* tri_pos, const void* inst_f, const void* inst_u,
    const void* tlas_count, const void* tlas_offset,
    const void* ox, const void* oy, const void* oz,
    const void* dx, const void* dy, const void* dz,
    const void* tmax_lane, const void* active, const void* anyhit_lane,
    float tmin, float tmax_all, int anyhit_all, int max_steps, void* state,
    void* thit, void* bu, void* bv, void* out_inst, void* out_prim,
    void* out_back, void* out_occ, int R, void* stream) {
    if (R <= 0) return 0;
    const dim3 grid((unsigned)((R + kBlock - 1) / kBlock)), block(kBlock);
    cudaStream_t s = (cudaStream_t)stream;
    ray_query_bounded_kernel<<<grid, block, 0, s>>>(
        static_cast<RowPtr>(nodes), (const float4*)tri_pos, (const float*)inst_f,
        (const int*)inst_u, (const int*)tlas_count, (const int*)tlas_offset,
        (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax_lane,
        (const uint8_t*)active, (const uint8_t*)anyhit_lane, tmin, tmax_all,
        anyhit_all, max_steps, (int*)state,
        HitOut{(float*)thit, (float*)bu, (float*)bv, (int*)out_inst,
               (int*)out_prim, (uint8_t*)out_back, (uint8_t*)out_occ},
        R);
    return (int)cudaGetLastError();
}

extern "C" int pt_ray_query_state_fields(void) { return kStateFields; }

extern "C" int pt_ray_query_block_size(void) { return kBlock; }

// f32 words of a node row in this library's format: 8 (nl8) or 5 (nl5).
extern "C" int pt_ray_query_node_words(void) { return PT_NODE_ROWS; }

// Blocks of the kernel one SM holds at once (negative: the CUDA error).
extern "C" int pt_ray_query_occupancy(void) {
    return resident_blocks_per_sm(ray_query_kernel, kBlock);
}
