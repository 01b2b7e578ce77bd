// Ray query on the wide-BVH mega-table: one thread per ray.
//
// Replaces the JAX package's XLA while-loop walk
// pathtracing_tpu/ops/wide_traversal.py::wide_ray_query (_wide_init,
// _wide_step, _leaf_block, _wide_drain), at its one-speed setting
// (leaf_every=None, no compaction).  It computes the same function: per ray a
// stackless walk that reads ONE row of the (M, W) table per step and branches
// on the cursor's kind (bits 30-31):
//   WIDE  S child slots, each a bf16 outward-rounded AABB packed in three
//         words [minx|miny] [minz|maxx] [maxy|maxz]; slab-test all, descend
//         to the first accepted slot >= the cursor's start slot whose link is
//         not 0xFFFFFFFF, else follow the row's exit link.  A descent to a
//         LEAF or INST row stores "this row at slot j+1" (or the exit link
//         after the last slot) as the resume cursor of that kind.
//   LEAF  L triangles inline (or, in the stub layout, L prim ids whose
//         vertices are read from tri_pos): watertight test in row order, each
//         passing candidate shrinks tmax before the next is judged; closest
//         lanes keep the winner, any-hit lanes stop.  The next link chains to
//         another LEAF row, or RETURN_SENTINEL resumes at leaf_resume.
//   INST  inverse transform + 8 per-octant BLAS entry cursors + instance id:
//         transform the ray, pick the entry by the transformed direction.
//   END_BLAS pops to inst_resume, END_TLAS ends the ray; both resolve before
//   a row is read.
// then _finalize_hit as in ray_query.cu.
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
// flush-to-zero (ops/cuda_build.py).  Links, prim ids and the instance id are
// bit patterns in float columns: they are loaded as float4 and only ever
// bit-cast.  fminf/fmaxf give the C NaN rule the slab test relies on (an
// empty slot is (+inf, -inf), and 0 * inf occurs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

namespace {

using namespace ptq;

constexpr int kBlock = 128;

constexpr uint32_t kEndTlas = (3u << 30) | 0u;
constexpr uint32_t kEndBlas = (3u << 30) | 1u;
constexpr uint32_t kReturn = (3u << 30) | 2u;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int bit_length(int v) { return v == 0 ? 0 : 1 + bit_length(v >> 1); }

// Row geometry: the constants of accel/wide.py::WideLayout.
template <int S, int L, bool STUB>
struct Layout {
    static constexpr int kSlotBits = cmax(3, bit_length(S - 1));
    static constexpr uint32_t kRowMask = (1u << (30 - kSlotBits)) - 1u;
    static constexpr int kLeafNeed = STUB ? L + 2 : 10 * L + 1;
    static constexpr int kNeed = cmax(cmax(4 * S + 1, kLeafNeed), 21);
    static constexpr int kWidth = (kNeed + 1 + 7) / 8 * 8;  // f32 per row
    static constexpr int kVec = kWidth / 4;                 // float4 per row
    static constexpr int kLinksCol = 3 * S;
    static constexpr int kExitCol = 4 * S;
    static constexpr int kPrimsCol = STUB ? 0 : 9 * L;
    static constexpr int kNextCol = STUB ? L : 10 * L;
};

__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}

// Words [4*first, 4*first + 4*N) of a row into registers.
template <int N>
__device__ __forceinline__ void load_words(
    const float4* __restrict__ row, int first, uint32_t (&w)[4 * N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float4 v = __ldg(row + first + i);
        w[4 * i + 0] = __float_as_uint(v.x);
        w[4 * i + 1] = __float_as_uint(v.y);
        w[4 * i + 2] = __float_as_uint(v.z);
        w[4 * i + 3] = __float_as_uint(v.w);
    }
}

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
    using Lay = Layout<S, L, STUB>;
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
    const V3 t_inv = safe_inv(dir);
    const bool any = anyhit_lane ? anyhit_lane[r] != 0 : anyhit_all != 0;
    const float tmin = tmin_lane ? tmin_lane[r] : tmin_all;
    float tmax = tmax_lane ? tmax_lane[r] : tmax_all;

    const int root_row = tlas_offset[r] - (root_base ? __ldg(root_base) : 0);
    uint32_t cursor = __ldg(wide_root + 8 * (size_t)root_row + octant(dir));
    uint32_t inst_resume = kEndTlas, leaf_resume = kEndTlas;
    bool in_blas = false, occluded = false;
    int c_inst = -1, c_prim = 0, cand_inst = -1, tri_base = 0, b_axis = 2;
    V3 b_org = {0.f, 0.f, 0.f}, b_inv = {0.f, 0.f, 0.f}, b_S = {0.f, 0.f, 0.f};

    while (cursor != kEndTlas) {
        if (cursor == kEndBlas) {  // BLAS exhausted: back to the TLAS walk
            cursor = inst_resume;
            in_blas = false;
            continue;
        }
        const uint32_t kind = cursor >> 30;
        if (kind == 3u) break;  // no other sentinel is ever a cursor
        const uint32_t row_id = (cursor >> Lay::kSlotBits) & Lay::kRowMask;
        const float4* __restrict__ row = rows + (size_t)row_id * Lay::kVec;
        const uint32_t* __restrict__ roww = (const uint32_t*)row;

        if (kind == 0u) {
            // =============== WIDE: S-slot slab test ======================
            const V3 o = in_blas ? b_org : org;
            const V3 inv = in_blas ? b_inv : t_inv;
            const uint32_t exit_link = __ldg(roww + Lay::kExitCol);
            uint32_t links[S];
            load_words<S / 4>(row, Lay::kLinksCol / 4, links);
            uint32_t hits = 0;
            // four slots are twelve words: three float4 loads
#pragma unroll
            for (int g = 0; g < S / 4; ++g) {
                uint32_t w[12];
                load_words<3>(row, 3 * g, w);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const uint32_t c0 = w[3 * k], c1 = w[3 * k + 1], c2 = w[3 * k + 2];
                    const float t0x = (bf16_hi(c0) - o.x) * inv.x;
                    const float t0y = (bf16_lo(c0) - o.y) * inv.y;
                    const float t0z = (bf16_hi(c1) - o.z) * inv.z;
                    const float t1x = (bf16_lo(c1) - o.x) * inv.x;
                    const float t1y = (bf16_hi(c2) - o.y) * inv.y;
                    const float t1z = (bf16_lo(c2) - o.z) * inv.z;
                    const float tnear = fmaxf(
                        fminf(t0x, t1x), fmaxf(fminf(t0y, t1y), fminf(t0z, t1z)));
                    const float tfar = fminf(
                        fmaxf(t0x, t1x), fminf(fmaxf(t0y, t1y), fmaxf(t0z, t1z)));
                    const bool ok = tnear <= tfar && tfar > tmin && tnear < tmax &&
                                    links[4 * g + k] != kInvalid;
                    hits |= (ok ? 1u : 0u) << (4 * g + k);
                }
            }
            const uint32_t start = cursor & (uint32_t)(S - 1);
            hits &= ~((1u << start) - 1u);
            if (hits == 0u) {
                cursor = exit_link;
                continue;
            }
            const int j = __ffs((int)hits) - 1;
            uint32_t target = links[0];
#pragma unroll
            for (int k = 1; k < S; ++k) target = (k == j) ? links[k] : target;
            // where the walk goes on after a LEAF chain or an instance:
            // this row at slot j+1, or the row's exit after the last slot
            const uint32_t resume =
                j < S - 1 ? (cursor & ~(uint32_t)(S - 1)) + (uint32_t)(j + 1)
                          : exit_link;
            const uint32_t tkind = target >> 30;
            if (tkind == 2u) inst_resume = resume;
            else if (tkind == 1u) leaf_resume = resume;
            cursor = target;
        } else if (kind == 2u) {
            // =============== INST: enter BLAS ============================
            // (reference: ray_query.hh:153-182)
            uint32_t w[12];
            load_words<3>(row, 0, w);
            float f[12];
#pragma unroll
            for (int i = 0; i < 12; ++i) f[i] = __uint_as_float(w[i]);
            V3 bd;
            instance_ray12(f, org, dir, b_org, bd);
            b_inv = safe_inv(bd);
            tri_preprocess(bd, b_axis, b_S);
            cursor = __ldg(roww + 12 + octant(bd));
            cand_inst = (int)__ldg(roww + 20);
            if (STUB) tri_base = __ldg(inst_u + 6 * (size_t)cand_inst + 4);
            in_blas = true;
        } else {
            // =============== LEAF: L exact triangle tests ================
            // (reference: ray_query.hh:225-246, 280-290)
            const uint32_t nxt = __ldg(roww + Lay::kNextCol);
            uint32_t prims[L];
            load_words<L / 4>(row, Lay::kPrimsCol / 4, prims);
            float best_t = __int_as_float(0x7f800000);  // +inf
            float new_tmax = tmax;
            int best_prim = 0;
            bool any_ok = false;
            // four inline triangles are 36 words: nine float4 loads
#pragma unroll
            for (int g = 0; g < L / 4; ++g) {
                uint32_t w[36];
                if (!STUB) load_words<9>(row, 9 * g, w);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int pk = (int)prims[4 * g + k];
                    if (pk < 0) continue;  // an empty candidate never passes
                    V3 p0, p1, p2;
                    if (STUB) {
                        load_tri(tri_pos, tri_base + pk, p0, p1, p2);
                    } else {
                        const uint32_t* v = w + 9 * k;
                        p0 = {__uint_as_float(v[0]), __uint_as_float(v[1]),
                              __uint_as_float(v[2])};
                        p1 = {__uint_as_float(v[3]), __uint_as_float(v[4]),
                              __uint_as_float(v[5])};
                        p2 = {__uint_as_float(v[6]), __uint_as_float(v[7]),
                              __uint_as_float(v[8])};
                    }
                    float u, v2, tt;
                    bool back;
                    const bool ok =
                        tri_intersect(b_org, b_axis, b_S, p0, p1, p2, u, v2, tt, back) &&
                        tt < new_tmax && tt > tmin;
                    if (ok) {
                        if (tt < best_t) {
                            best_t = tt;
                            best_prim = pk;
                        }
                        new_tmax = tt;
                        any_ok = true;
                    }
                }
            }
            if (any_ok) {
                if (any) {
                    // first passing candidate ends an any-hit ray
                    // (reference: path_tracer.hh:415-427)
                    occluded = true;
                    break;
                }
                tmax = new_tmax;
                c_inst = cand_inst;
                c_prim = best_prim;
            }
            cursor = nxt == kReturn ? leaf_resume : nxt;
        }
    }

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
