// The wide mega-table walk as a device function, shared by the wide ray-query
// kernel (wide_ray_query.cu, K1: one ray per thread) and the path kernels
// (path.cuh: the megakernel K2 and the wavefront kernel K5, every ray of a
// path per thread).
//
// It computes the JAX package's ops/wide_traversal.py
// (_wide_step, _leaf_block) at its one-speed setting: per ray a stackless
// walk that reads ONE row of the (M, W) table per step and branches on the
// cursor's kind (bits 30-31):
//   WIDE  S child slots, each a bf16 outward-rounded AABB packed in three
//         words [minx|miny] [minz|maxx] [maxy|maxz]; slab-test all, descend
//         to the first accepted slot >= the cursor's start slot whose link is
//         not 0xFFFFFFFF, else follow the row's exit link.  A descent to a
//         LEAF or INST row stores "this row at slot j+1" (or the exit link
//         after the last slot) as the resume cursor of that kind.
//   LEAF  L triangles inline (or, in the stub layout, L prim ids whose
//         vertices are read from tri_pos): watertight test in row order, each
//         passing candidate shrinks tmax before the next is judged; closest
//         rays keep the winner, any-hit rays stop.  The next link chains to
//         another LEAF row, or RETURN_SENTINEL resumes at leaf_resume.
//   INST  inverse transform + 8 per-octant BLAS entry cursors + instance id:
//         transform the ray, pick the entry by the transformed direction.
//   END_BLAS pops to inst_resume, END_TLAS ends the ray; both resolve before
//   a row is read.
//
// Rows are 16-byte aligned multiples of 16 bytes, read through the read-only
// path as float4.  Links, prim ids and the instance id are bit patterns in
// float columns: loaded as float4 and only ever bit-cast.  fminf/fmaxf give
// the C NaN rule the slab test relies on (an empty slot is (+inf, -inf), and
// 0 * inf occurs).  Built with --fmad=false, IEEE division, no fast-math, no
// flush-to-zero (ops/cuda_build.py).
//
// The counting hooks (NoWalkCount in ray_common.cuh) and, with kCapped, the
// step cap compile away where unused (K1).
//
// This header's bytes are part of the hash of every library that includes it
// (ops/cuda_build.py): an edit here rebuilds K1, K2 and K5.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

namespace ptq {

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

// The TLAS root cursor of a ray: wide_root[tlas_offset - root_base][octant].
__device__ __forceinline__ uint32_t root_cursor(
    const uint32_t* __restrict__ wide_root, const int* __restrict__ root_base,
    int tlas_offset, V3 dir) {
    const int root_row = tlas_offset - (root_base ? __ldg(root_base) : 0);
    return __ldg(wide_root + 8 * (size_t)root_row + octant(dir));
}

// One ray's walk from `cursor` (the TLAS root).  In: tmax = tmax0.  Out: the
// closest hit's tmax, instance and prim (c_inst -1 for none), or `occluded`
// for an any-hit ray.  With kCapped, a ray that would visit more than
// `max_steps` rows stops there and the walk returns false; otherwise it
// returns true.
template <int S, int L, bool STUB, bool kCapped, class Count>
__device__ __forceinline__ bool wide_walk(
    const float4* __restrict__ rows, const float4* __restrict__ tri_pos,
    const int* __restrict__ inst_u, uint32_t cursor, V3 org, V3 dir, V3 t_inv,
    bool any, float tmin, float& tmax, int& c_inst, int& c_prim,
    bool& occluded, int max_steps, Count& count) {
    using Lay = Layout<S, L, STUB>;
    uint32_t inst_resume = kEndTlas, leaf_resume = kEndTlas;
    bool in_blas = false;
    int cand_inst = -1, tri_base = 0, b_axis = 2, steps = 0;
    V3 b_org = {0.f, 0.f, 0.f}, b_inv = {0.f, 0.f, 0.f}, b_S = {0.f, 0.f, 0.f};
    c_inst = -1;
    c_prim = 0;
    occluded = false;

    while (cursor != kEndTlas) {
        if (cursor == kEndBlas) {  // BLAS exhausted: back to the TLAS walk
            cursor = inst_resume;
            in_blas = false;
            continue;
        }
        const uint32_t kind = cursor >> 30;
        if (kind == 3u) break;  // no other sentinel is ever a cursor
        if (kCapped && ++steps > max_steps) return false;
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
            uint32_t hits = 0, linked = 0;
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
                    linked |= (links[4 * g + k] != kInvalid ? 1u : 0u) << (4 * g + k);
                }
            }
            const uint32_t start = cursor & (uint32_t)(S - 1);
            const uint32_t from_start = ~((1u << start) - 1u);
            // slab tests the walk needs: linked slots from the start slot on
            count.node_row(__popc(linked & from_start));
            hits &= from_start;
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
            count.inst_row();
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
            int best_prim = 0, tests = 0;
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
                    ++tests;
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
            count.leaf_row(tests);
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
    return true;
}

}  // namespace ptq
