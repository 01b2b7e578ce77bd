// The binary two-level BVH walk as a device function, shared by the
// ray-query kernel (ray_query.cu, P1: one ray per thread) and the wavefront
// kernel (wavefront.cu, K5: every ray of a path per thread).
//
// It computes the one-speed state machine of ops/traversal.py::_full_step
// (the JAX package's pallas_traversal.py::_kernel): range check / BLAS pop,
// nl8 row read at link_off + node, slab test, accept/cancel link follow,
// TLAS leaf -> BLAS entry through the instance's inverse transform, BLAS leaf
// -> watertight triangle test, confirm tmin < t < tmax; closest rays shrink
// tmax and keep the ids, any-hit rays set `occluded` and stop.
//
// The node rows are a compile-time policy (the JAX walk's _read_node):
//   Nl8Rows  the f32 rows, 32 B: 2 x float4 (nmin = n0.xyz, nmax = (n0.w,
//            n1.x, n1.y), accept = n1.z, cancel = n1.w);
//   Nl5Rows  the bf16 rows of scene/device.pack_nl5, 20 B and only 4 B
//            aligned: five 4-byte loads; words 0-2 hold the box as bf16
//            halves rounded outward ([min.x|min.y, min.z|max.x,
//            max.y|max.z], a half being the high 16 bits of an f32, so the
//            high one unpacks by a mask and the low one by a shift), words
//            3-4 the links.  The larger boxes let the walk visit more nodes;
//            every candidate still meets the exact triangle test and the
//            strict t bounds, so closest hits are the same bits.
// The int32 link words live in float columns and are only ever bit-cast.
// fminf/fmaxf give the C NaN rule of the slab test (reference:
// ray_query.hh:197-207).  Built with --fmad=false, IEEE division, no
// fast-math, no flush-to-zero (ops/cuda_build.py).
//
// Hooks, both empty at compile time where unused (P1): with kCapped a ray
// that would read more than `max_steps` node rows stops there and the walk
// returns false; `count` is told of each node row (one slab test), BLAS
// entry and triangle test (ray_common.cuh, NoWalkCount).
//
// This header's bytes are part of the hash of every library that includes it
// (ops/cuda_build.py): an edit here rebuilds P1 and K5 (both node-row
// formats) and K2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_common.cuh"

namespace ptq {

// One node row as the walk reads it.
struct NodeRow {
    V3 nmin, nmax;
    int accept, cancel;
};

struct Nl8Rows {
    const float4* rows;  // (8N, 8) f32 as 2 x float4 per row
    __device__ __forceinline__ NodeRow read(size_t lidx) const {
        const float4 n0 = __ldg(rows + 2 * lidx);
        const float4 n1 = __ldg(rows + 2 * lidx + 1);
        return {{n0.x, n0.y, n0.z}, {n0.w, n1.x, n1.y}, __float_as_int(n1.z),
                __float_as_int(n1.w)};
    }
};

struct Nl5Rows {
    const unsigned* rows;  // (8N, 5) f32 words, read as their bits
    __device__ __forceinline__ NodeRow read(size_t lidx) const {
        const unsigned* r = rows + 5 * lidx;
        const unsigned w0 = __ldg(r), w1 = __ldg(r + 1), w2 = __ldg(r + 2);
        const int accept = (int)__ldg(r + 3), cancel = (int)__ldg(r + 4);
        const unsigned hi = 0xFFFF0000u;
        return {{__uint_as_float(w0 & hi), __uint_as_float(w0 << 16), __uint_as_float(w1 & hi)},
                {__uint_as_float(w1 << 16), __uint_as_float(w2 & hi), __uint_as_float(w2 << 16)},
                accept, cancel};
    }
};

// One ray's walk of the TLAS (t_count nodes at t_offset) and the BLASes it
// enters.  In: tmax = tmax0.  Out: the closest hit's tmax, instance and prim
// (c_inst -1 for none), or `occluded` for an any-hit ray.  Returns false only
// when kCapped and the ray hit the cap.
template <bool kCapped, class Rows, class Count>
__device__ __forceinline__ bool binary_walk(
    const Rows& nodes, const float4* __restrict__ tri_pos,
    const float* __restrict__ inst_f, const int* __restrict__ inst_u, int t_count,
    int t_offset, V3 org, V3 dir, V3 t_inv, bool any, float tmin, float& tmax,
    int& c_inst, int& c_prim, bool& occluded, int max_steps, Count& count) {
    const int t_link_off = t_offset * 8 + octant(dir) * t_count;
    bool done = false;
    int steps = 0;
    occluded = false;
    c_inst = -1;
    c_prim = 0;

    // TLAS cursor, and the BLAS context of the instance being walked
    int t_node = 0;
    bool in_blas = false;
    int b_node = 0, b_count = 0, b_link_off = 0, b_axis = 2;
    int tri_offset = 0, cand_inst = -1;
    V3 b_org = {0.f, 0.f, 0.f}, b_inv = {0.f, 0.f, 0.f}, b_S = {0.f, 0.f, 0.f};

    while (!done) {
        const int count_n = in_blas ? b_count : t_count;
        const int node = in_blas ? b_node : t_node;
        if (!(node >= 0 && node < count_n)) {
            // BLAS exhausted => pop to the TLAS; TLAS exhausted => done
            // (reference: ray_query.hh:271-275)
            if (!in_blas) break;
            in_blas = false;
            continue;
        }
        if (kCapped && ++steps > max_steps) return false;
        count.node_row(1);
        const size_t lidx = (size_t)((in_blas ? b_link_off : t_link_off) + node);
        const NodeRow n = nodes.read(lidx);
        const int accept = n.accept;
        const int cancel = n.cancel;

        const V3 o = in_blas ? b_org : org;
        const V3 inv = in_blas ? b_inv : t_inv;
        // slab test with C fmin/fmax NaN semantics (reference:
        // ray_query.hh:197-207)
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
        const bool hit = tnear <= tfar && tfar > tmin && tnear < tmax;
        const bool is_leaf = accept < 0;  // top bit (reference: bvh.hh:57-63)
        const int payload = accept & 0x7FFFFFFF;
        const int next = (hit && !is_leaf) ? accept : cancel;
        if (in_blas) b_node = next; else t_node = next;
        if (!(hit && is_leaf)) continue;

        if (!in_blas) {
            // ---- enter BLAS (reference: ray_query.hh:153-182) ----
            count.inst_row();
            const int* iu = inst_u + 6 * (size_t)payload;
            V3 bd;
            instance_ray(inst_f + 21 * (size_t)payload, org, dir, b_org, bd);
            b_count = __ldg(iu + 0);
            b_link_off = __ldg(iu + 1) * 8 + octant(bd) * b_count;
            tri_offset = __ldg(iu + 4);
            b_inv = safe_inv(bd);
            tri_preprocess(bd, b_axis, b_S);
            b_node = 0;
            cand_inst = payload;
            in_blas = true;
        } else {
            // ---- triangle test (reference: ray_query.hh:225-246) ----
            count.leaf_row(1);
            V3 p0, p1, p2;
            load_tri(tri_pos, tri_offset + payload, p0, p1, p2);
            float u, v, t;
            bool back;
            const bool ok = tri_intersect(b_org, b_axis, b_S, p0, p1, p2, u, v, t, back);
            if (ok && t < tmax && t > tmin) {
                if (any) {
                    // first passing candidate ends an any-hit ray
                    // (reference: path_tracer.hh:415-427)
                    occluded = true;
                    done = true;
                } else {
                    // closest-hit confirms every candidate
                    // (reference: ray_query.hh:280-290)
                    c_inst = cand_inst;
                    c_prim = payload;
                    tmax = t;
                }
            }
        }
    }
    return true;
}

}  // namespace ptq
