// Device functions shared by the walks (binary_walk.cuh: the binary
// two-level walk; wide_walk.cuh: the wide mega-table walk) and every kernel
// that runs one: reciprocal direction, octant, the watertight triangle test,
// the instance transform, the finalize step's triangle test, the result
// record the ray-query kernels write, and the walks' empty counting hooks.
//
// The kernels must agree bit for bit with their plain PyTorch versions and
// with each other, so every expression here keeps the evaluation order of
// ops/traversal.py and the sources are built with --fmad=false.
//
// This header's bytes are part of every library's hash that includes it
// (ops/cuda_build.py): an edit here rebuilds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptq {

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 safe_inv(V3 d) {
    const float big = __int_as_float(0x7f800000);  // +inf
    V3 r;
    r.x = d.x == 0.0f ? big : 1.0f / d.x;
    r.y = d.y == 0.0f ? big : 1.0f / d.y;
    r.z = d.z == 0.0f ? big : 1.0f / d.z;
    return r;
}

__device__ __forceinline__ int octant(V3 d) {
    return (d.x > 0.0f ? 1 : 0) + (d.y > 0.0f ? 2 : 0) + (d.z > 0.0f ? 4 : 0);
}

// Woop max-axis permutation + shear constants (reference: math.hh:340-356).
__device__ __forceinline__ void tri_preprocess(V3 d, int& axis, V3& S) {
    const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
    const bool is0 = ax > ay && ax > az;
    const bool is1 = !is0 && ay > az;
    axis = is0 ? 0 : (is1 ? 1 : 2);
    const float rx = is0 ? d.z : d.x;
    const float ry = is1 ? d.z : d.y;
    const float rz = is0 ? d.x : (is1 ? d.y : d.z);
    const float inv_z = 1.0f / rz;
    S.x = rx * inv_z;
    S.y = ry * inv_z;
    S.z = 1.0f * inv_z;
}

// Watertight ray-triangle test (reference: math.hh:358-401).
__device__ __forceinline__ bool tri_intersect(
    V3 o, int axis, V3 S, V3 p0, V3 p1, V3 p2,
    float& u, float& v, float& t, bool& back) {
    const V3 A = {p0.x - o.x, p0.y - o.y, p0.z - o.z};
    const V3 B = {p1.x - o.x, p1.y - o.y, p1.z - o.z};
    const V3 C = {p2.x - o.x, p2.y - o.y, p2.z - o.z};
    const V3 x = {A.x, B.x, C.x};
    const V3 y = {A.y, B.y, C.y};
    const V3 z = {A.z, B.z, C.z};
    const bool is0 = axis == 0, is1 = axis == 1;
    const V3 x2 = is0 ? z : x;
    const V3 y2 = is1 ? z : y;
    const V3 z2 = is0 ? x : (is1 ? y : z);
    const V3 x3 = {x2.x - S.x * z2.x, x2.y - S.x * z2.y, x2.z - S.x * z2.z};
    const V3 y3 = {y2.x - S.y * z2.x, y2.y - S.y * z2.y, y2.z - S.y * z2.z};
    // uvw = cross(y3, x3)
    const float wx = y3.y * x3.z - y3.z * x3.y;
    const float wy = y3.z * x3.x - y3.x * x3.z;
    const float wz = y3.x * x3.y - y3.y * x3.x;
    const float det = wx + wy + wz;
    const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    u = wx * inv_det;
    v = wy * inv_det;
    t = (wx * (S.z * z2.x) + wy * (S.z * z2.y) + wz * (S.z * z2.z)) * inv_det;
    back = ((det < 0.0f) != (S.z < 0.0f)) != (axis != 2);
    const bool all_pos = wx >= 0.0f && wy >= 0.0f && wz >= 0.0f;
    const bool all_neg = wx <= 0.0f && wy <= 0.0f && wz <= 0.0f;
    return det != 0.0f && t >= 0.0f && (all_pos || all_neg);
}

// Ray into instance space by the inverse transform's columns
// (reference: ray_query.hh:159-165).  f = the 12 floats of the transform.
__device__ __forceinline__ void instance_ray12(
    const float (&f)[12], V3 o, V3 d, V3& bo, V3& bd) {
    bo.x = f[0] * o.x + f[3] * o.y + f[6] * o.z + f[9];
    bo.y = f[1] * o.x + f[4] * o.y + f[7] * o.z + f[10];
    bo.z = f[2] * o.x + f[5] * o.y + f[8] * o.z + f[11];
    bd.x = f[0] * d.x + f[3] * d.y + f[6] * d.z;
    bd.y = f[1] * d.x + f[4] * d.y + f[7] * d.z;
    bd.z = f[2] * d.x + f[5] * d.y + f[8] * d.z;
}

// The same from an inst_f row (21 floats, 4-byte aligned: scalar loads).
__device__ __forceinline__ void instance_ray(
    const float* __restrict__ f, V3 o, V3 d, V3& bo, V3& bd) {
    float c[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) c[i] = __ldg(f + i);
    instance_ray12(c, o, d, bo, bd);
}

__device__ __forceinline__ void load_tri(
    const float4* __restrict__ tri_pos, int row, V3& p0, V3& p1, V3& p2) {
    const float4 a = __ldg(tri_pos + 3 * (size_t)row);
    const float4 b = __ldg(tri_pos + 3 * (size_t)row + 1);
    const float4 c = __ldg(tri_pos + 3 * (size_t)row + 2);
    p0 = {a.x, a.y, a.z};
    p1 = {a.w, b.x, b.y};
    p2 = {b.z, b.w, c.x};
}

// The seven per-lane outputs of a ray query.
struct HitOut {
    float* thit;
    float* bu;
    float* bv;
    int* inst;
    int* prim;
    uint8_t* back;
    uint8_t* occ;
};

// What an inactive lane gets: a miss.
__device__ __forceinline__ void write_miss(const HitOut& out, int r) {
    out.thit[r] = -1.0f;
    out.bu[r] = 0.f;
    out.bv[r] = 0.f;
    out.inst[r] = -1;
    out.prim[r] = 0;
    out.back[r] = 0;
    out.occ[r] = 0;
}

// The finalize step's triangle test (_finalize_hit of ops/traversal.py):
// (u, v, t, back) of a hit re-derived from its ids, by one triangle test on
// the ray in the instance's space.  The scan's shade_hit re-derives (u, v,
// t) by the same test and takes `back` from the finalize step, so the
// unpacked shading fetch (shading.cuh) calls this too.
__device__ __forceinline__ void hit_surface(
    const float4* __restrict__ tri_pos, const float* __restrict__ inst_f,
    const int* __restrict__ inst_u, V3 org, V3 dir, int c_inst, int c_prim,
    float& u, float& v, float& t, bool& back) {
    V3 bo, bd, S, p0, p1, p2;
    int axis;
    instance_ray(inst_f + 21 * (size_t)c_inst, org, dir, bo, bd);
    tri_preprocess(bd, axis, S);
    load_tri(tri_pos, __ldg(inst_u + 6 * (size_t)c_inst + 4) + c_prim, p0, p1, p2);
    tri_intersect(bo, axis, S, p0, p1, p2, u, v, t, back);
}

// _finalize_hit of ops/traversal.py: thit = tmax; (u, v, back) once more from
// the hit ids by one triangle test; miss -> thit -1, inst -1, prim 0.
__device__ __forceinline__ void finalize_hit(
    const float4* __restrict__ tri_pos, const float* __restrict__ inst_f,
    const int* __restrict__ inst_u, V3 org, V3 dir, int c_inst, int c_prim,
    float tmax, bool occluded, const HitOut& out, int r) {
    const bool hitm = c_inst >= 0;
    float u = 0.f, v = 0.f;
    bool back = false;
    if (hitm) {
        float t;
        hit_surface(tri_pos, inst_f, inst_u, org, dir, c_inst, c_prim, u, v, t, back);
    }
    out.thit[r] = hitm ? tmax : -1.0f;
    out.bu[r] = u;
    out.bv[r] = v;
    out.inst[r] = c_inst;
    out.prim[r] = hitm ? c_prim : 0;
    out.back[r] = back ? 1 : 0;
    out.occ[r] = occluded ? 1 : 0;
}

// What a walk counts: nothing (the ray-query kernels, the path kernels'
// timed builds), or its row visits and tests (the path kernels' counting
// builds, for the bound chip_smoke.py reports).  A node row is a binary
// node or a WIDE row (with the slab tests it needed), a leaf row a LEAF row
// or one binary triangle test (with the triangle tests it made), an inst row
// a BLAS entry.  The empty hooks compile away.
struct NoWalkCount {
    __device__ __forceinline__ void node_row(int) {}
    __device__ __forceinline__ void leaf_row(int) {}
    __device__ __forceinline__ void inst_row() {}
};

// Blocks of `kernel` one SM holds at once (negative: minus the CUDA error);
// the kernels export it for the report of resident warps.
template <class Kernel>
inline int resident_blocks_per_sm(Kernel kernel, int block) {
    int blocks = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, 0);
    return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace ptq
