// Ray query on the two-level binary BVH: one thread per ray.
//
// Replaces the TPU kernel pathtracing_tpu/ops/pallas_traversal.py::_kernel
// (launched by ray_query_pallas).  It computes the same function: for each
// ray the one-speed state machine of ops/traversal.py::_full_step (range
// check / BLAS pop, nl8 row read at link_off + node, slab test, accept/cancel
// link follow, TLAS leaf -> BLAS entry through the instance's inverse
// transform, BLAS leaf -> watertight triangle test, confirm tmin < t < tmax;
// closest lanes shrink tmax and keep the ids, any-hit lanes set `occluded`
// and stop), then _finalize_hit (thit = tmax; u, v, back re-derived from the
// hit ids by one more triangle test; miss -> thit -1, inst -1, prim 0).
//
// What bounds it on an H100: bytes and latency, not arithmetic.  A node visit
// reads one scattered 32 B row and does ~30 flops, a triangle test one 48 B
// row and ~50 flops, and neighbouring rays of a warp leave the loop at
// different times.  What the design does about it:
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
//
// Parity: built with --fmad=false (the oracle goldens were made without FMA
// contraction; contraction in the triangle test flips equal-t ties between
// coincident triangles), IEEE division, no fast-math, no flush-to-zero.  The
// int32 link words live in float columns of nl8 and are only ever bit-cast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// (reference: ray_query.hh:159-165).  f = inst_f row, 21 floats.
__device__ __forceinline__ void instance_ray(
    const float* __restrict__ f, V3 o, V3 d, V3& bo, V3& bd) {
    const float f0 = __ldg(f + 0), f1 = __ldg(f + 1), f2 = __ldg(f + 2);
    const float f3 = __ldg(f + 3), f4 = __ldg(f + 4), f5 = __ldg(f + 5);
    const float f6 = __ldg(f + 6), f7 = __ldg(f + 7), f8 = __ldg(f + 8);
    const float f9 = __ldg(f + 9), f10 = __ldg(f + 10), f11 = __ldg(f + 11);
    bo.x = f0 * o.x + f3 * o.y + f6 * o.z + f9;
    bo.y = f1 * o.x + f4 * o.y + f7 * o.z + f10;
    bo.z = f2 * o.x + f5 * o.y + f8 * o.z + f11;
    bd.x = f0 * d.x + f3 * d.y + f6 * d.z;
    bd.y = f1 * d.x + f4 * d.y + f7 * d.z;
    bd.z = f2 * d.x + f5 * d.y + f8 * d.z;
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

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock) ray_query_kernel(
    const float4* __restrict__ nl8,      // (8N, 8) f32 as 2 x float4 per row
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
    float* __restrict__ thit, float* __restrict__ bu, float* __restrict__ bv,
    int* __restrict__ out_inst, int* __restrict__ out_prim,
    uint8_t* __restrict__ out_back, uint8_t* __restrict__ out_occ,
    int R) {
    const int r = blockIdx.x * kBlock + threadIdx.x;
    if (r >= R) return;

    // An inactive lane reads its `active` byte and nothing else, and writes
    // a miss: the batches of a bounce hold many such lanes.
    if (active[r] == 0) {
        thit[r] = -1.0f;
        bu[r] = 0.f;
        bv[r] = 0.f;
        out_inst[r] = -1;
        out_prim[r] = 0;
        out_back[r] = 0;
        out_occ[r] = 0;
        return;
    }

    const V3 org = {ox[r], oy[r], oz[r]};
    const V3 dir = {dx[r], dy[r], dz[r]};
    const int t_count = tlas_count[r];
    const int t_link_off = tlas_offset[r] * 8 + octant(dir) * t_count;
    const V3 t_inv = safe_inv(dir);
    const bool any = anyhit_lane ? anyhit_lane[r] != 0 : anyhit_all != 0;

    float tmax = tmax_lane ? tmax_lane[r] : tmax_all;
    bool done = false;
    bool occluded = false;
    int c_inst = -1, c_prim = 0;

    // TLAS cursor, and the BLAS context of the instance being walked
    int t_node = 0;
    bool in_blas = false;
    int b_node = 0, b_count = 0, b_link_off = 0, b_axis = 2;
    int tri_offset = 0, cand_inst = -1;
    V3 b_org = {0.f, 0.f, 0.f}, b_inv = {0.f, 0.f, 0.f}, b_S = {0.f, 0.f, 0.f};

    while (!done) {
        const int count = in_blas ? b_count : t_count;
        const int node = in_blas ? b_node : t_node;
        if (!(node >= 0 && node < count)) {
            // BLAS exhausted => pop to the TLAS; TLAS exhausted => done
            // (reference: ray_query.hh:271-275)
            if (!in_blas) break;
            in_blas = false;
            continue;
        }
        const size_t lidx = (size_t)((in_blas ? b_link_off : t_link_off) + node);
        const float4 n0 = __ldg(nl8 + 2 * lidx);
        const float4 n1 = __ldg(nl8 + 2 * lidx + 1);
        const int accept = __float_as_int(n1.z);
        const int cancel = __float_as_int(n1.w);

        const V3 o = in_blas ? b_org : org;
        const V3 inv = in_blas ? b_inv : t_inv;
        // slab test with C fmin/fmax NaN semantics (reference:
        // ray_query.hh:197-207); nmin = n0.xyz, nmax = (n0.w, n1.x, n1.y)
        const float t0x = (n0.x - o.x) * inv.x;
        const float t0y = (n0.y - o.y) * inv.y;
        const float t0z = (n0.z - o.z) * inv.z;
        const float t1x = (n0.w - o.x) * inv.x;
        const float t1y = (n1.x - o.y) * inv.y;
        const float t1z = (n1.y - o.z) * inv.z;
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

    // ---- _finalize_hit: (u, v, back) once more from the hit ids ----
    const bool hitm = c_inst >= 0;
    float u = 0.f, v = 0.f;
    bool back = false;
    if (hitm) {
        V3 bo, bd, S, p0, p1, p2;
        int axis;
        float t;
        instance_ray(inst_f + 21 * (size_t)c_inst, org, dir, bo, bd);
        tri_preprocess(bd, axis, S);
        load_tri(tri_pos, __ldg(inst_u + 6 * (size_t)c_inst + 4) + c_prim, p0, p1, p2);
        tri_intersect(bo, axis, S, p0, p1, p2, u, v, t, back);
    }
    thit[r] = hitm ? tmax : -1.0f;
    bu[r] = u;
    bv[r] = v;
    out_inst[r] = c_inst;
    out_prim[r] = hitm ? c_prim : 0;
    out_back[r] = back ? 1 : 0;
    out_occ[r] = occluded ? 1 : 0;
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  Returns the launch's cudaError_t (0 = accepted).
extern "C" int pt_ray_query(
    const void* nl8, const void* tri_pos, const void* inst_f, const void* inst_u,
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
        (const float4*)nl8, (const float4*)tri_pos, (const float*)inst_f,
        (const int*)inst_u, (const int*)tlas_count, (const int*)tlas_offset,
        (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float*)tmax_lane,
        (const uint8_t*)active, (const uint8_t*)anyhit_lane, tmin, tmax_all,
        anyhit_all, (float*)thit, (float*)bu, (float*)bv, (int*)out_inst,
        (int*)out_prim, (uint8_t*)out_back, (uint8_t*)out_occ, R);
    return (int)cudaGetLastError();
}

extern "C" int pt_ray_query_block_size(void) { return kBlock; }
