// The transposes of the integrator's two custom-VJP gathers (K7), the
// backward kernels of ops/integrator.SmallTableGather and VattrGather3.
//
// K7a replaces pathtracing_tpu/ops/integrator.py::small_table_gather's
// transpose (_stg_bwd :74-83, onehot(idx)^T @ g on the TPU's matrix unit):
//   out[s, c] = sum of g[r, c] over the rows r with idx[r] == s,
// for the per-subframe tables sf_cam (S, 18) and sf_light (S, 7).  Every lane
// of a frame lands on one of a few rows: contention is total, so no atomics.
// Design: a fixed number of blocks (set by R alone), each summing a
// contiguous stretch of rows in row order into its (S, C) partial: the
// stretch is staged tile by tile into shared memory, and thread t holds the
// sums of output elements t, t + blockDim, ... in registers, adding a row's
// value where the row's index is its element's row.  A second launch adds
// the partials in block order.  Output groups beyond what the threads hold
// re-read the stretch.  Deterministic: the order of every sum is fixed.
//
// K7b replaces pathtracing_tpu/ops/integrator.py::_vattr_gather3's transpose
// (_vg3_bwd :141-146, one scatter-add of 3R rows of 12 floats):
//   out[v, :] = sum of g.flat[j, :] over the j with ti3.flat[j] == v.
// Miss lanes all read the vertex rows of triangle 0, so on a frame of mostly
// sky three rows receive almost every addend (zeros).  Design: the caller
// sorts the 3R indices stably (torch.sort as glue, as render.py builds its
// pixel lists), so equal indices form runs in their original order.  Pass 1:
// one warp per chunk of kChunkB sorted entries, lane c on column c, walks
// the chunk in order; a run wholly inside the chunk is complete and written
// to out, the chunk's first and last runs (which may go on in a neighbour)
// to head/tail partials.  Pass 2: one thread per (v, c) finds v's run by
// binary search and, unless pass 1 wrote it, adds its pieces in chunk order.
// Addends that are exactly +-0.0 are skipped: from +0.0 a sum never changes
// by adding a zero, so the bytes are those of the sum with them, and the
// miss lanes' zeros cost no adds.  Deterministic, no atomics.
//
// Both sum in double and round once to float: a frame's sum runs over
// millions of float cotangents of both signs, and in float its rounding
// error (some eps x sum |g|) would be larger than the result's last digits
// on rows where the terms cancel.  In double the result is the float
// nearest the exact sum, whatever the order (the plain versions sum in
// double too).  The H100's double rate is far above what these adds need.
//
// What bounds them on an H100: bytes.  K7a reads R x (C + 1) x 4 bytes once
// (2,073,600 x 19 x 4 = 158 MB for sf_cam at 1080p x 1 spp, 47 us at
// 3.35 TB/s); K7b reads 3R x (4 + 4 + 48) bytes of sorted keys, permutation
// and cotangent rows (0.35 GB at 1080p, 0.10 ms).  K7a's compares (S x C
// per row, spread over a block) are integer work well under that line on
// the golden tables.
//
// Built with the parity flags of ops/cuda_build.py (no FMA contraction:
// sums only).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockA = 256;    // K7a threads per block
constexpr int kPerThread = 4;   // K7a output elements a thread holds
constexpr int kGroupA = kBlockA * kPerThread;
constexpr int kChunkB = 2048;   // K7b sorted entries per warp (multiple of 32)
constexpr int kWarpsB = 4;      // K7b warps per block
constexpr unsigned kFull = 0xffffffffu;

// K7a pass 1: block b sums rows [b * rows_per_block, ...) of g (R, C) into
// partial[b][e] for the output elements e of [e0, e0 + kGroupA).
__global__ void __launch_bounds__(kBlockA)
    stg_partials(const float* __restrict__ g, const int* __restrict__ idx, int R, int S,
                 int C, int rows_per_block, int tile, int e0, double* __restrict__ partial) {
    extern __shared__ float smem[];
    float* sg = smem;                         // tile x C cotangents
    int* sidx = (int*)(smem + (size_t)tile * C);  // tile indices
    const int SC = S * C;
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(R, r0 + rows_per_block);
    int row[kPerThread], col[kPerThread];
    double acc[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int e = e0 + threadIdx.x + k * kBlockA;
        const bool mine = e < SC;
        row[k] = mine ? e / C : -1;  // -1 matches no index
        col[k] = mine ? e % C : 0;
        acc[k] = 0.0;
    }
    for (int t0 = r0; t0 < r1; t0 += tile) {
        const int n = min(tile, r1 - t0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * C; i += kBlockA) sg[i] = g[(size_t)t0 * C + i];
        for (int i = threadIdx.x; i < n; i += kBlockA) sidx[i] = idx[t0 + i];
        __syncthreads();
        for (int r = 0; r < n; ++r) {
            const int key = sidx[r];
#pragma unroll
            for (int k = 0; k < kPerThread; ++k)
                if (key == row[k]) acc[k] = acc[k] + (double)sg[r * C + col[k]];
        }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
        if (row[k] >= 0)
            partial[(size_t)blockIdx.x * SC + e0 + threadIdx.x + k * kBlockA] = acc[k];
}

// K7a pass 2: out[e] = the blocks' partials of element e, in block order.
__global__ void stg_fold(const double* __restrict__ partial, int blocks, int SC,
                         float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= SC) return;
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s = s + partial[(size_t)b * SC + e];
    out[e] = (float)s;
}

// K7b pass 1: warp w walks sorted entries [w * kChunkB, ...) of (key, perm),
// lane c < C summing column c of the rows g[perm[j]] in order.
__global__ void __launch_bounds__(32 * kWarpsB)
    vg3_chunks(const int* __restrict__ keys, const int* __restrict__ perm,
               const float* __restrict__ g, int N, int C, int V, float* __restrict__ out,
               double* __restrict__ head, double* __restrict__ tail) {
    const int lane = threadIdx.x & 31;
    const int chunk = blockIdx.x * kWarpsB + (threadIdx.x >> 5);
    const int j0 = chunk * kChunkB;
    if (j0 >= N) return;  // whole warps leave together
    const int j1 = min(N, j0 + kChunkB);
    const bool col = lane < C;
    int prev = keys[j0];
    bool first = true;
    double acc = 0.0;
    for (int base = j0; base < j1; base += 32) {
        const int j = base + lane;
        const int my_key = j < j1 ? keys[j] : 0;
        const int my_perm = j < j1 ? perm[j] : 0;
        float x[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
            const int pj = __shfl_sync(kFull, my_perm, t);
            x[t] = (col && base + t < j1) ? g[(size_t)pj * C + lane] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) {
            const int key = __shfl_sync(kFull, my_key, t);
            if (base + t >= j1) break;  // uniform over the warp
            if (key != prev) {
                // the run of `prev` ended inside the chunk
                if (col) {
                    if (first)
                        head[(size_t)chunk * C + lane] = acc;
                    else if (prev >= 0 && prev < V)
                        out[(size_t)prev * C + lane] = (float)acc;  // whole run, one writer
                }
                first = false;
                acc = 0.0;
                prev = key;
            }
            if (x[t] != 0.0f) acc = acc + (double)x[t];
        }
    }
    // the chunk's last run (its first too when the chunk holds one key)
    if (col) {
        if (first) head[(size_t)chunk * C + lane] = acc;
        tail[(size_t)chunk * C + lane] = acc;
    }
}

__device__ __forceinline__ int lower_bound(const int* keys, int n, int v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (keys[mid] < v)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// K7b pass 2: out[v, c] for every run pass 1 did not write whole: no entry
// (0), or a run that touches its chunk's first or last entry (its pieces'
// partials, in chunk order).
__global__ void vg3_runs(const int* __restrict__ keys, int N, int C, int V,
                         const double* __restrict__ head, const double* __restrict__ tail,
                         float* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= V * C) return;
    const int v = t / C, c = t % C;
    const int lo = lower_bound(keys, N, v);
    const int hi = lower_bound(keys, N, v + 1);
    if (lo == hi) {
        out[t] = 0.0f;
        return;
    }
    const int k_lo = lo / kChunkB, k_hi = (hi - 1) / kChunkB;
    const bool starts_chunk = lo == k_lo * kChunkB;
    const bool ends_chunk = hi - 1 == min(N, (k_lo + 1) * kChunkB) - 1;
    if (k_lo == k_hi && !starts_chunk && !ends_chunk) return;  // pass 1 wrote it
    double s = 0.0;
    for (int k = k_lo; k <= k_hi; ++k)
        s = s + (k == k_lo && !starts_chunk ? tail : head)[(size_t)k * C + c];
    out[t] = (float)s;
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronise, allocates nothing, and returns the first refused launch's
// cudaError_t (0 = accepted); -1 for shapes it does not take.

// K7a: out (S, C) from g (R, C) and idx (R,); `partial` holds blocks x S x C
// doubles, blocks in [1, R].
extern "C" int pt_small_table_grad(const void* g, const void* idx, int R, int S, int C,
                                   int blocks, void* partial, void* out, void* stream) {
    if (R <= 0 || S <= 0 || C <= 0 || blocks <= 0 || blocks > R) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const int SC = S * C;
    const int rows_per_block = (R + blocks - 1) / blocks;
    // a tile of rows and their indices in at most 48 KB of shared memory
    const int fit = (48 * 1024 / 4) / (C + 1);
    const int tile = fit < 128 ? fit : 128;
    if (tile < 1) return -1;
    const size_t smem = (size_t)tile * (C + 1) * 4;
    for (int e0 = 0; e0 < SC; e0 += kGroupA) {
        stg_partials<<<blocks, kBlockA, smem, s>>>((const float*)g, (const int*)idx, R, S, C,
                                                   rows_per_block, tile, e0, (double*)partial);
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    stg_fold<<<(SC + 255) / 256, 256, 0, s>>>((const double*)partial, blocks, SC, (float*)out);
    return (int)cudaGetLastError();
}

// K7b: out (V, C) from the N = 3R stably sorted indices `keys`, their
// positions `perm` (rows of g viewed as (N, C)) and g; head and tail hold
// chunks x C doubles, chunks = ceil(N / pt_vattr_grad3_chunk()).  C <= 32.
extern "C" int pt_vattr_grad3(const void* keys, const void* perm, const void* g, int N,
                              int C, int V, void* head, void* tail, void* out,
                              void* stream) {
    if (N <= 0 || C <= 0 || C > 32 || V <= 0) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const int chunks = (N + kChunkB - 1) / kChunkB;
    vg3_chunks<<<(chunks + kWarpsB - 1) / kWarpsB, 32 * kWarpsB, 0, s>>>(
        (const int*)keys, (const int*)perm, (const float*)g, N, C, V, (float*)out,
        (double*)head, (double*)tail);
    int err = (int)cudaGetLastError();
    if (err) return err;
    vg3_runs<<<(V * C + 255) / 256, 256, 0, s>>>((const int*)keys, N, C, V,
                                                 (const double*)head, (const double*)tail,
                                                 (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int pt_vattr_grad3_chunk(void) { return kChunkB; }
