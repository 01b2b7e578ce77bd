// Row gather by asynchronous copies: out[i, :] = table[idx[i], :].
//
// Replaces the JAX package's TPU probe kernel tools/gather_probe.py::
// pallas_gather (per-row asynchronous copies from a device-memory table, `k`
// in flight).  Same function, same parameter: `k` row copies in flight per
// issuing unit.  On the TPU the issuing unit was the one core walking all R
// rows in order; here it is a warp walking its own contiguous span of rows,
// and many warps run side by side.
//
// What bounds it on an H100: bytes.  There is no arithmetic; every row is
// read once and written once, and the reads are random 16-byte-aligned rows
// of W*4 bytes.  What the design does about it:
//   * A row is moved as 16-byte pieces by `cp.async.cg` (global -> shared,
//     past L1, no register staging): lane c of the warp owns pieces c, c+32,
//     ... of every row of its warp, so one 512-byte row is one piece per
//     lane and the write back to `out` is one coalesced 512-byte store.
//   * Each warp keeps a ring of `k` row buffers in shared memory and one
//     cp.async group per row: row i is issued into slot i % k, then the warp
//     waits until at most k-1 groups are pending — that retires row i-(k-1),
//     which each lane copies from its own pieces of the slot to `out`.  A
//     lane reads back only what it copied itself, so the ring needs no
//     barrier: completion of a thread's own cp.async group is all it waits
//     on.
//   * `k` is a run-time argument (1..32); `cp.async.wait_group` takes an
//     immediate, so the wait is a switch over the 32 immediates.
//   * Shared memory is k * W * 4 bytes per warp, four warps per block; above
//     48 KB the launch opts in to the larger dynamic limit.
// This uses cp.async and not cuda::memcpy_async: the ring's depth is the
// probe's parameter, and the PTX form states it exactly.
//
// Indices must lie in [0, N): like the kernel it replaces, this one does not
// check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxInFlight = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..kMaxInFlight-1) of this thread's groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_pending(int n) {
    if (n >= N) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
    } else {
        cp_async_wait_pending<N - 1>(n);
    }
}
template <>
__device__ __forceinline__ void cp_async_wait_pending<0>(int) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBlock) gather_rows_kernel(
    const uint4* __restrict__ table,  // (N, W) f32 as W/4 pieces per row
    const int* __restrict__ idx,      // (R,)
    uint4* __restrict__ out,          // (R, W) f32, same pieces
    int pieces,                       // W / 4
    int k,                            // row copies in flight per warp
    int rows_per_warp, int R) {
    extern __shared__ uint4 ring[];   // kWarps x k x pieces
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint4* slots = ring + (size_t)warp * k * pieces;

    const long long first =
        ((long long)blockIdx.x * kWarps + warp) * (long long)rows_per_warp;
    if (first >= R) return;
    const int n = (int)min((long long)rows_per_warp, (long long)R - first);
    const int* my_idx = idx + first;
    uint4* my_out = out + (size_t)first * pieces;

    // step i issues row i (while there is one) and retires row i - (k - 1)
    for (int i = 0; i < n + k - 1; ++i) {
        if (i < n) {
            const uint4* src = table + (size_t)__ldg(my_idx + i) * pieces;
            uint4* dst = slots + (size_t)(i % k) * pieces;
            for (int c = lane; c < pieces; c += 32) cp_async16(dst + c, src + c);
        }
        cp_async_commit();  // one group per step, empty past the last row
        const int j = i - (k - 1);
        if (j >= 0) {
            cp_async_wait_pending<kMaxInFlight - 1>(k - 1);
            const uint4* src = slots + (size_t)(j % k) * pieces;
            uint4* dst = my_out + (size_t)j * pieces;
            for (int c = lane; c < pieces; c += 32) dst[c] = src[c];
        }
    }
}

}  // namespace

// The limits the wrapper checks its arguments against, so that it need not
// repeat them: warps per block, the most row copies in flight, and the most
// dynamic shared memory a block of the current device may opt in to (-1 if
// the device cannot be asked).
extern "C" int pt_gather_rows_warps() { return kWarps; }
extern "C" int pt_gather_rows_max_in_flight() { return kMaxInFlight; }
extern "C" int pt_gather_rows_max_shared_bytes() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return -1;
    return bytes;
}

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  `width` is f32 per row (a multiple of 4), `k` in
// 1..32.  Returns the cudaError_t of the launch (0 = accepted), -1 for a bad
// width or k.
extern "C" int pt_gather_rows(
    const void* table, const void* idx, void* out, int width, int R, int k,
    void* stream) {
    if (width <= 0 || width % 4 != 0 || k < 1 || k > kMaxInFlight) return -1;
    if (R <= 0) return 0;
    const int pieces = width / 4;
    // enough warps to fill the card, each with at least two rings' worth of
    // rows where the batch is that large
    long long warps = ((long long)R + 2 * k - 1) / (2 * k);
    const long long most = 132LL * 32;
    if (warps > most) warps = most;
    const int rows_per_warp = (int)(((long long)R + warps - 1) / warps);
    const long long used = ((long long)R + rows_per_warp - 1) / rows_per_warp;
    const unsigned blocks = (unsigned)((used + kWarps - 1) / kWarps);
    const size_t smem = (size_t)kWarps * k * pieces * sizeof(uint4);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    gather_rows_kernel<<<blocks, kBlock, smem, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)idx, (uint4*)out, pieces, k,
        rows_per_warp, R);
    return (int)cudaGetLastError();
}
