// Row gather: out[i, :] = table[idx[i], :].
//
// Replaces the JAX package's TPU probe kernel tools/gather_probe.py::
// pallas_gather (per-row asynchronous copies from a device-memory table, `k`
// in flight).  Same function, same parameter: `k` row copies in flight per
// issuing warp.
//
// What bounds it on an H100: bytes.  There is no arithmetic; every touched
// row must be read once and every output row written once.  The rows are
// random 16-byte-aligned rows of W*4 bytes, and a table past the 50 MB L2
// is read from device memory again each time a row comes back after it left
// the L2, which in arrival order is most of the time.  What the design does:
//   * Slices.  Where the table is larger than kSliceBytes and the batch has
//     at least as many positions as the table has rows (so rows repeat), a
//     counting pass groups the positions by bucket idx >> shift, a slice of
//     2^shift rows within kSliceBytes: per-block counts (integer atomics in
//     shared memory), the blocks' offsets (one block), and a scatter of
//     (row, position) pairs into scratch, put in bucket order in shared
//     memory first so that the stores coalesce.  The copy takes the
//     pairs in that order, so the rows in flight lie in one or two slices
//     and a repeated row is read from device memory about once.  The order
//     inside a bucket is not stable; it changes no byte of the output.
//   * Rows in flight.  A warp keeps a ring of `k` rows in shared memory, a
//     row moved as 16-byte `cp.async.cg` pieces (lane c: pieces c, c+32, ...)
//     and one cp.async group a step: step i issues entry i and retires entry
//     i - (k - 1), which each lane copies from its own pieces of the slot, so
//     the ring needs no barrier.  `cp.async.wait_group` takes an immediate:
//     the wait is a switch over the 32 immediates.
//   * No tail.  The grid is the blocks the card holds at once; a warp takes
//     chunks of the list (k..32 entries) from a static first chunk and then
//     one global atomic cursor, claimed a chunk ahead, so no warp has a
//     fixed span and no second wave runs at a fraction of the card.  A
//     small batch is spread over the resident warps, k entries or more each.
//   * The output is stored with an L2 evict-first policy, so its stream does
//     not push the slice being read out of the L2.
// The slice size and the batch rule were set by timing (PERF.md §6, on an
// H100 80GB HBM3 at 700 W, L2 flushed, k = 16, device time): on the
// 458,752 x 128 table at 2,073,600 positions slices of 4, 8 and 16 MB took
// 0.622, 0.609 and 0.610 ms against 0.727 ms in arrival order; at 8,192
// positions (1.8 % of the rows, nothing repeats) the pass cost 0.0059 ms
// (0.0176 against 0.0117 ms).  What the pass can save is the repeats, rows
// read again: 0.37 N of them at R = N (on that table 26 us of device-memory
// reads at 3.35 TB/s), 0.03 N at R = N / 4 (2 us), hence R >= N.
//
// Indices must lie in [0, N): like the kernel it replaces, this one does not
// check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kMaxInFlight = 32;
constexpr int kCountBlock = 1024;  // threads of a counting-pass block
constexpr int kMaxSpan = 5120;     // positions a counting-pass block takes at most
constexpr int kMaxBuckets = 256;
constexpr long long kSliceBytes = 8LL << 20;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
    return p;
}

__device__ __forceinline__ void st_evict_first(uint4* dst, uint4 v, uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(dst),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
                 : "memory");
}

// ---------------------------------------------------------- counting pass

// Block b counts the buckets idx >> shift of positions [b * span, ...) into
// cnt[b][.]; block 0 also zeroes the copy's cursor.
__global__ void __launch_bounds__(kCountBlock) gather_count(
    const int* __restrict__ idx, int R, int span, int shift, int B, int* __restrict__ cnt,
    int* __restrict__ cursor) {
    __shared__ int hist[kMaxBuckets];
    const int lane = threadIdx.x & 31;
    for (int v = threadIdx.x; v < B; v += kCountBlock) hist[v] = 0;
    if (blockIdx.x == 0 && threadIdx.x == 0) *cursor = 0;
    __syncthreads();
    const int j0 = blockIdx.x * span, j1 = min(R, j0 + span);
    for (int base = j0; base < j1; base += kCountBlock) {
        const int j = base + threadIdx.x;
        const int v = j < j1 ? __ldg(idx + j) >> shift : -1;
        const unsigned peers = __match_any_sync(kFull, v);
        // integers: any order of the adds gives the count
        if (v >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[v], __popc(peers));
    }
    __syncthreads();
    for (int v = threadIdx.x; v < B; v += kCountBlock) cnt[(size_t)blockIdx.x * B + v] = hist[v];
}

// One block: offs[g][v] = where the entries of bucket v from count block g
// start in the list, that is (the entries of buckets below v) + (those of
// bucket v in blocks below g).  Lane l takes bucket v0 + l, warp q the count
// blocks [q * seg, (q + 1) * seg), 32 buckets at a time.
__global__ void __launch_bounds__(1024) gather_offsets(const int* __restrict__ cnt, int G,
                                                       int B, int* __restrict__ offs) {
    __shared__ int part[32][33];
    const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
    const int seg = (G + 31) / 32;
    const int g0 = min(G, q * seg), g1 = min(G, g0 + seg);
    int carry = 0;  // entries of the buckets below v0
    for (int v0 = 0; v0 < B; v0 += 32) {
        const int v = v0 + lane;
        int sum = 0;
        if (v < B)
            for (int g = g0; g < g1; ++g) sum += cnt[(size_t)g * B + v];
        part[q][lane] = sum;
        __syncthreads();
        int below = 0, total = 0;
        for (int w = 0; w < 32; ++w) {
            const int x = part[w][lane];
            total += x;
            below += w < q ? x : 0;
        }
        int incl = total;
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += u;
        }
        if (v < B) {
            int run = carry + incl - total + below;
            for (int g = g0; g < g1; ++g) {
                offs[(size_t)g * B + v] = run;
                run += cnt[(size_t)g * B + v];
            }
        }
        carry += __shfl_sync(kFull, incl, 31);
        __syncthreads();  // part is rewritten for the next 32 buckets
    }
}

// Block b puts its (row, position) pairs in bucket order in shared memory
// first (slots from integer atomics on its bucket cursors: the order inside
// a bucket follows them and is not stable), then writes them out, each
// bucket's run to offs[b][v] onwards, neighbouring threads to neighbouring
// addresses.
__global__ void __launch_bounds__(kCountBlock) gather_scatter(
    const int* __restrict__ idx, int R, int span, int shift, int B,
    const int* __restrict__ cnt, const int* __restrict__ offs, int* __restrict__ keys,
    int* __restrict__ pos) {
    __shared__ int stage[2 * kMaxSpan];  // rows, then positions
    __shared__ int start[kMaxBuckets], cur[kMaxBuckets], goff[kMaxBuckets];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t row = (size_t)blockIdx.x * B;
    if (warp == 0) {  // start[v]: this block's entries of the buckets below v
        int carry = 0;
        for (int v0 = 0; v0 < B; v0 += 32) {
            const int v = v0 + lane;
            const int t = v < B ? cnt[row + v] : 0;
            int incl = t;
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += u;
            }
            if (v < B) {
                start[v] = cur[v] = carry + incl - t;
                goff[v] = offs[row + v];
            }
            carry += __shfl_sync(kFull, incl, 31);
        }
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    const int j0 = blockIdx.x * span, j1 = min(R, j0 + span);
    for (int base = j0; base < j1; base += kCountBlock) {
        const int j = base + threadIdx.x;
        const int key = j < j1 ? __ldg(idx + j) : 0;
        const int v = j < j1 ? key >> shift : -1;
        const unsigned peers = __match_any_sync(kFull, v);
        const int leader = __ffs(peers) - 1;
        int first = 0;
        if (v >= 0 && lane == leader) first = atomicAdd(&cur[v], __popc(peers));
        first = __shfl_sync(kFull, first, leader);
        if (v >= 0) {
            const int t = first + __popc(peers & below);
            stage[t] = key;
            stage[kMaxSpan + t] = j;
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < j1 - j0; t += kCountBlock) {
        const int key = stage[t];
        const int v = key >> shift;
        const int p = goff[v] + t - start[v];
        keys[p] = key;
        pos[p] = stage[kMaxSpan + t];
    }
}

// ------------------------------------------------------------------ copy

// The copy in list order: entry e of the list is row keys[e] to output row
// pos[e] (pos == nullptr: e itself).  Warp w takes chunk w of `chunk`
// entries (k..32), then, where the static chunks do not cover the list,
// further chunks from `cursor` (one claim ahead).  The entries of a warp form
// one stream; step i issues its entry i and retires entry i - (k - 1), which
// lies in the current chunk or the one before (k <= chunk).  Lane l holds
// entry l of the current chunk and of the next (loaded a chunk ahead).
__global__ void __launch_bounds__(kBlock) gather_copy(
    const uint4* __restrict__ table,  // (N, W) f32 as W/4 pieces per row
    const int* __restrict__ keys, const int* __restrict__ pos,
    uint4* __restrict__ out,          // (R, W) f32, same pieces
    int pieces, int k, int R, int chunk, int* __restrict__ cursor) {
    extern __shared__ uint4 ring[];   // kWarps x k x pieces
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = gridDim.x * kWarps;
    int c0 = (blockIdx.x * kWarps + warp) * chunk;
    if (c0 >= R) return;
    const bool dynamic = (long long)nw * chunk < R;
    const int statics = nw * chunk;
    uint4* slots = ring + (size_t)warp * k * pieces;
    const int d = k - 1;  // retire lag
    const uint64_t pol = evict_first_policy();

    int ticket = 0;
    if (dynamic && lane == 0) ticket = atomicAdd(cursor, chunk);
    int e = lane < chunk ? c0 + lane : R;
    int cur_key = e < R ? __ldg(keys + e) : -1;
    int cur_p = e < R ? (pos ? __ldg(pos + e) : e) : -1;
    int prev_p = -1;
    int i = 0;
    for (;;) {
        // the next chunk's start, its entries loaded now, used next round
        int c1 = R;
        if (c0 < R && dynamic) {
            c1 = statics + __shfl_sync(kFull, ticket, 0);
            if (c1 < R && lane == 0) ticket = atomicAdd(cursor, chunk);
        }
        e = lane < chunk ? c1 + lane : R;
        const int nxt_key = e < R ? __ldg(keys + e) : -1;
        const int nxt_p = e < R ? (pos ? __ldg(pos + e) : e) : -1;
        const int rows = c0 < R ? chunk : d;  // past the list: drain
        for (int r = 0; r < rows; ++r, ++i) {
            const int key = __shfl_sync(kFull, cur_key, r);
            const int p = __shfl_sync(kFull, r >= d ? cur_p : prev_p,
                                      r >= d ? r - d : chunk + r - d);
            if (key >= 0) {
                const uint4* src = table + (size_t)key * pieces;
                uint4* dst = slots + (size_t)(i % k) * pieces;
                for (int c = lane; c < pieces; c += 32) cp_async16(dst + c, src + c);
            }
            cp_async_commit();  // one group a step, empty when nothing was issued
            if (p >= 0) {
                cp_async_wait_pending<kMaxInFlight - 1>(k - 1);
                const uint4* src = slots + (size_t)((i - d) % k) * pieces;
                uint4* dst = out + (size_t)p * pieces;
                for (int c = lane; c < pieces; c += 32) st_evict_first(dst + c, src[c], pol);
            }
        }
        if (c0 >= R) break;
        prev_p = cur_p;
        cur_key = nxt_key;
        cur_p = nxt_p;
        c0 = c1;
    }
}

// ------------------------------------------------------------------ plan

struct Plan {
    int pieces;
    size_t smem;
    int blocks, chunk;  // of the copy
    bool dynamic;       // the copy claims chunks from the cursor
    int shift, B;       // buckets of 2^shift rows (B > 1: the counting pass runs)
    int G, span;        // counting-pass blocks and the positions of each
    long long scratch;  // int32: cursor (4), keys (R), pos (R), cnt and offs (G * B each)
};

// 0, -1 for a shape the kernel does not take, or a cudaError_t.
int make_plan(int width, int N, int R, int k, Plan* pl) {
    if (width <= 0 || width % 4 != 0 || k < 1 || k > kMaxInFlight || N <= 0 || R < 0)
        return -1;
    Plan p{};
    p.pieces = width / 4;
    p.smem = (size_t)kWarps * k * p.pieces * sizeof(uint4);
    const long long row = (long long)width * 4;
    while ((row << (p.shift + 1)) <= kSliceBytes && p.shift < 30) ++p.shift;
    while ((((long long)N - 1) >> p.shift) + 1 > kMaxBuckets) ++p.shift;
    p.B = R >= N ? (int)((((long long)N - 1) >> p.shift) + 1) : 1;
    if (R > 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(gather_copy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)p.smem);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_copy, kBlock,
                                                              p.smem);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) return -1;
        // chunks of 32 where the resident warps cannot take the list in one
        // chunk each; else the list spread over them, at least k entries a warp
        const long long most = (long long)sms * per_sm;
        const long long per_warp = ((long long)R + most * kWarps - 1) / (most * kWarps);
        p.chunk = (int)(per_warp > 32 ? 32 : (per_warp < k ? k : per_warp));
        const long long need = ((long long)R + p.chunk * kWarps - 1) / (p.chunk * kWarps);
        p.blocks = (int)(need < most ? need : most);
        p.dynamic = (long long)p.blocks * kWarps * p.chunk < R;
        if (p.B > 1) {  // two blocks an SM, more where a block's span would not fit
            long long g = ((long long)R + kCountBlock - 1) / kCountBlock;
            if (g > 2LL * sms) g = 2LL * sms;
            const long long fit = ((long long)R + kMaxSpan - 1) / kMaxSpan;
            p.G = (int)(g > fit ? g : fit);
            p.span = (int)(((long long)R + p.G - 1) / p.G);
        }
        p.scratch = (p.dynamic || p.B > 1 ? 4 : 0) +
                    (p.B > 1 ? 2LL * R + 2LL * p.G * p.B : 0);
    }
    *pl = p;
    return 0;
}

int count_pass(const Plan& p, const int* idx, int R, int* scratch, cudaStream_t s) {
    int* keys = scratch + 4;
    int* pos = keys + R;
    int* cnt = pos + R;
    int* offs = cnt + (size_t)p.G * p.B;
    gather_count<<<p.G, kCountBlock, 0, s>>>(idx, R, p.span, p.shift, p.B, cnt, scratch);
    int err = (int)cudaGetLastError();
    if (err) return err;
    gather_offsets<<<1, 1024, 0, s>>>(cnt, p.G, p.B, offs);
    if ((err = (int)cudaGetLastError())) return err;
    gather_scatter<<<p.G, kCountBlock, 0, s>>>(idx, R, p.span, p.shift, p.B, cnt, offs, keys,
                                               pos);
    return (int)cudaGetLastError();
}

}  // namespace

// The limits the wrapper checks its arguments against, so that it need not
// repeat them: warps per block, the most row copies in flight, the most
// dynamic shared memory a block of the current device may opt in to (-1 if
// the device cannot be asked), and the slice size.
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
extern "C" long long pt_gather_rows_slice_bytes() { return kSliceBytes; }

// The int32 scratch a launch of this shape needs (0: none); < 0 is what the
// launch would return, negated.
extern "C" long long pt_gather_rows_scratch(int width, int N, int R, int k) {
    Plan p;
    const int err = make_plan(width, N, R, k, &p);
    return err ? (err > 0 ? -(long long)err : -1) : p.scratch;
}

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing (`scratch`: pt_gather_rows_scratch ints, or null where
// that is 0).  `width` is f32 per row (a multiple of 4), `N` the table's
// rows, `k` in 1..32.  Returns the cudaError_t of the first refused launch
// (0 = accepted), -1 for a bad shape, k or missing scratch.
extern "C" int pt_gather_rows(const void* table, const void* idx, void* out, int width, int N,
                              int R, int k, void* scratch, void* stream) {
    Plan p;
    int err = make_plan(width, N, R, k, &p);
    if (err) return err;
    if (R <= 0) return 0;
    if (p.scratch > 0 && scratch == nullptr) return -1;
    const cudaStream_t s = (cudaStream_t)stream;
    int* cursor = (int*)scratch;
    const int* keys = (const int*)idx;
    const int* pos = nullptr;
    if (p.B > 1) {
        if ((err = count_pass(p, (const int*)idx, R, cursor, s))) return err;
        keys = cursor + 4, pos = cursor + 4 + R;
    } else if (p.dynamic) {
        const cudaError_t e = cudaMemsetAsync(cursor, 0, sizeof(int), s);
        if (e != cudaSuccess) return (int)e;
    }
    gather_copy<<<p.blocks, kBlock, p.smem, s>>>((const uint4*)table, keys, pos, (uint4*)out,
                                                 p.pieces, k, R, p.chunk, cursor);
    return (int)cudaGetLastError();
}

// The counting pass alone, an instrument for checks on the card: where a
// launch of this shape buckets, writes its pairs into `scratch` (rows at +4,
// positions at +4+R) and returns 0; 1 where it does not; else as
// pt_gather_rows.
extern "C" int pt_gather_rows_order(const void* idx, int width, int N, int R, int k,
                                    void* scratch, void* stream) {
    Plan p;
    const int err = make_plan(width, N, R, k, &p);
    if (err) return err;
    if (p.B <= 1) return 1;
    if (scratch == nullptr) return -1;
    return count_pass(p, (const int*)idx, R, (int*)scratch, (cudaStream_t)stream);
}
