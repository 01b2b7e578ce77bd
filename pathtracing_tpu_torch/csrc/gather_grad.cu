// The transposes of the integrator's custom-VJP gathers (K7), the backward
// kernels of ops/integrator.SmallTableGather and RowGather.
//
// K7a replaces the JAX package's ops/integrator.py::small_table_gather's
// transpose (_stg_bwd :74-83, onehot(idx)^T @ g on the TPU's matrix unit):
//   out[s, c] = sum of g[r, c] over the rows r with idx[r] == s,
// for the per-subframe tables sf_cam (S, 18) and sf_light (S, 7).  Every lane
// of a frame lands on one of a few rows: contention is total, so no atomics.
// Every thread adds: thread t of a block takes column t % C of the rows
// j = t / C, j + J, j + 2J, ... (J = blockDim / C) of its block's stretch, so
// a block reads J x C contiguous floats a step, and holds the sums of KR
// output rows in registers (KR = 1 for a table of one row, else kRowsG;
// blockIdx.y picks which).  The J sums of a column are added in j order
// through shared memory; the last block to finish (an integer ticket: it
// does not set the order of any sum) adds the blocks' partials of each
// output: thread t those of blocks t, t + blockDim, ... in order, then a
// warp the block's sums of one output, lanes in order and a fixed shuffle
// tree.  One launch; the block count is set by R alone.
//
// K7b replaces the JAX package's ops/integrator.py::_vattr_gather3's transpose
// (_vg3_bwd :141-146, one scatter-add of 3R rows of 12 floats), and the
// transposes XLA derives for shade_hit's plain gathers inst_f[iidx] (:177)
// and tri_pos[tri_row] (:216):
//   out[v, :] = sum of g.flat[j, :] over the j with index.flat[j] == v,
// for an index of shape (R,) or (R, 3), N = k R entries.  Miss lanes all
// read row 0 (or the rows of triangle 0), so on a frame of mostly sky a few
// rows receive almost every addend (zeros).  First a stable sort of the N
// indices, by counting: keys lie in [0, V).  A table of V <= kMaxDigits rows
// takes one pass, on the key itself; a larger one P passes, least
// significant digit first, on digits of the same number of bits, at most
// kMaxBits each (49,289 rows: 16 bits, two passes of 8).  In a pass,
// a warp owns a chunk of kSortChunk entries and counts its digits in a row
// of shared memory (integer atomics: the counts do not depend on their
// order); the (warps, D) counts are scanned column by column, then in digit
// order, which gives each (warp, digit) its first position; the warp walks
// its chunk again, in order, and places each entry at that position plus
// its rank among the equal digits before it (__match_any_sync groups the
// equal digits of a warp step; a group's first lane advances the digit's
// position by the group's size).  Each pass is stable, so the last one
// leaves the keys sorted and equal keys in entry order; after P > 1 passes
// each key's first position comes from a binary search.  The chunks, and so
// the positions, depend on N alone; how many warps share a block only
// spreads them over the SMs.  Then the sum, on sub-chunks of kSeg sorted
// entries, each taken by C lanes (32 / C sub-chunks a warp), lane c on
// column c: a run wholly inside a sub-chunk is written to out, a sub-chunk's
// first and last runs (which may go on in a neighbour) to head/tail
// partials, and each such run's pieces are added by a warp, lanes striding
// the pieces in sub-chunk order and a fixed shuffle tree.  Addends that are
// exactly +-0.0 are skipped: from +0.0 a sum never changes by adding a
// zero, so the bytes are those of the sum with them, and the miss lanes'
// zeros cost no adds.  An index outside [0, V) adds nowhere.
//
// Both are deterministic (the order of every sum is fixed by the shapes
// alone; no atomics on floats) and sum in double, rounding once to float: a
// frame's sum runs over millions of float cotangents of both signs, and in
// float its rounding error (some eps x sum |g|) would be larger than the
// result's last digits on rows where the terms cancel.  In double the result
// is the float nearest the exact sum, whatever the order (the plain versions
// sum in double too).  The H100's double rate is far above what these adds
// need.
//
// What bounds them on an H100: bytes.  K7a reads R x (C + 1) x 4 bytes once
// (524,288 x 19 x 4 = 40 MB for sf_cam on a replay chunk, 12 us at 3.35
// TB/s); K7b reads N x (4 + 4 C) bytes of indices and cotangent rows (the
// vattr transpose of a chunk: 1,572,864 x 52 = 82 MB, 24 us).
//
// Built with the parity flags of ops/cuda_build.py (no FMA contraction:
// sums only).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockG = 256;      // K7a: threads per block
constexpr int kRowsG = 8;         // K7a: output rows a block holds
constexpr int kWarpsB = 4;        // K7b: warps per block of the sum
constexpr int kSortChunk = 2048;  // K7b: entries a warp owns in a pass (multiple of 256)
constexpr int kSeg = 128;         // K7b: sorted entries of a sub-chunk
constexpr int kBatch = 16;        // K7b: sorted entries a lane loads at once
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxDigits = kSmemBytes / 4;  // K7b: one warp's row of counts
constexpr int kMaxBits = 13;                // K7b: the widest digit, 2^13 <= kMaxDigits
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// ----------------------------------------------------------------- K7a grid

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
    return v;
}

// Block (x, y) sums rows [x * rows_per_block, ...) into the output rows
// [y * KR, y * KR + KR) of its partial; the last block adds the partials.
// partial holds gridDim.y x gridDim.x x KR x C doubles.  KR = 1 serves a
// table of one row (1 spp), with no array of sums for the compiler to put
// in local memory.
template <int KR>
__global__ void __launch_bounds__(kBlockG)
    stg_grid(const float* __restrict__ g, const int* __restrict__ idx, int R, int S, int C,
             int rows_per_block, double* __restrict__ partial, unsigned* __restrict__ ticket,
             float* __restrict__ out) {
    __shared__ double red[kRowsG][kBlockG];
    __shared__ bool last;
    const int t = threadIdx.x;
    const int J = kBlockG / C;  // row slices
    const int j = t / C, c = t % C;
    const int s0 = blockIdx.y * KR;
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(R, r0 + rows_per_block);
    double acc[KR];
#pragma unroll
    for (int k = 0; k < KR; ++k) acc[k] = 0.0;
    if (j < J) {
        int r = r0 + j;
        for (; r + 3 * J < r1; r += 4 * J) {
            int key[4];
            float v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                key[u] = idx[r + u * J] - s0;
                v[u] = g[(size_t)(r + u * J) * C + c];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int k = 0; k < KR; ++k)
                    acc[k] = acc[k] + (key[u] == k ? (double)v[u] : 0.0);
        }
        for (; r < r1; r += J) {
            const int key = idx[r] - s0;
            const float v = g[(size_t)r * C + c];
#pragma unroll
            for (int k = 0; k < KR; ++k) acc[k] = acc[k] + (key == k ? (double)v : 0.0);
        }
    }
#pragma unroll
    for (int k = 0; k < KR; ++k) red[k][t] = acc[k];
    __syncthreads();
    const int per = KR * C;  // a block's partial
    const int nb = gridDim.x;
    for (int e = t; e < per; e += kBlockG) {
        const int k = e / C, cc = e % C;
        double s = 0.0;
        for (int jj = 0; jj < J; ++jj) s = s + red[k][jj * C + cc];
        partial[((size_t)blockIdx.y * nb + blockIdx.x) * per + e] = s;
    }
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the fold: kRowsG outputs at a time; thread t adds the partials of
    // blocks t, t + kBlockG, ... in order, warp k the kBlockG sums of the
    // group's output k (lanes in order, then a fixed shuffle tree)
    const int warp = t >> 5, lane = t & 31;
    for (int e0 = 0; e0 < S * C; e0 += kRowsG) {
        double f[kRowsG];
#pragma unroll
        for (int k = 0; k < kRowsG; ++k) f[k] = 0.0;
        for (int b = t; b < nb; b += kBlockG) {
#pragma unroll
            for (int k = 0; k < kRowsG; ++k) {
                const int e = min(e0 + k, S * C - 1), s = e / C, cc = e % C;
                f[k] = f[k] + __ldcg(partial + ((size_t)(s / KR) * nb + b) * per +
                                     (s % KR) * C + cc);
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kRowsG; ++k) red[k][t] = f[k];
        __syncthreads();
        double v = 0.0;
        for (int i = lane; i < kBlockG; i += 32) v = v + red[warp][i];
        v = warp_sum(v);
        if (lane == 0 && e0 + warp < S * C) out[e0 + warp] = (float)v;
    }
}

// ---------------------------------------------------------------------- K7b

// The entries of one warp step: [base, base + 256) of the warp's chunk
// [., j1), 8 a lane in entry order.  k: the key, or -1 for none or a key
// outside [0, V); d: its digit (k >> shift) & mask, or -1.
__device__ __forceinline__ void step_keys(const int* __restrict__ keys, int base, int j1,
                                          int V, int shift, int mask, int lane, int (&k)[8],
                                          int (&d)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int j = base + 32 * u + lane;
        const int key = j < j1 ? keys[j] : -1;
        k[u] = (unsigned)key < (unsigned)V ? key : -1;
        d[u] = k[u] >= 0 ? (k[u] >> shift) & mask : -1;
    }
}

// Warp w counts the digits of entries [w * kSortChunk, ...) of the n =
// (n_in ? *n_in : N) keys into cnt[w][.] (every one of its D counts
// written).  wpb warps a block, a row of D ints of shared memory each.
__global__ void rowg_count(const int* __restrict__ keys, const int* __restrict__ n_in, int N,
                           int V, int D, int shift, int mask, int W, int* __restrict__ cnt) {
    extern __shared__ int rows[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int w = blockIdx.x * (blockDim.x >> 5) + wib;
    if (w >= W) return;  // whole warps leave together
    int* row = rows + (size_t)wib * D;
    for (int v = lane; v < D; v += 32) row[v] = 0;
    __syncwarp();
    const int n = n_in ? *n_in : N;
    const int j0 = w * kSortChunk, j1 = min(n, j0 + kSortChunk);
    for (int base = j0; base < j1; base += 256) {
        int k[8], d[8];
        step_keys(keys, base, j1, V, shift, mask, lane, k, d);
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (d[u] >= 0) atomicAdd(&row[d[u]], 1);  // integers: any order gives the count
    }
    __syncwarp();
    for (int v = lane; v < D; v += 32) cnt[(size_t)w * D + v] = row[v];
}

// Column scan: cnt[w][v] becomes the count of digit v in warps [0, w), and
// total[v] the count of digit v.  A block takes 32 digits, lane l digit v0 +
// l (coalesced rows), warp q the warps [q * seg, (q + 1) * seg).
__global__ void __launch_bounds__(1024)
    rowg_colscan(int* __restrict__ cnt, int W, int D, int* __restrict__ total) {
    __shared__ int part[32][33];
    const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
    const int v = blockIdx.x * 32 + lane;
    const bool ok = v < D;
    const int seg = (W + 31) / 32;
    const int w0 = min(W, q * seg), w1 = min(W, w0 + seg);
    int s = 0;
    if (ok)
#pragma unroll 8
        for (int w = w0; w < w1; ++w) s += cnt[(size_t)w * D + v];
    part[q][lane] = s;
    __syncthreads();
    int run = 0;
    for (int p = 0; p < q; ++p) run += part[p][lane];
    if (ok) {
        if (q == 31) total[v] = run + s;
        for (int w = w0; w < w1; ++w) {
            const size_t i = (size_t)w * D + v;
            const int c = cnt[i];
            cnt[i] = run;
            run += c;
        }
    }
}

// Exclusive scan of total[0, D) in place, one block; total[D] = the sum.
__global__ void __launch_bounds__(kScanThreads) rowg_keyscan(int* __restrict__ total, int D) {
    __shared__ int warp_sums[kScanThreads / 32];
    const int t = threadIdx.x, lane = t & 31, wi = t >> 5;
    const int per = (D + kScanThreads - 1) / kScanThreads;
    const int i0 = min(D, t * per), i1 = min(D, i0 + per);
    int s = 0;
    for (int i = i0; i < i1; ++i) s += total[i];
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[wi] = incl;
    __syncthreads();
    int before = 0;
    for (int p = 0; p < wi; ++p) before += warp_sums[p];
    int run = before + incl - s;
    for (int i = i0; i < i1; ++i) {
        const int c = total[i];
        total[i] = run;
        run += c;
    }
    if (t == kScanThreads - 1) total[D] = run;
}

// Warp w places each entry j of its chunk with digit v at start[v] +
// cnt[w][v] + (equal digits before it in the chunk): perm = perm_in[j] (j
// itself in the first pass, perm_in null), skeys = its key.
__global__ void rowg_scatter(const int* __restrict__ keys, const int* __restrict__ perm_in,
                             const int* __restrict__ n_in, int N, int V, int D, int shift,
                             int mask, int W,
                             const int* __restrict__ cnt, const int* __restrict__ start,
                             int* __restrict__ perm, int* __restrict__ skeys) {
    extern __shared__ int rows[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int w = blockIdx.x * (blockDim.x >> 5) + wib;
    if (w >= W) return;
    int* row = rows + (size_t)wib * D;
    for (int v = lane; v < D; v += 32) row[v] = start[v] + cnt[(size_t)w * D + v];
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    const int n = n_in ? *n_in : N;
    const int j0 = w * kSortChunk, j1 = min(n, j0 + kSortChunk);
    for (int base = j0; base < j1; base += 256) {
        int k[8], d[8];
        step_keys(keys, base, j1, V, shift, mask, lane, k, d);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const unsigned peers = __match_any_sync(kFull, d[u]);
            if (d[u] >= 0) {
                const int j = base + 32 * u + lane;
                const int p = row[d[u]] + __popc(peers & below);
                perm[p] = perm_in ? perm_in[j] : j;
                skeys[p] = k[u];
            }
            __syncwarp();
            if (d[u] >= 0 && lane == __ffs(peers) - 1) row[d[u]] += __popc(peers);
            __syncwarp();
        }
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

// After P > 1 passes: start[v] = the first position of key v among the n =
// *n_in sorted keys, v in [0, V] (start[V] = n).
__global__ void rowg_bounds(const int* __restrict__ skeys, const int* __restrict__ n_in, int V,
                            int* __restrict__ start) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v > V) return;
    start[v] = lower_bound(skeys, *n_in, v);
}

// The sum over the sorted entries [0, start[V]): lanes [p C, p C + C) of a
// warp take sub-chunk q = warp * (32 / C) + p of kSeg entries, lane p C + c
// column c, and walk it in order.
__global__ void __launch_bounds__(32 * kWarpsB)
    rowg_segments(const int* __restrict__ skeys, const int* __restrict__ perm,
                  const float* __restrict__ g, const int* __restrict__ start, int C, int V,
                  float* __restrict__ out, double* __restrict__ head,
                  double* __restrict__ tail) {
    const int lane = threadIdx.x & 31;
    const int P = 32 / C;
    const int p = lane / C, c = lane % C;
    const int q = (blockIdx.x * kWarpsB + (threadIdx.x >> 5)) * P + p;
    const int n = start[V];
    const int i0 = q * kSeg;
    if (p >= P || i0 >= n) return;  // no shuffles below: lanes may leave alone
    const int i1 = min(n, i0 + kSeg);
    int prev = skeys[i0];
    bool first = true;
    double acc = 0.0;
    // the rows of a batch are those of the positions loaded one batch
    // ahead, so a batch waits for one load, not for two in a chain
    int pj[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) pj[u] = i0 + u < i1 ? perm[i0 + u] : 0;
    for (int i = i0; i < i1; i += kBatch) {
        // entries past the sub-chunk read as no key and a zero: they change
        // nothing
        int key[kBatch];
        float x[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const bool in = i + u < i1;
            key[u] = in ? skeys[i + u] : -1;
            x[u] = in ? g[(size_t)pj[u] * C + c] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int j = i + kBatch + u;
            pj[u] = j < i1 ? perm[j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (key[u] >= 0 && key[u] != prev) {
                if (first)
                    head[(size_t)q * C + c] = acc;
                else
                    out[(size_t)prev * C + c] = (float)acc;  // whole run, one writer
                first = false;
                acc = 0.0;
                prev = key[u];
            }
            if (x[u] != 0.0f) acc = acc + (double)x[u];
        }
    }
    if (first) head[(size_t)q * C + c] = acc;
    tail[(size_t)q * C + c] = acc;
}

// out[v, c] for every run rowg_segments did not write whole, a warp an
// element: lanes stride the run's pieces in sub-chunk order, then a fixed
// shuffle tree.
__global__ void rowg_pieces(const int* __restrict__ start, int C, int V,
                            const double* __restrict__ head, const double* __restrict__ tail,
                            float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (e >= (long long)V * C) return;  // whole warps leave together
    const int v = (int)(e / C), c = (int)(e % C);
    const int lo = start[v], hi = start[v + 1], n = start[V];
    if (lo == hi) {
        if (lane == 0) out[e] = 0.0f;
        return;
    }
    const int k_lo = lo / kSeg, k_hi = (hi - 1) / kSeg;
    const bool starts_seg = lo == k_lo * kSeg;
    const bool ends_seg = hi == min(n, (k_lo + 1) * kSeg);
    if (k_lo == k_hi && !starts_seg && !ends_seg) return;  // written whole
    double s = 0.0;
    for (int k = k_lo + lane; k <= k_hi; k += 32)
        s = s + (k == k_lo && !starts_seg ? tail : head)[(size_t)k * C + c];
    s = warp_sum(s);
    if (lane == 0) out[e] = (float)s;
}

// Warps a block of rowg_count / rowg_scatter: as many as the rows of D
// counts let share 48 KB, at most 8, and few enough that the W warps spread
// over the card's SMs.
int counting_warps_per_block(int D, int W, int sms) {
    int wpb = kSmemBytes / (4 * D);
    wpb = wpb < 8 ? wpb : 8;
    const int spread = W / sms;
    return spread < 1 ? 1 : (spread < wpb ? spread : wpb);
}

// K7b's passes for a table of V rows: one on the key itself (D = V) up to
// kMaxDigits rows; past that P passes over digits of `bits` bits (D = 2^bits),
// the fewest with P x bits >= the bits of V - 1, at most kMaxBits each.
void row_grad_digits(int V, int* P, int* D, int* bits) {
    if (V <= kMaxDigits) {
        *P = 1, *D = V, *bits = 0;
        return;
    }
    int b = 0;
    while ((1LL << b) < V) ++b;
    *P = (b + kMaxBits - 1) / kMaxBits;
    *bits = (b + *P - 1) / *P;
    *D = 1 << *bits;
}

}  // namespace

// Plain C interface for ctypes.  Each launches on `stream`, does not
// synchronise, allocates nothing, and returns the first refused launch's
// cudaError_t (0 = accepted); -1 for shapes it does not take.

// K7a: out (S, C) from g (R, C) and idx (R,), C <= 256; `work` holds
// pt_small_table_grad_work(blocks, S, C) doubles, blocks in [1, R].
extern "C" long long pt_small_table_grad_work(int blocks, int S, int C) {
    const long long kr = S == 1 ? 1 : kRowsG;
    return (S + kr - 1) / kr * blocks * kr * C + 1;  // partials, then the ticket
}

extern "C" int pt_small_table_grad(const void* g, const void* idx, int R, int S, int C,
                                   int blocks, void* work, void* out, void* stream) {
    if (R <= 0 || S <= 0 || C <= 0 || C > kBlockG || blocks <= 0 || blocks > R) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    const int kr = S == 1 ? 1 : kRowsG;
    const int groups = (S + kr - 1) / kr;
    double* partial = (double*)work;
    unsigned* ticket = (unsigned*)(partial + (size_t)groups * blocks * kr * C);
    int err = (int)cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
    if (err) return err;
    const int rows_per_block = (R + blocks - 1) / blocks;
    const dim3 grid(blocks, groups);
    if (kr == 1)
        stg_grid<1><<<grid, kBlockG, 0, s>>>((const float*)g, (const int*)idx, R, S, C,
                                             rows_per_block, partial, ticket, (float*)out);
    else
        stg_grid<kRowsG><<<grid, kBlockG, 0, s>>>((const float*)g, (const int*)idx, R, S, C,
                                                  rows_per_block, partial, ticket,
                                                  (float*)out);
    return (int)cudaGetLastError();
}

// K7b: the sort's passes for a table of V rows.
extern "C" int pt_row_grad_passes(int V) {
    int P = 0, D = 0, bits = 0;
    if (V > 0) row_grad_digits(V, &P, &D, &bits);
    return P;
}

// K7b: the workspace of N entries, C columns, V rows: *ints int32 and
// *doubles float64 elements.
extern "C" void pt_row_grad_work(int N, int C, int V, long long* ints, long long* doubles) {
    int P = 1, D = 1, bits = 0;
    if (V > 0) row_grad_digits(V, &P, &D, &bits);
    const long long W = (N + kSortChunk - 1) / kSortChunk;
    const long long Q = (N + kSeg - 1) / kSeg;
    // counts, each pass's digit starts, the key starts after P > 1 passes,
    // then (perm, skeys) for one pass or two in turn
    *ints = W * D + (long long)P * (D + 1) + (P > 1 ? V + 1 : 0) + (P > 1 ? 4LL : 2LL) * N;
    *doubles = 2 * Q * C;
}

// K7b: out (V, C) from the N indices `index` (unsorted) and g (N, C), C <=
// 32; the workspace as pt_row_grad_work gives it.
extern "C" int pt_row_grad(const void* index, const void* g, int N, int C, int V, void* ints,
                           void* doubles, void* out, void* stream) {
    if (N <= 0 || C <= 0 || C > 32 || V <= 0) return -1;
    cudaStream_t s = (cudaStream_t)stream;
    int P = 0, D = 0, bits = 0;
    row_grad_digits(V, &P, &D, &bits);
    const int W = (N + kSortChunk - 1) / kSortChunk;
    const int Q = (N + kSeg - 1) / kSeg;
    int* cnt = (int*)ints;
    int* dstart = cnt + (size_t)W * D;                           // P x (D + 1)
    int* start = P > 1 ? dstart + (size_t)P * (D + 1) : dstart;  // V + 1
    int* sorted = P > 1 ? start + (V + 1) : dstart + (D + 1);
    double* head = (double*)doubles;
    double* tail = head + (size_t)Q * C;
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
    const int wpb = counting_warps_per_block(D, W, sms);
    const int blocks = (W + wpb - 1) / wpb;
    const size_t smem = (size_t)wpb * D * 4;
    // pass p sorts stably by digit p: from the index (invalid keys dropped,
    // n = N) in the first, from the last pass's (skeys, perm, n) after
    const int* keys = (const int*)index;
    const int* perm_in = nullptr;
    const int* n_in = nullptr;
    const int mask = P == 1 ? -1 : D - 1;
    for (int p = 0; p < P; ++p) {
        int* ds = dstart + (size_t)p * (D + 1);
        int* perm = sorted + (size_t)(p & 1) * 2 * N;
        int* skeys = perm + N;
        rowg_count<<<blocks, 32 * wpb, smem, s>>>(keys, n_in, N, V, D, p * bits, mask, W,
                                                  cnt);
        if ((err = (int)cudaGetLastError())) return err;
        rowg_colscan<<<(D + 31) / 32, 1024, 0, s>>>(cnt, W, D, ds);
        if ((err = (int)cudaGetLastError())) return err;
        rowg_keyscan<<<1, kScanThreads, 0, s>>>(ds, D);
        if ((err = (int)cudaGetLastError())) return err;
        rowg_scatter<<<blocks, 32 * wpb, smem, s>>>(keys, perm_in, n_in, N, V, D, p * bits,
                                                    mask, W, cnt, ds, perm, skeys);
        if ((err = (int)cudaGetLastError())) return err;
        keys = skeys;
        perm_in = perm;
        n_in = ds + D;
    }
    if (P > 1) {
        rowg_bounds<<<(V + 1 + 255) / 256, 256, 0, s>>>(keys, n_in, V, start);
        if ((err = (int)cudaGetLastError())) return err;
    }
    const int Pc = 32 / C;
    const int warps = (Q + Pc - 1) / Pc;
    rowg_segments<<<(warps + kWarpsB - 1) / kWarpsB, 32 * kWarpsB, 0, s>>>(
        keys, perm_in, (const float*)g, start, C, V, (float*)out, head, tail);
    if ((err = (int)cudaGetLastError())) return err;
    const long long threads = 32LL * V * C;
    rowg_pieces<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(start, C, V, head, tail,
                                                                  (float*)out);
    return (int)cudaGetLastError();
}
