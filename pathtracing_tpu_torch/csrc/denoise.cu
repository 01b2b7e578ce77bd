// The AOV-guided joint bilateral denoiser (K8), the kernel of
// denoise.joint_bilateral_denoise.
//
// Replaces the JAX package's denoise.py::_denoise (:36): (2r+1)^2 shifted
// adds over the (H, W) image, fused by XLA into one elementwise pass there.
// It computes the same function: for each pixel, the average of its (2r+1)^2
// neighbourhood (reads clamped to the image's edge, jnp.pad(mode="edge")),
// each neighbour weighted by the product of six factors, in this order:
//   spatial   exp(-(dx^2 + dy^2) / (2 s_s^2))
//   albedo    exp(-|a_n - a|^2 / (2 s_a^2))
//   normal    exp(-(1 - n_n . n) / max(s_n, 1e-6))
//   depth     exp(-(dz^2) / (2 s_d^2)),  dz = (z_n - z) / max(|z|, 1e-3)
//   coverage  exp(-8 |c_n - c|)
//   range     exp(-0.5 dl^2),  dl = (lum_n - lum) / (k max(max(sig_n, sig), 1e-20))
// then acc / max(wsum, 1e-20).  The taps are visited dy outer, dx inner,
// and the sums kept in that order, as the plain version
// (denoise.denoise_plain) does; every expression keeps its operand order.
//
// Two kernels, chosen per call by the wrapper (ops/cuda_denoise.py):
//
// denoise_tile, the design for the card.  A block owns a 32 x 8 tile of
// output pixels, one a thread.  It first stages the tile with its halo,
// (32 + 2r) x (8 + 2r) input pixels read once with clamped coordinates, in
// shared memory as packed 16-byte records [albedo.xyz, depth],
// [normal.xyz, coverage], [colour.xyz, lum] and the noise as a float beside
// them: a tap is three LDS.128 and one LDS.32 where it was 13 strided loads
// from device memory, and a warp reads 32 neighbouring records (no bank
// conflicts).  lum is computed once a pixel, with the plain version's
// expression and order.  The (2r+1)^2 spatial factors are computed once a
// block into a table in shared memory (the same expression, so the same
// bits): one expf and one division fewer a tap.  A factor whose exponent is
// exactly +-0 is skipped, with its expf and division: exp(+-0) = 1 and
// w * 1 = w, so the bits are the same.  That holds where the numerator is
// +-0 and the denominator finite and non-zero: equal albedo, equal normals
// on a flat wall, equal depth or coverage, equal luminance, and the range
// factor wherever the noise is +inf (disabled).  Plain coalesced loads fill
// the tile: cp.async cannot form the records (the 12-byte pixels are
// repacked and lum computed on the way), a radius-0 launch (the staging,
// one tap, the stores) runs at about three quarters of the bytes bound, and
// the other blocks resident on the SM compute while one stages; TMA's
// out-of-bounds fill is zero, not the edge clamp.
// Two or four pixels a thread (their taps interleaved), a taller tile, the
// compiler's division fast path with the shared divisors' reciprocals taken
// once, and one expf of the summed exponents (not bit-equal) were timed
// beside it on the card: slower, or within a few per cent on one input and
// slower on the other (PERF.md, section 6).
//
// denoise_first, the first design, serves a radius whose tile and halo do
// not fit the shared memory a block may use (227 KB on an H100: r >= 24):
// one thread a pixel, each neighbour's guides read from device memory
// through L1 / L2, every factor computed.
//
// What bounds it on an H100: by bytes, 48 B of inputs and 12 B of output a
// pixel (60 B x 2,073,600 pixels at 1080p: 124 MB, 0.037 ms at 3.35 TB/s);
// by operations, ~50 float operations and 6 exponentials a tap, 25 taps at
// radius 2 and 81 at radius 4 (chip_smoke.py counts them beside the time).
// What holds it back is the bit-equal arithmetic, which the SMs issue at
// 128 thread-instructions a cycle: an accurate expf is eight instructions
// around its MUFU.EX2, an IEEE division nine around its MUFU.RCP with a check
// and a branch to its slow path; the tap loop holds ~200 instructions, the
// slow paths included (chip_smoke.py counts them from the SASS).
//
// Parity: built with --fmad=false, IEEE division, no fast-math: expf is the
// accurate one (within 2 ulp), as PyTorch's CUDA exp calls it, so both
// kernels and the plain version on the card agree to the last bits; the
// plain version on the CPU and the JAX package's differ from it by the exp
// libraries' ulps (tolerances in tests/test_torch_denoise.py and
// chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32, kTileY = 8;     // the tile kernel's tile, a pixel a thread
constexpr int kBlockX = 32, kBlockY = 4;  // the first design's block

__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float max_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }
// Rec.709 luminance (denoise._LUM), in the plain version's order
__device__ __forceinline__ float lum3(float c0, float c1, float c2) {
    return 0.2126f * c0 + 0.7152f * c1 + 0.0722f * c2;
}
// a finite, non-zero denominator: 0 / d is then +-0, and exp(+-0) = 1
__device__ __forceinline__ bool plain_den(float d) { return isfinite(d) && d != 0.0f; }

struct Sigmas {
    float spatial, albedo, normal, depth, k_noise;
};

// the denominators, as the plain version forms them from the sigmas
struct Dens {
    float two_ss, two_sa, sn, two_sd, k;
    __device__ explicit Dens(const Sigmas& sg)
        : two_ss(2.0f * sg.spatial * sg.spatial),
          two_sa(2.0f * sg.albedo * sg.albedo),
          sn(clamp_min(sg.normal, 1e-6f)),
          two_sd(2.0f * sg.depth * sg.depth),
          k(sg.k_noise) {}
};

__global__ void __launch_bounds__(kBlockX* kBlockY)
    denoise_first(const float* __restrict__ colors, const float* __restrict__ albedo,
                  const float* __restrict__ normal, const float* __restrict__ depth,
                  const float* __restrict__ coverage, const float* __restrict__ noise, int H,
                  int W, int r, Sigmas sg, float* __restrict__ out) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t p = (size_t)y * W + x;
    const float a0 = __ldg(albedo + 3 * p), a1 = __ldg(albedo + 3 * p + 1),
                a2 = __ldg(albedo + 3 * p + 2);
    const float n0 = __ldg(normal + 3 * p), n1 = __ldg(normal + 3 * p + 1),
                n2 = __ldg(normal + 3 * p + 2);
    const float z = __ldg(depth + p), cov = __ldg(coverage + p), sig_c = __ldg(noise + p);
    const float lum = lum3(__ldg(colors + 3 * p), __ldg(colors + 3 * p + 1), __ldg(colors + 3 * p + 2));
    const float z_scale = clamp_min(fabsf(z), 1e-3f);
    const Dens dn(sg);
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const size_t row = (size_t)clampi(y + dy, H - 1) * W;
        for (int dx = -r; dx <= r; ++dx) {
            const size_t q = row + clampi(x + dx, W - 1);
            float w = expf((float)(-(dx * dx + dy * dy)) / dn.two_ss);
            const float da0 = __ldg(albedo + 3 * q) - a0, da1 = __ldg(albedo + 3 * q + 1) - a1,
                        da2 = __ldg(albedo + 3 * q + 2) - a2;
            const float dalb = (da0 * da0 + da1 * da1) + da2 * da2;
            w = w * expf(-dalb / dn.two_sa);
            const float ndot = (__ldg(normal + 3 * q) * n0 + __ldg(normal + 3 * q + 1) * n1) +
                               __ldg(normal + 3 * q + 2) * n2;
            w = w * expf(-(1.0f - ndot) / dn.sn);
            const float dz = (__ldg(depth + q) - z) / z_scale;
            w = w * expf(-(dz * dz) / dn.two_sd);
            w = w * expf(-8.0f * fabsf(__ldg(coverage + q) - cov));
            const float sig = dn.k * clamp_min(max_nan(__ldg(noise + q), sig_c), 1e-20f);
            const float c0 = __ldg(colors + 3 * q), c1 = __ldg(colors + 3 * q + 1),
                        c2 = __ldg(colors + 3 * q + 2);
            const float dl = (lum3(c0, c1, c2) - lum) / sig;
            w = w * expf(-0.5f * dl * dl);
            acc0 = acc0 + c0 * w;
            acc1 = acc1 + c1 * w;
            acc2 = acc2 + c2 * w;
            wsum = wsum + w;
        }
    }
    const float d = clamp_min(wsum, 1e-20f);
    out[3 * p] = acc0 / d;
    out[3 * p + 1] = acc1 / d;
    out[3 * p + 2] = acc2 / d;
}

// Dynamic shared memory of a tile kernel's block: the three record planes
// and the noise of the tile with its halo, and the spatial table.
__host__ __device__ inline size_t tile_smem(int r) {
    const size_t n = (size_t)(kTileX + 2 * r) * (kTileY + 2 * r);
    const size_t d = 2 * (size_t)r + 1;
    return n * (3 * sizeof(float4) + sizeof(float)) + d * d * sizeof(float);
}

__global__ void __launch_bounds__(kTileX* kTileY)
    denoise_tile(const float* __restrict__ colors, const float* __restrict__ albedo,
                 const float* __restrict__ normal, const float* __restrict__ depth,
                 const float* __restrict__ coverage, const float* __restrict__ noise, int H,
                 int W, int r, Sigmas sg, float* __restrict__ out) {
    extern __shared__ float4 smem[];
    const int SW = kTileX + 2 * r, n = SW * (kTileY + 2 * r), d = 2 * r + 1;
    float4* s_alb = smem;        // [albedo.xyz, depth]
    float4* s_nrm = s_alb + n;   // [normal.xyz, coverage]
    float4* s_col = s_nrm + n;   // [colour.xyz, lum]
    float* s_noise = reinterpret_cast<float*>(s_col + n);
    float* s_spat = s_noise + n;  // the (2r+1)^2 spatial factors, dy-major
    const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileX + tx;
    const Dens dn(sg);
    for (int i = tid; i < n; i += kTileX * kTileY) {
        const int hy = i / SW, hx = i - hy * SW;
        const size_t q = (size_t)clampi(y0 - r + hy, H - 1) * W + clampi(x0 - r + hx, W - 1);
        const float c0 = __ldg(colors + 3 * q), c1 = __ldg(colors + 3 * q + 1),
                    c2 = __ldg(colors + 3 * q + 2);
        s_alb[i] = make_float4(__ldg(albedo + 3 * q), __ldg(albedo + 3 * q + 1),
                               __ldg(albedo + 3 * q + 2), __ldg(depth + q));
        s_nrm[i] = make_float4(__ldg(normal + 3 * q), __ldg(normal + 3 * q + 1),
                               __ldg(normal + 3 * q + 2), __ldg(coverage + q));
        s_col[i] = make_float4(c0, c1, c2, lum3(c0, c1, c2));
        s_noise[i] = __ldg(noise + q);
    }
    for (int i = tid; i < d * d; i += kTileX * kTileY) {
        const int dy = i / d - r, dx = i - (i / d) * d - r;
        s_spat[i] = expf((float)(-(dx * dx + dy * dy)) / dn.two_ss);
    }
    __syncthreads();

    const int k0 = (ty + r) * SW + tx + r;  // the centre's records
    const float4 A0 = s_alb[k0], N0 = s_nrm[k0], C0 = s_col[k0];
    const float sig_c = s_noise[k0], z_scale = clamp_min(fabsf(A0.w), 1e-3f);
    // where a +-0 numerator gives a +-0 exponent: a finite, non-zero denominator
    const bool sa_ok = plain_den(dn.two_sa), sn_ok = plain_den(dn.sn),
               sd_ok = plain_den(dn.two_sd) && plain_den(z_scale);
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
    for (int dy = 0; dy < d; ++dy) {
        for (int dx = 0; dx < d; ++dx) {
            const int k = (ty + dy) * SW + tx + dx;  // the tap (dy - r, dx - r)
            const float4 A = s_alb[k], N = s_nrm[k], C = s_col[k];
            float w = s_spat[dy * d + dx];
            const float da0 = A.x - A0.x, da1 = A.y - A0.y, da2 = A.z - A0.z;
            const float dalb = (da0 * da0 + da1 * da1) + da2 * da2;
            if (!(dalb == 0.0f && sa_ok)) w = w * expf(-dalb / dn.two_sa);
            const float ndot = (N.x * N0.x + N.y * N0.y) + N.z * N0.z;
            if (!(ndot == 1.0f && sn_ok)) w = w * expf(-(1.0f - ndot) / dn.sn);
            const float ddz = A.w - A0.w;
            if (!(ddz == 0.0f && sd_ok)) {
                const float dz = ddz / z_scale;
                w = w * expf(-(dz * dz) / dn.two_sd);
            }
            const float dcov = N.w - N0.w;
            if (dcov != 0.0f) w = w * expf(-8.0f * fabsf(dcov));
            const float sig = dn.k * clamp_min(max_nan(s_noise[k], sig_c), 1e-20f);
            const float dlum = C.w - C0.w;
            // dl is +-0 where the luminances are equal, or the noise is +inf
            // (the range factor disabled) and their difference finite
            if (!(sig == sig && sig != 0.0f &&
                  (dlum == 0.0f || (isinf(sig) && isfinite(dlum))))) {
                const float dl = dlum / sig;
                w = w * expf(-0.5f * dl * dl);
            }
            acc0 = acc0 + C.x * w;
            acc1 = acc1 + C.y * w;
            acc2 = acc2 + C.z * w;
            wsum = wsum + w;
        }
    }
    const int x = x0 + tx, y = y0 + ty;
    if (x < W && y < H) {
        const size_t p = (size_t)y * W + x;
        const float dd = clamp_min(wsum, 1e-20f);
        out[3 * p] = acc0 / dd;
        out[3 * p + 1] = acc1 / dd;
        out[3 * p + 2] = acc2 / dd;
    }
}

struct Args {
    const float *colors, *albedo, *normal, *depth, *coverage, *noise;
    int H, W, r;
    Sigmas sg;
    float* out;
};

int launch_first(const Args& a, cudaStream_t s) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((unsigned)((a.W + kBlockX - 1) / kBlockX),
                    (unsigned)((a.H + kBlockY - 1) / kBlockY));
    denoise_first<<<grid, block, 0, s>>>(a.colors, a.albedo, a.normal, a.depth, a.coverage,
                                         a.noise, a.H, a.W, a.r, a.sg, a.out);
    return (int)cudaGetLastError();
}

int launch_tile(const Args& a, cudaStream_t s) {
    const size_t smem = tile_smem(a.r);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            denoise_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 block(kTileX, kTileY);
    const dim3 grid((unsigned)((a.W + kTileX - 1) / kTileX),
                    (unsigned)((a.H + kTileY - 1) / kTileY));
    denoise_tile<<<grid, block, smem, s>>>(a.colors, a.albedo, a.normal, a.depth, a.coverage,
                                           a.noise, a.H, a.W, a.r, a.sg, a.out);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes; `design` as ops/cuda_denoise.DESIGNS: 0 the
// first design, 1 the tile kernel.

// Bytes of dynamic shared memory a block of `design` takes at `radius` (0
// for the first design; -1 for an unknown design or a negative radius).
extern "C" long long pt_denoise_smem(int design, int radius) {
    if (design < 0 || design > 1 || radius < 0) return -1;
    return design == 1 ? (long long)tile_smem(radius) : 0;
}

// The most dynamic shared memory a block may take on the current device.
extern "C" long long pt_denoise_smem_limit() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
        return -1;
    return bytes;
}

// Launches `design` on `stream`, does not synchronise, allocates nothing.
// colors, albedo, normal, out: (H, W, 3) f32; depth, coverage, noise: (H, W)
// f32 (noise +inf disables the range factor). Returns the launch's
// cudaError_t (0 = accepted), -2 for a negative radius or an unknown design.
extern "C" int pt_denoise(const void* colors, const void* albedo, const void* normal,
                          const void* depth, const void* coverage, const void* noise, int H,
                          int W, int radius, float sigma_spatial, float sigma_albedo,
                          float sigma_normal, float sigma_depth, float k_noise, void* out,
                          int design, void* stream) {
    if (radius < 0 || design < 0 || design > 1) return -2;
    if (H <= 0 || W <= 0) return 0;
    const Args a = {(const float*)colors, (const float*)albedo, (const float*)normal,
                    (const float*)depth, (const float*)coverage, (const float*)noise,
                    H, W, radius,
                    {sigma_spatial, sigma_albedo, sigma_normal, sigma_depth, k_noise},
                    (float*)out};
    return (design == 1 ? launch_tile : launch_first)(a, (cudaStream_t)stream);
}
