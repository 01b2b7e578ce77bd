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
// Design: one thread per pixel, its taps in a loop; the centre's guides in
// registers, each neighbour's read from device memory (the image's rows are
// shared by the neighbouring threads through L1 / L2).  No shared-memory
// tiling yet: a simple kernel that is right first.
//
// What bounds it on an H100: by bytes, 48 B of inputs and 12 B of output a
// pixel (60 B x 2,073,600 pixels at 1080p: 124 MB, 0.037 ms at 3.35 TB/s);
// by operations, ~50 float operations and 6 exponentials a tap, 25 taps at
// radius 2 and 81 at radius 4 (chip_smoke.py counts them beside the time).
//
// Parity: built with --fmad=false, IEEE division, no fast-math: expf is the
// accurate one (within 2 ulp), as PyTorch's CUDA exp calls it, so the kernel
// and the plain version on the card agree to the last bits; the plain
// version on the CPU and the JAX package's differ from it by the exp
// libraries' ulps (tolerances in tests/test_torch_denoise.py and
// chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 4;

__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float max_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }
// Rec.709 luminance (denoise._LUM), in the plain version's order
__device__ __forceinline__ float lum3(const float* __restrict__ c) {
    return 0.2126f * __ldg(c + 0) + 0.7152f * __ldg(c + 1) + 0.0722f * __ldg(c + 2);
}

struct Sigmas {
    float spatial, albedo, normal, depth, k_noise;
};

__global__ void __launch_bounds__(kBlockX* kBlockY)
    denoise_kernel(const float* __restrict__ colors, const float* __restrict__ albedo,
                   const float* __restrict__ normal, const float* __restrict__ depth,
                   const float* __restrict__ coverage, const float* __restrict__ noise,
                   int H, int W, int r, Sigmas sg, float* __restrict__ out) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t p = (size_t)y * W + x;
    const float a0 = __ldg(albedo + 3 * p), a1 = __ldg(albedo + 3 * p + 1),
                a2 = __ldg(albedo + 3 * p + 2);
    const float n0 = __ldg(normal + 3 * p), n1 = __ldg(normal + 3 * p + 1),
                n2 = __ldg(normal + 3 * p + 2);
    const float z = __ldg(depth + p), cov = __ldg(coverage + p), sig_c = __ldg(noise + p);
    const float lum = lum3(colors + 3 * p);
    const float z_scale = clamp_min(fabsf(z), 1e-3f);
    // the denominators, as the plain version forms them from the sigmas
    const float two_ss = 2.0f * sg.spatial * sg.spatial;
    const float two_sa = 2.0f * sg.albedo * sg.albedo;
    const float sn = clamp_min(sg.normal, 1e-6f);
    const float two_sd = 2.0f * sg.depth * sg.depth;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const size_t row = (size_t)clampi(y + dy, H - 1) * W;
        for (int dx = -r; dx <= r; ++dx) {
            const size_t q = row + clampi(x + dx, W - 1);
            float w = expf((float)(-(dx * dx + dy * dy)) / two_ss);
            const float da0 = __ldg(albedo + 3 * q) - a0, da1 = __ldg(albedo + 3 * q + 1) - a1,
                        da2 = __ldg(albedo + 3 * q + 2) - a2;
            const float dalb = (da0 * da0 + da1 * da1) + da2 * da2;
            w = w * expf(-dalb / two_sa);
            const float ndot = (__ldg(normal + 3 * q) * n0 + __ldg(normal + 3 * q + 1) * n1) +
                               __ldg(normal + 3 * q + 2) * n2;
            w = w * expf(-(1.0f - ndot) / sn);
            const float dz = (__ldg(depth + q) - z) / z_scale;
            w = w * expf(-(dz * dz) / two_sd);
            w = w * expf(-8.0f * fabsf(__ldg(coverage + q) - cov));
            const float sig = sg.k_noise * clamp_min(max_nan(__ldg(noise + q), sig_c), 1e-20f);
            const float dl = (lum3(colors + 3 * q) - lum) / sig;
            w = w * expf(-0.5f * dl * dl);
            acc0 = acc0 + __ldg(colors + 3 * q) * w;
            acc1 = acc1 + __ldg(colors + 3 * q + 1) * w;
            acc2 = acc2 + __ldg(colors + 3 * q + 2) * w;
            wsum = wsum + w;
        }
    }
    const float d = clamp_min(wsum, 1e-20f);
    out[3 * p] = acc0 / d;
    out[3 * p + 1] = acc1 / d;
    out[3 * p + 2] = acc2 / d;
}

}  // namespace

// Plain C interface for ctypes.  Launches on `stream`, does not synchronise,
// allocates nothing.  colors, albedo, normal, out: (H, W, 3) f32; depth,
// coverage, noise: (H, W) f32 (noise +inf disables the range factor).
// Returns the launch's cudaError_t (0 = accepted), -2 for a negative radius.
extern "C" int pt_denoise(const void* colors, const void* albedo, const void* normal,
                          const void* depth, const void* coverage, const void* noise, int H,
                          int W, int radius, float sigma_spatial, float sigma_albedo,
                          float sigma_normal, float sigma_depth, float k_noise, void* out,
                          void* stream) {
    if (radius < 0) return -2;
    if (H <= 0 || W <= 0) return 0;
    const Sigmas sg = {sigma_spatial, sigma_albedo, sigma_normal, sigma_depth, k_noise};
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((unsigned)((W + kBlockX - 1) / kBlockX), (unsigned)((H + kBlockY - 1) / kBlockY));
    denoise_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)colors, (const float*)albedo, (const float*)normal, (const float*)depth,
        (const float*)coverage, (const float*)noise, H, W, radius, sg, (float*)out);
    return (int)cudaGetLastError();
}
