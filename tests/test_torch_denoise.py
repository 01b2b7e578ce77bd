"""The port's joint bilateral denoiser (denoise.py: K8's plain version) vs
the JAX package's ``_denoise``, on the CPU, at odd sizes, radius 1 and 2,
with and without a noise map: within rtol 2e-6, atol 1e-6 max|ref| (the same
operations in the same order; the CPU's exp and XLA's differ in the last
ulps, and XLA fuses multiply-adds). Then the port's own properties:
a flat image passes through, the denoised golden window is nearer a
high-spp reference than the noisy input (tests/test_denoise.py's bar), and
the kernel's wrapper refuses CPU tensors."""

import numpy as np
import pytest
import torch

from pathtracing_tpu.denoise import joint_bilateral_denoise as jax_denoise
from pathtracing_tpu_torch.adaptive import render_with_variance
from pathtracing_tpu_torch.aov import render_aovs
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.denoise import joint_bilateral_denoise
from pathtracing_tpu_torch.ops import cuda_denoise as CD
from pathtracing_tpu_torch.render import render_pixels
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden


def _inputs(H, W, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    colors = rng.gamma(1.0, 0.5, (H, W, 3)).astype(np.float32)
    aovs = {"albedo": rng.random((H, W, 3), np.float32), "normal": nrm,
            "depth": (rng.random((H, W), np.float32) * 5).astype(np.float32),
            "coverage": (rng.random((H, W)) < 0.8).astype(np.float32)}
    aovs["depth"][aovs["coverage"] == 0] = 0.0  # sky: no depth
    noise = (rng.random((H, W), np.float32) * 0.2).astype(np.float32)
    return colors, aovs, noise


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("with_noise", [False, True], ids=["no_noise", "noise"])
def test_denoise_plain_matches_jax(radius, with_noise):
    colors, aovs, noise = _inputs(13, 17)
    kw = dict(noise=noise if with_noise else None, radius=radius)
    got = joint_bilateral_denoise(colors, aovs, device="cpu", **kw)
    ref = jax_denoise(colors, aovs, **kw)
    assert got.shape == (13, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("H,W,radius,with_noise", [
    (1, 1, 2, True),  # every tap past the image: the edge clamp alone
    (5, 7, 0, False),  # the centre tap only
    (5, 7, 1, True),
    (5, 7, 1, False),  # the noise map disabled (+inf)
], ids=["1x1_r2_noise", "5x7_r0_inf", "5x7_r1_noise", "5x7_r1_inf"])
def test_denoise_plain_edge_cases(H, W, radius, with_noise):
    """The edge cases K8 is held to on the card, at the sizes the JAX
    function compiles in about a second each (radius 9 unrolls 361 taps: over
    a minute of XLA compile on the CPU, so it is checked on the card only)."""
    colors, aovs, noise = _inputs(H, W, seed=H * 31 + W)
    kw = dict(noise=noise if with_noise else None, radius=radius)
    got = joint_bilateral_denoise(colors, aovs, device="cpu", **kw)
    ref = jax_denoise(colors, aovs, **kw)
    assert got.shape == (H, W, 3) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6 * np.abs(ref).max())


def test_denoise_flat_region_and_wrapper():
    H, W = 36, 64
    colors = np.full((H, W, 3), 0.25, np.float32)
    aovs = {"albedo": np.full((H, W, 3), 0.5, np.float32),
            "normal": np.tile(np.array([0, 0, 1], np.float32), (H, W, 1)),
            "depth": np.full((H, W), 3.0, np.float32),
            "coverage": np.ones((H, W), np.float32)}
    out = joint_bilateral_denoise(colors, aovs, device="cpu")
    np.testing.assert_allclose(out, colors, rtol=1e-5, atol=1e-6)
    # the kernel's wrapper: CUDA tensors only, counted where it launches
    before = CD.launches
    c = torch.from_numpy(colors)
    with pytest.raises(ValueError, match="CUDA"):
        CD.denoise_cuda(c, c, c, c[..., 0], c[..., 0], c[..., 0], 2, (2.0, 0.1, 0.05, 0.05, 2.0))
    assert CD.launches == before
    src = CD.SOURCE.parent.parent.joinpath("ops", "cuda_denoise.py").read_text()
    assert "try:" not in src and "denoise_plain(" not in src


def test_denoise_reduces_error():
    """tests/test_denoise.py's workflow on the port: a 2 spp window with its
    noise map and AOVs, denoised with and without the range factor, nearer a
    16 spp reference from a disjoint sample range than the noisy input (a
    32 x 18 window: the scan runs eagerly on the CPU)."""
    scene = scene_device_from_golden(golden("scene.gold"), TESTING, device="cpu")
    W, H, X0, Y0 = 32, 18, 304, 160
    idx = np.arange(W * H, dtype=np.int32)
    xs, ys = X0 + idx % W, Y0 + idx // W
    noisy, stderr = render_with_variance(TESTING, scene, xs, ys, spp=2, tile_pixels=W * H,
                                         device="cpu")
    noisy = noisy.reshape(H, W, 3)
    ref = render_pixels(TESTING, scene, xs, ys, spp=16, sample_base=64, tile_pixels=W * H,
                        device="cpu").reshape(H, W, 3)
    aovs = render_aovs(TESTING, scene, xs, ys, spp=2, tile_pixels=W * H, device="cpu")
    aovs = {k: v.reshape(H, W, -1).squeeze() for k, v in aovs.items()}
    clip = lambda a: np.clip(a, 0, 10)
    mse = lambda a: float(np.mean((clip(a) - clip(ref)) ** 2))
    out = joint_bilateral_denoise(noisy, aovs, device="cpu")
    assert out.shape == noisy.shape and np.isfinite(out).all()
    assert mse(out) < mse(noisy)
    ranged = joint_bilateral_denoise(noisy, aovs, noise=stderr.reshape(H, W), device="cpu")
    assert mse(ranged) < mse(noisy)
