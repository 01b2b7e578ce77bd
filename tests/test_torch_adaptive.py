"""The port's adaptive sampling (adaptive.py) vs the JAX package's, on the
CPU.

``allocate_samples`` equal to JAX's on seeded variance arrays (numpy on
both sides); ``render_adaptive`` with no extra budget and with an explicit
``alloc`` bit-equal to the uniform sample ranges it adds up; the
variance-guided budget spent and never above it; ``render_with_variance``
against one JAX call at the JAX package's bar for path sums (>= 97 % of
pixels within 2e-4 + 2e-4 |ref| on colours and on the standard error)."""

import dataclasses

import numpy as np
import pytest

from pathtracing_tpu.adaptive import allocate_samples as jax_allocate
from pathtracing_tpu.adaptive import render_with_variance as jax_render_with_variance
from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu_torch.adaptive import (
    allocate_samples,
    render_adaptive,
    render_with_variance,
)
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.render import render_pixels
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden

import golden_scene as jgolden

TWO_BOUNCES = dataclasses.replace(TESTING, max_bounces=2)


@pytest.fixture(scope="module")
def scene():
    return scene_device_from_golden(golden("scene.gold"), TESTING, device="cpu")


def _grid(w=20, h=12):
    idx = np.arange(w * h, dtype=np.int32)
    return (idx % w) * (640 // w), (idx // w) * (360 // h)


@pytest.mark.parametrize("case", ["gamma", "zeros", "nan", "capped", "tiny_budget"])
def test_allocate_samples_matches_jax(case):
    rng = np.random.default_rng(11)
    var, budget, cap = rng.gamma(0.7, 2.0, 4096), 4096 * 6, None
    if case == "zeros":
        var = np.zeros(1000)
    elif case == "nan":
        var[::7] = np.nan
    elif case == "capped":
        cap = 8
    elif case == "tiny_budget":
        budget = 37
    got = allocate_samples(var, budget, max_extra=cap)
    ref = jax_allocate(var, budget, max_extra=cap)
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert got.sum() <= budget


def test_adaptive_equals_uniform_ranges(scene):
    """No extra budget: the uniform render, bit for bit; an explicit alloc
    of 2 everywhere: samples [0, 2) + [2, 4), bit for bit (2 bounces: the
    scan runs eagerly on the CPU)."""
    xs, ys = _grid()
    c, cnt = render_adaptive(TWO_BOUNCES, scene, xs, ys, 2, 2, tile_pixels=len(xs),
                             device="cpu")
    u = render_pixels(TWO_BOUNCES, scene, xs, ys, spp=2, tile_pixels=len(xs), device="cpu")
    assert (cnt == 2).all() and c.tobytes() == u.tobytes()
    # the wavefront's statistics pass (K5's plain version here): the same sums
    cw, _ = render_adaptive(TWO_BOUNCES, scene, xs, ys, 2, 2, tile_pixels=len(xs),
                            wavefront=True, device="cpu")
    assert cw.tobytes() == c.tobytes()
    alloc = np.full(len(xs), 2, np.int32)
    c4, cnt4 = render_adaptive(TWO_BOUNCES, scene, xs, ys, 2, 4, tile_pixels=len(xs),
                               alloc=alloc, device="cpu")
    parts = [render_pixels(TWO_BOUNCES, scene, xs, ys, spp=2, sample_base=a, average=False,
                           tile_pixels=len(xs), device="cpu") for a in (0, 2)]
    assert (cnt4 == 4).all()
    assert c4.tobytes() == ((parts[0] + parts[1]) / np.float32(4)).tobytes()
    # variance-guided: the budget is spent where the variance is, within it
    timings = {}
    ca, na = render_adaptive(TWO_BOUNCES, scene, xs, ys, 2, 3, tile_pixels=len(xs),
                             device="cpu", timings=timings)
    assert na.sum() <= 3 * len(xs) and na.max() > 2 and np.isfinite(ca).all()
    assert set(timings) == {"pass1_s", "pass2_s"}
    with pytest.raises(ValueError, match="spp_base"):
        render_adaptive(TWO_BOUNCES, scene, xs, ys, 0, 4, device="cpu")


def test_render_with_variance_matches_jax(scene):
    xs, ys = _grid()
    colors, stderr = render_with_variance(TESTING, scene, xs, ys, spp=2, device="cpu")
    js = jgolden.scene_device_from_golden(golden("scene.gold"))
    jcolors, jstderr = jax_render_with_variance(JTESTING, js, xs, ys, spp=2)
    for got, ref in ((colors, jcolors), (stderr, jstderr)):
        assert got.dtype == np.float32 and got.shape == ref.shape
        close = np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref)
        assert close.reshape(len(xs), -1).all(-1).mean() >= 0.97
    assert (stderr >= 0).all() and stderr.max() > 0
