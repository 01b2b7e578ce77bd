"""The slice as a whole: the port's ``render_frame`` vs the JAX package's on
the same scene, a 64x36 frame at spp 2.

Bars: 0.98-quantile of the per-channel relative error < 1e-3 (the bar
tests/test_integrator.py holds a frame to against the oracle); BGRA bytes
within 1 LSB on >= 98 % of pixels (a grazing path that flips changes a whole
pixel at spp 2)."""

import dataclasses

import numpy as np
import pytest

from pathtracing_tpu import render as jrender
from pathtracing_tpu.io.bmp import write_bmp as jax_write_bmp
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.io.bmp import read_bmp, write_bmp
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, rel_err

import golden_scene as jgolden

CFG = dataclasses.replace(
    TESTING, image_width=64, image_height=36, samples_per_pixel=2
)


@pytest.fixture(scope="module")
def frames():
    from pathtracing_tpu.config import RenderConfig as JRenderConfig

    g = golden("scene.gold")
    jcfg = JRenderConfig(**dataclasses.asdict(CFG))
    tscene = scene_device_from_golden(g, CFG, device="cpu")
    tcolors, timage = trender.render_frame(CFG, tscene, device="cpu")
    jcolors, jimage = jrender.render_frame(
        jcfg, jgolden.scene_device_from_golden(g, jcfg), tile_pixels=64 * 36
    )
    return tscene, tcolors, timage, np.asarray(jcolors), np.asarray(jimage)


def test_render_frame_matches_jax(frames):
    _, tcolors, timage, jcolors, jimage = frames
    assert tcolors.shape == jcolors.shape == (36, 64, 3)
    assert tcolors.dtype == np.float32 and np.isfinite(tcolors).all()
    rel = rel_err(tcolors, jcolors, 1e-3)
    assert np.quantile(rel, 0.98) < 1e-3, np.quantile(rel, 0.98)
    assert timage.shape == jimage.shape == (36, 64, 4) and timage.dtype == np.uint8
    lsb = np.abs(timage.astype(int) - jimage.astype(int)).max(axis=-1)
    assert (lsb <= 1).mean() >= 0.98, (lsb <= 1).mean()
    assert (timage[..., 3] == 255).all()


def test_write_bmp_bytes_equal_jax(frames, tmp_path):
    _, _, timage, _, _ = frames
    write_bmp(str(tmp_path / "t.bmp"), timage)
    jax_write_bmp(str(tmp_path / "j.bmp"), timage)
    assert (tmp_path / "t.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
    back = read_bmp(str(tmp_path / "t.bmp"))  # (H, W, 3) RGB
    np.testing.assert_array_equal(back[..., ::-1], timage[..., :3])


def test_sample_ranges_add(frames):
    """average=False: two halves of the sample range sum to the whole
    (the (x, y, sample_index) seeding contract)."""
    tscene, tcolors, _, _, _ = frames
    idx = np.arange(64 * 36, dtype=np.int32)
    xs, ys = idx % 64, idx // 64
    kw = dict(average=False, device="cpu")
    whole = trender.render_pixels(CFG, tscene, xs, ys, spp=2, **kw)
    a = trender.render_pixels(CFG, tscene, xs, ys, spp=1, sample_base=0, **kw)
    b = trender.render_pixels(CFG, tscene, xs, ys, spp=1, sample_base=1, **kw)
    np.testing.assert_array_equal(a + b, whole)
    np.testing.assert_array_equal(whole.reshape(36, 64, 3) / np.float32(2), tcolors)


def test_tiling_does_not_change_the_frame(frames):
    """A ragged last tile (no padding) gives the same pixels as one tile."""
    tscene, tcolors, _, _, _ = frames
    idx = np.arange(64 * 36, dtype=np.int32)
    got = trender.render_pixels(
        CFG, tscene, idx % 64, idx // 64, tile_pixels=1000, device="cpu"
    )
    np.testing.assert_array_equal(got.reshape(36, 64, 3), tcolors)


def test_to_bgra_matches_jax(frames):
    _, tcolors, timage, _, _ = frames
    np.testing.assert_array_equal(trender.to_bgra(tcolors, device="cpu"), timage)
    assert np.abs(
        timage.astype(int) - np.asarray(jrender.to_bgra(tcolors)).astype(int)
    ).max() <= 1
