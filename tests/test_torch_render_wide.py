"""The wide slice as a whole: ``path_trace_samples`` and ``render_frame`` on a
scene packed with ``wide=True`` vs the JAX package's on its wide scene, and
vs the port's own frame on the binary tables.

Bars against JAX, as tests/test_torch_render.py and
tests/test_torch_integrator.py: per-sample radiance 0.995-quantile of the
relative error < 5e-4, median < 1e-5; 64x36 frame at spp 2: 0.98-quantile of
the per-channel relative error < 1e-3, BGRA bytes within 1 LSB on >= 98 % of
pixels. Against the port's binary frame: bit-equal, for every layout — the
wide walk confirms the same candidates in the same order, and neither side
contracts an FMA."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracing_tpu import render as jrender
from pathtracing_tpu.config import RenderConfig as JRenderConfig
from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.ops.integrator import path_trace_samples as jax_path_trace_samples
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import integrator as tinteg
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, rel_err, stack, t

import golden_scene as jgolden

CFG = dataclasses.replace(
    TESTING, image_width=64, image_height=36, samples_per_pixel=2
)
LAYOUTS = ("w8", "w16", "s8")


@pytest.fixture(scope="module")
def binary_frame():
    tscene = scene_device_from_golden(golden("scene.gold"), CFG, device="cpu")
    return trender.render_frame(CFG, tscene, device="cpu")


_WIDE_FRAMES = {}  # layout -> (colors, image, ray queries that saw wide tables)


def _wide_frame(layout):
    """The port's frame on the scene packed in ``layout``, rendered once per
    module (the JAX comparison below reuses the w8 one)."""
    if layout not in _WIDE_FRAMES:
        calls = []
        orig = tinteg.ray_query

        def spy(scene, *a, **k):
            calls.append(scene.wide_rows is not None)
            return orig(scene, *a, **k)

        wscene = scene_device_from_golden(
            golden("scene.gold"), CFG, wide=True, wide_layout=layout, device="cpu"
        )
        tinteg.ray_query = spy
        try:
            colors, image = trender.render_frame(CFG, wscene, device="cpu")
        finally:
            tinteg.ray_query = orig
        _WIDE_FRAMES[layout] = colors, image, calls
    return _WIDE_FRAMES[layout]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wide_frame_bit_equal_to_binary_frame(binary_frame, layout):
    colors, image, calls = _wide_frame(layout)
    assert calls and all(calls)  # every query saw the wide tables
    assert len(calls) == CFG.samples_per_pixel * (1 + CFG.max_bounces)
    bcolors, bimage = binary_frame
    assert colors.tobytes() == bcolors.tobytes()
    assert image.tobytes() == bimage.tobytes()


def test_wide_frame_matches_jax_wide_frame():
    g = golden("scene.gold")
    jcfg = JRenderConfig(**dataclasses.asdict(CFG))
    jscene = jgolden.scene_device_from_golden(g, jcfg, wide=True)
    assert jscene.wide_rows is not None
    jcolors, jimage = jrender.render_frame(jcfg, jscene, tile_pixels=64 * 36)
    jcolors, jimage = np.asarray(jcolors), np.asarray(jimage)
    # the port's frame on the same packing (w8, pack_scene's default)
    tcolors, timage, _ = _wide_frame("w8")
    assert tcolors.shape == jcolors.shape == (36, 64, 3) and np.isfinite(tcolors).all()
    rel = rel_err(tcolors, jcolors, 1e-3)
    assert np.quantile(rel, 0.98) < 1e-3, np.quantile(rel, 0.98)
    lsb = np.abs(timage.astype(int) - jimage.astype(int)).max(axis=-1)
    assert (lsb <= 1).mean() >= 0.98, (lsb <= 1).mean()


def test_wide_per_sample_radiance_matches_jax_and_oracle():
    g, tg = golden("scene.gold"), golden("trace.gold")
    keys = tg["keys"][:1024]
    cols = [keys[:, i].astype(np.int32) for i in range(3)]
    wscene = scene_device_from_golden(g, wide=True, device="cpu")
    got = stack(path_trace_samples(TESTING, wscene, *(t(c) for c in cols)))
    jscene = jgolden.scene_device_from_golden(g, wide=True)
    ref = stack(jax.jit(functools.partial(jax_path_trace_samples, JTESTING))(
        jscene, *(jnp.asarray(c) for c in cols)
    ))
    for want in (ref, tg["radiance"][:1024]):
        rel = rel_err(got, want, 1e-3)
        assert np.quantile(rel, 0.995) < 5e-4, np.quantile(rel, 0.995)
        assert np.median(rel) < 1e-5, np.median(rel)
    # and the port's binary scene gives the same samples bit for bit
    bscene = scene_device_from_golden(g, device="cpu")
    same = stack(path_trace_samples(TESTING, bscene, *(t(c) for c in cols)))
    assert got.tobytes() == same.tobytes()
