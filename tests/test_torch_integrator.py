"""Port's ``path_trace_samples`` vs the C++ oracle's per-sample radiance and
vs the JAX package's, at the oracle bars of tests/test_integrator.py:
0.995-quantile of the relative error < 5e-4, median < 1e-5. A small share of
samples legitimately diverges: a hit t moved by a few ulps flips a hit/miss
decision on a grazing secondary ray; those paths are unbiased noise."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.ops.integrator import path_trace_samples as jax_path_trace_samples
from pathtracing_tpu.ops.tonemap import tonemap as jax_tonemap
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.config import PRODUCTION, TESTING
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.tonemap import tonemap
from pathtracing_tpu_torch.scene.golden import (
    scene_device_from_golden,
    scene_device_from_motion_golden,
)
from pathtracing_tpu_torch.testing import golden, n, rel_err, stack, t, vec3_t

import golden_scene as jgolden


def _torch_radiance(scene, keys, config=TESTING):
    out = path_trace_samples(
        config, scene, *(t(keys[:, i].astype(np.int32)) for i in range(3))
    )
    return stack(out)


# one compiled function for every scene of the same table shapes
_jax_fn = jax.jit(functools.partial(jax_path_trace_samples, JTESTING))


def _jax_radiance(jscene, keys):
    out = _jax_fn(jscene, *(jnp.asarray(keys[:, i].astype(np.int32)) for i in range(3)))
    return stack(out)


def _bars(got, ref):
    rel = rel_err(got, ref, 1e-3)
    assert np.quantile(rel, 0.995) < 5e-4, np.quantile(rel, 0.995)
    assert np.median(rel) < 1e-5, np.median(rel)


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return scene_device_from_golden(g, device="cpu"), jgolden.scene_device_from_golden(g)


def _bokeh(sf_cam: np.ndarray) -> np.ndarray:
    cam = sf_cam.copy()
    cam[:, 17] = 0.3          # aperture_radius
    cam[:, 14] = 10.0         # focal_distance
    cam[:, 15] = np.float32(np.pi / 7)  # aperture_angle
    return cam


def test_per_sample_radiance_matches_oracle(scenes):
    tg = golden("trace.gold")
    _bars(_torch_radiance(scenes[0], tg["keys"]), tg["radiance"])


def test_per_sample_radiance_matches_jax(scenes):
    keys = golden("trace.gold")["keys"]
    _bars(_torch_radiance(scenes[0], keys), _jax_radiance(scenes[1], keys))


def test_bokeh_aperture_matches_oracle(scenes):
    tg = golden("trace.gold")
    bscene = scenes[0]._replace(sf_cam=t(_bokeh(n(scenes[0].sf_cam))))
    _bars(_torch_radiance(bscene, tg["bokeh_keys"]), tg["bokeh_radiance"])


def test_bokeh_aperture_matches_jax(scenes):
    keys = golden("trace.gold")["bokeh_keys"]
    cam = _bokeh(n(scenes[0].sf_cam))
    got = _torch_radiance(scenes[0]._replace(sf_cam=t(cam)), keys)
    ref = _jax_radiance(scenes[1]._replace(sf_cam=jnp.asarray(cam)), keys)
    _bars(got, ref)


def test_motion_blur_subframes_match_oracle_and_jax():
    g = golden("motion.gold")
    got = _torch_radiance(scene_device_from_motion_golden(g, device="cpu"), g["keys"])
    _bars(got, g["radiance"])
    _bars(got, _jax_radiance(jgolden.scene_device_from_motion_golden(g), g["keys"]))


def test_tonemap_bytes_match_oracle_and_jax():
    tg = golden("trace.gold")
    tin = tg["tonemap_in"]
    got = stack(tonemap(vec3_t(tin)))
    assert got.dtype == np.uint8
    # allow 1 LSB for pow() rounding differences
    assert np.abs(got.astype(int) - tg["tonemap_out"].astype(int)).max() <= 1
    ref = stack(jax_tonemap(JVec3(*(jnp.asarray(tin[:, i]) for i in range(3)))))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # and on a wide random range, vs JAX
    x = np.random.default_rng(0).uniform(0, 8, (4096, 3)).astype(np.float32) ** 2
    got = stack(tonemap(vec3_t(x)))
    ref = stack(jax_tonemap(JVec3(*(jnp.asarray(x[:, i]) for i in range(3)))))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (got[:, 3] == 255).all()


def test_negative_sample_index_uses_subframe0(scenes):
    """sample_index < 0 => subframe 0 (reference: path_tracer.hh:655-657):
    equal to the JAX package's sample, and finite."""
    keys = np.array([[320, 180, -1], [100, 50, -7]], np.int32)
    got = _torch_radiance(scenes[0], keys)
    assert np.isfinite(got).all()
    _bars(got, _jax_radiance(scenes[1], keys))


def test_production_config_runs_and_subframe_rows_bound(scenes):
    """PRODUCTION preset (5 bounces) on a tiny batch; the golden scene has 32
    subframe rows, so sample_index < 256 stays in range — and one past the
    rows raises (PyTorch does not clamp an index as XLA does)."""
    import dataclasses

    cfg = dataclasses.replace(PRODUCTION, image_width=640, image_height=360)
    keys = np.array([[100, 100, 0], [200, 200, 255]], np.int32)
    assert np.isfinite(_torch_radiance(scenes[0], keys, cfg)).all()
    with pytest.raises(IndexError):
        _torch_radiance(scenes[0], np.array([[1, 1, 256]], np.int32), cfg)


@pytest.mark.parametrize(
    "kw", [{"query_shade": lambda *a: None}, {"record": True}, {"replay": ((), ())}]
)
def test_later_slices_raise(scenes, kw):
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        path_trace_samples(TESTING, scenes[0], z, z, z, **kw)
