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


def _held_to_jax(scenes, rows, keys):
    """The port's radiance on ``rows`` against JAX's, every value within the
    bars' rtol: ``rows`` go into the first lanes of ``keys``, so the JAX
    function compiled for that many lanes is reused, and only those lanes are
    judged."""
    keys = keys.astype(np.int32)
    keys[: len(rows)] = rows
    got = _torch_radiance(scenes[0], keys)[: len(rows)]
    ref = _jax_radiance(scenes[1], keys)[: len(rows)]
    assert np.isfinite(got).all()
    rel = rel_err(got, ref, 1e-3)
    assert rel.max() < 5e-4, rel


def _bars(got, ref):
    rel = rel_err(got, ref, 1e-3)
    assert np.quantile(rel, 0.995) < 5e-4, np.quantile(rel, 0.995)
    assert np.median(rel) < 1e-5, np.median(rel)


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return scene_device_from_golden(g, device="cpu"), jgolden.scene_device_from_golden(g)


@pytest.fixture(scope="module")
def motion():
    """motion.gold's scene: 4 subframe rows whose light and TLAS rows differ
    (the golden scene's 32 rows are all equal), 8 samples per subframe."""
    g = golden("motion.gold")
    return (
        scene_device_from_motion_golden(g, device="cpu"),
        jgolden.scene_device_from_motion_golden(g),
        g,
    )


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
    tg = golden("trace.gold")
    keys = tg["keys"]
    got, ref = _torch_radiance(scenes[0], keys), _jax_radiance(scenes[1], keys)
    _bars(got, ref)
    # where the port and JAX differ (XLA contracts FMAs; the oracle was built
    # without: inv_erf, the hemisphere's z, the sky's heights), the port
    # follows the oracle. Measured: bit-equal to it on 59.0 % of the values
    # against JAX's 26.9 %, and of the values where the two packages differ
    # the port is the closer on 81 %, JAX on 16 %.
    oracle = tg["radiance"]
    assert (got == oracle).mean() >= 0.5
    assert (got == oracle).mean() >= 2 * (ref == oracle).mean()
    differ = got != ref
    closer = np.abs(got - oracle)[differ] < np.abs(ref - oracle)[differ]
    assert closer.mean() >= 0.7, closer.mean()


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


def test_motion_blur_subframes_match_oracle_and_jax(motion):
    g = motion[2]
    got = _torch_radiance(motion[0], g["keys"])
    _bars(got, g["radiance"])
    _bars(got, _jax_radiance(motion[1], g["keys"]))


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


def test_negative_sample_index_uses_subframe0(motion):
    """sample_index < 0 => subframe 0 (reference: path_tracer.hh:655-657):
    equal to the JAX package's sample on a scene whose subframe rows differ,
    and finite."""
    _held_to_jax(motion, [[320, 180, -1], [100, 50, -7], [200, 90, -9]], motion[2]["keys"])


def test_production_config_runs_and_subframe_rows_bound(scenes, motion):
    """PRODUCTION preset (5 bounces) on a tiny batch; the golden scene has 32
    subframe rows, so sample_index < 256 stays in range, and one past them
    stays finite. A sample past the rows reads the last one, as XLA's gather
    clamps: equal to the JAX package's sample on motion.gold's 4 differing
    rows (sample 32 is the first past them)."""
    import dataclasses

    cfg = dataclasses.replace(PRODUCTION, image_width=640, image_height=360)
    keys = np.array([[100, 100, 0], [200, 200, 255], [1, 1, 256]], np.int32)
    assert np.isfinite(_torch_radiance(scenes[0], keys, cfg)).all()
    past = [[1, 1, 32], [320, 180, 40], [100, 100, 256], [500, 300, 300]]
    _held_to_jax(motion, past, motion[2]["keys"])


@pytest.mark.parametrize(
    "kw", [{"query_shade": lambda *a: None, "lit": True}, {"record": True, "lit": True},
           {"replay": ((), ()), "lit": True},
           {"query_shade": lambda *a: None, "record": True}]
)
def test_later_slices_raise(scenes, kw):
    """What the JAX package refuses, the port refuses (NotImplementedError):
    a query_shade override on a scene with area-light tables, record/replay
    with light tables, and record/replay under an override (the override
    itself is ported: tests/test_torch_geomshard.py)."""
    kw = dict(kw)
    scene = scenes[0]
    if kw.pop("lit", False):
        scene = scene._replace(lt_tris=torch.zeros((1, 9)))
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        path_trace_samples(TESTING, scene, z, z, z, **kw)
