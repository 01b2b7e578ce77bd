"""Differentiable rendering in the port (``pathtracing_tpu_torch/diff``):
``render_value_and_grad`` against the JAX package's on tests/test_diff.py's
lanes, and the port's own mirrors of tests/test_diff.py (finite gradients,
finite differences, the two sqrt-pole regressions).

One JAX whole-renderer gradient in this file, a module fixture: it compiles
the renderer's backward for about two minutes on a CPU. Everything else
holds the port against that one result or against itself.

Bars: the loss within rtol 1e-4, every field within rtol 2e-2 and atol
2e-2 * max|ref| and its non-zero support within 2 entries
(tests/test_diff_fast.py's bar between two gradient graphs of the same
function: the port's eager float32 ops and XLA:CPU's fused ones round
differently, and a gradient amplifies it). The finite-difference mirrors use
tests/test_diff.py's fields, steps and tolerances.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.diff.render import render_value_and_grad as jax_render_value_and_grad
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.convert import grads_to_numpy
from pathtracing_tpu_torch.diff.render import DIFFERENTIABLE_FIELDS, render_value_and_grad
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, stack

import golden_scene as jgolden

CFG = dataclasses.replace(TESTING, max_bounces=2)
JCFG = dataclasses.replace(JTESTING, max_bounces=2)

XS = np.array([300, 320, 340, 360, 380, 400, 420, 440], np.int32)
YS = np.array([170, 180, 190, 160, 170, 180, 190, 200], np.int32)


def _lanes():
    return (torch.from_numpy(XS), torch.from_numpy(YS),
            torch.zeros(len(XS), dtype=torch.int32))


@pytest.fixture(scope="module")
def scene():
    return scene_device_from_golden(golden("scene.gold"), TESTING, device="cpu")


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    jscene = jgolden.scene_device_from_golden(golden("scene.gold"))
    loss, grads = jax_render_value_and_grad(
        JCFG, jscene, jnp.asarray(XS), jnp.asarray(YS), jnp.zeros(len(XS), jnp.int32)
    )
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def loss_and_grads(scene):
    loss, grads = render_value_and_grad(CFG, scene, *_lanes())
    return float(loss), grads_to_numpy(grads)


def _loss(scene):
    c = path_trace_samples(CFG, scene, *_lanes())
    return float(torch.mean(0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z))


# Its setup holds the JAX gradient's compile: 261-312 s with the run's other
# workers busy, about the default limit.
@pytest.mark.limit(800)
def test_value_and_grad_matches_jax(loss_and_grads, jax_loss_and_grads):
    loss, grads = loss_and_grads
    jloss, jgrads = jax_loss_and_grads
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert set(grads) == set(jgrads) == set(DIFFERENTIABLE_FIELDS)
    for k, a in jgrads.items():
        b = grads[k]
        assert b.shape == a.shape and b.dtype == a.dtype, k
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=2e-2 * scale + 1e-9, err_msg=k)
        assert abs(int((np.abs(a) > 1e-12).sum()) - int((np.abs(b) > 1e-12).sum())) <= 2, k


def test_records_repeat_and_radiance_is_finite(scene):
    """The lanes' hit records are the same in two calls (the records were
    checked equal to the JAX package's, record for record, when this test
    was written), and every lane's radiance is finite."""
    c1, (p1, r1) = path_trace_samples(CFG, scene, *_lanes(), record=True)
    c2, (p2, r2) = path_trace_samples(CFG, scene, *_lanes(), record=True)
    for a, b in ((p1, p2), (r1, r2)):
        assert a.keys() == b.keys() == {"hit", "inst", "prim", "back", "occ"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert r1["hit"].shape == (CFG.max_bounces, len(XS))
    assert np.isfinite(stack(c1)).all() and stack(c1).tobytes() == stack(c2).tobytes()
    assert bool(p1["hit"].all())  # these lanes all see geometry


def test_gradients_finite(loss_and_grads):
    loss, grads = loss_and_grads
    assert np.isfinite(loss)
    for k, g in grads.items():
        assert np.isfinite(g).all(), k
        assert np.count_nonzero(g) > 0, k


@pytest.mark.parametrize(
    "field,eps,tol",
    [
        ("vattr", 1e-3, 0.08),     # materials / normals
        ("tri_pos", 1e-3, 0.15),   # vertex positions (re-derived hit)
        ("sf_light", 1e-3, 0.08),  # sun direction / color
        ("sf_cam", 1e-4, 0.15),    # camera parameters
    ],
)
def test_grad_matches_finite_difference(scene, loss_and_grads, field, eps, tol):
    _, grads = loss_and_grads
    g = grads[field]
    # probe the 3 largest-|grad| entries (they matter for these rays)
    flat = np.abs(g).reshape(-1)
    order = np.argsort(flat)[::-1][:3]
    base = n(getattr(scene, field)).copy()
    checked = 0
    for idx in order:
        if flat[idx] == 0:
            continue
        coords = np.unravel_index(idx, g.shape)
        pert = base.copy()
        pert[coords] = base[coords] + eps
        lp = _loss(scene._replace(**{field: torch.from_numpy(pert.copy())}))
        pert[coords] = base[coords] - eps
        lm = _loss(scene._replace(**{field: torch.from_numpy(pert.copy())}))
        fd = (lp - lm) / (2 * eps)
        an = g[coords]
        # fixed-topology analytic gradient vs FD (FD may cross visibility
        # edges, hence the generous tolerance)
        assert abs(fd - an) <= tol * max(abs(an), abs(fd), 1e-4), (field, coords, an, fd)
        checked += 1
    assert checked >= 2, f"not enough nonzero grads for {field}"


def test_sample_cone_grad_finite_at_pole():
    """u.x == 0 makes cos_theta == 1 exactly (a real pcg4d output); the
    sqrt(1 - cos^2) gradient with respect to cos_theta_min stays finite."""
    from pathtracing_tpu_torch.ops.samplers import sample_cone
    from pathtracing_tpu_torch.utils.vec import Vec2, Vec3

    cos_min = torch.tensor(0.9976, requires_grad=True)
    d = Vec3(torch.zeros(3), torch.zeros(3), torch.ones(3))
    u = Vec2(torch.tensor([0.0, 0.5, 1.0]), torch.full((3,), 0.25))
    v = sample_cone(d, cos_min.expand(3), u)
    (g,) = torch.autograd.grad((v.x + v.y + v.z).sum(), cos_min)
    assert torch.isfinite(g)
    # forward unchanged at the pole: u.x = 0 gives exactly the axis direction
    d1 = Vec3(torch.zeros(1), torch.zeros(1), torch.ones(1))
    v1 = sample_cone(d1, torch.full((1,), 0.9976), Vec2(torch.zeros(1), torch.zeros(1)))
    assert float(v1.z[0]) == 1.0


def test_ray_sphere_grad_finite_on_miss():
    """d sqrt(disc) at disc <= 0 (rays that miss the atmosphere) does not
    poison the cotangents."""
    from pathtracing_tpu_torch.ops.sky import ray_sphere_intersection
    from pathtracing_tpu_torch.utils.vec import Vec3

    ox = torch.tensor([0.0, 1.0, 5.0], requires_grad=True)  # graze / hit / miss
    o = Vec3(ox, torch.full((3,), 10.0), torch.zeros(3))
    d = Vec3(torch.zeros(3), torch.ones(3), torch.zeros(3))
    hit, tmin, tmax = ray_sphere_intersection(o, d, Vec3(*(torch.zeros(3),) * 3), 1.0)
    (g,) = torch.autograd.grad(torch.where(hit, tmax - tmin, 0.0).sum(), ox)
    assert torch.isfinite(g).all()
