"""``shade_hit(packed=True)`` — the shading fetch from the packed
``tri_shade`` rows of a wide scene — vs the JAX package's, and vs the port's
own unpacked fetch.

Against JAX (called op by op, uncompiled): rtol=1e-5, atol=1e-6 on every field
of every lane (the fetch is gathers, one triangle test and a few products). Against the unpacked fetch of the port:
every field bit-equal — one row holds the same 33 attribute floats and 9
positions the three gathers return — except that ``back`` is re-derived from
the triangle test instead of taken from the hit, and must equal the
traversal's on these rays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops import integrator as jinteg
from pathtracing_tpu.ops.traversal import RayHit as JRayHit
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.ops import integrator as tinteg
from pathtracing_tpu_torch.ops.traversal import ray_query
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, stack, t, vec3_t

import golden_scene as jgolden

R = 2048


def _flat(info) -> np.ndarray:
    return np.concatenate(
        [
            stack((info.thit,)), stack(info.pos), stack(info.tbn.r0),
            stack(info.tbn.r1), stack(info.tbn.r2), stack(info.albedo),
            stack((info.alpha, info.roughness, info.metallic, info.emission,
                   info.transmission, info.eta, info.nee_pdf)),
        ],
        axis=1,
    )


@pytest.fixture(scope="module")
def setup():
    """Wide scenes of both packages and the port's own closest hits on the
    first R rays of rays.gold (misses included: inst -1 must never index)."""
    g, rg = golden("scene.gold"), golden("rays.gold")
    tscene = scene_device_from_golden(g, wide=True, device="cpu")
    jscene = jgolden.scene_device_from_golden(g, wide=True)
    o, d = rg["origins"][:R], rg["dirs"][:R]
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    hit, _ = ray_query(
        tscene, full(g["tlas"][0]), full(g["tlas"][1]), vec3_t(o), vec3_t(d),
        0.0, 1e9, torch.ones(R, dtype=torch.bool),
    )
    assert bool((hit.inst < 0).any()) and bool((hit.inst >= 0).any())
    zeros = np.zeros(R, np.int32)
    return tscene, jscene, hit, o, d, zeros


def test_packed_matches_jax_packed(setup):
    tscene, jscene, hit, o, d, zeros = setup
    jhit = JRayHit(*(jnp.asarray(n(c)) for c in hit))
    tl = tinteg.light_from_table(tscene.sf_light, t(zeros))
    jl = jinteg.light_from_table(jscene.sf_light, jnp.asarray(zeros))
    ti = tinteg.shade_hit(tscene, tl, hit, vec3_t(o), vec3_t(d), packed=True)
    j3 = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    # op by op, as tests/test_torch_shading.py calls the unpacked fetch: a
    # jitted call lets XLA:CPU contract the triangle test's products
    ji = jinteg.shade_hit(jscene, jl, jhit, j3(o), j3(d), packed=True)
    np.testing.assert_allclose(_flat(ti), _flat(ji), rtol=1e-5, atol=1e-6)


def test_packed_equals_unpacked_fetch(setup):
    tscene, _, hit, o, d, zeros = setup
    tl = tinteg.light_from_table(tscene.sf_light, t(zeros))
    packed = tinteg.shade_hit(tscene, tl, hit, vec3_t(o), vec3_t(d), packed=True)
    plain = tinteg.shade_hit(tscene, tl, hit, vec3_t(o), vec3_t(d))
    assert _flat(packed).tobytes() == _flat(plain).tobytes()
    # with a wrong ``back`` on the hit, the packed fetch re-derives the right
    # one; the unpacked fetch trusts the hit and flips normal and eta
    flipped = hit._replace(back=torch.logical_not(hit.back))
    again = tinteg.shade_hit(tscene, tl, flipped, vec3_t(o), vec3_t(d), packed=True)
    assert _flat(again).tobytes() == _flat(packed).tobytes()
    trusted = tinteg.shade_hit(tscene, tl, flipped, vec3_t(o), vec3_t(d))
    h = n(hit.thit) >= 0
    assert (n(trusted.eta)[h] != n(plain.eta)[h]).all()


def test_tri_shade_rows_hold_the_gathered_tables(setup):
    """One ``tri_shade`` row = the three ``vattr`` rows (11 floats each) and
    the 9 ``tri_pos`` floats of its triangle."""
    tscene = setup[0]
    ts, ti = n(tscene.tri_shade), n(tscene.tri_idx)
    va, tp = n(tscene.vattr), n(tscene.tri_pos)
    assert ts.shape == (tp.shape[0], 48)
    for v in range(3):
        assert ts[:, 11 * v : 11 * v + 11].tobytes() == va[ti[:, v], :11].tobytes()
    assert ts[:, 33:42].tobytes() == tp[:, :9].tobytes()
    assert not ts[:, 42:].any()


def test_packed_needs_the_rows(setup):
    tscene, _, hit, o, d, zeros = setup
    tl = tinteg.light_from_table(tscene.sf_light, t(zeros))
    with pytest.raises(ValueError, match="tri_shade"):
        tinteg.shade_hit(
            tscene._replace(tri_shade=None), tl, hit, vec3_t(o), vec3_t(d), packed=True
        )
