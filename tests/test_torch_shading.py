"""Port's shading functions vs the oracle's bsdf.gold and vs the JAX
functions on random inputs (numpy, seeded).

vs JAX: rtol=1e-5, atol=1e-6 on nearly all lanes — sin/cos/exp/pow/log differ
by ulps between XLA:CPU and PyTorch, and XLA contracts mul+add into FMA while
eager PyTorch rounds every op. A few lanes sit where the function itself is
ill-conditioned and those ulps are amplified (``1 - x*x`` with x near 1 in
inv_erf and the hemisphere's z; a height taken as a difference against the
Earth's radius, where one float32 ulp is half a metre; a select that flips):
each check states the share of lanes held to the tight tolerance and a loose
bound that every lane meets."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracing_tpu.ops import bsdf as jbsdf
from pathtracing_tpu.ops import camera as jcamera
from pathtracing_tpu.ops import integrator as jinteg
from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu.ops import samplers as jsamp
from pathtracing_tpu.ops import sky as jsky
from pathtracing_tpu.ops.traversal import RayHit as JRayHit
from pathtracing_tpu.utils import vec as jvec
from pathtracing_tpu_torch.ops import bsdf as tbsdf
from pathtracing_tpu_torch.ops import camera as tcamera
from pathtracing_tpu_torch.ops import integrator as tinteg
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.ops import samplers as tsamp
from pathtracing_tpu_torch.ops import sky as tsky
from pathtracing_tpu_torch.ops.traversal import RayHit as TRayHit
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, rel_err, stack, t
from pathtracing_tpu_torch.utils import vec as tvec

import golden_scene as jgolden

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _rs(seed=0):
    return np.random.default_rng(seed)


def _f(rs, lo=0.0, hi=1.0, size=N):
    return rs.uniform(lo, hi, size).astype(np.float32)


def _unit3(rs, size=N):
    v = rs.normal(size=(size, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _j3(a):
    return jvec.Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _t3(a):
    return tvec.Vec3(*(t(a[:, i]) for i in range(3)))


def _close(got, ref, rtol=RTOL, atol=ATOL, frac=1.0, loose=None):
    """At least ``frac`` of the elements within rtol/atol; with ``loose``,
    every element within that relative-or-absolute bound as well."""
    got, ref = np.asarray(got), np.asarray(ref)
    ok = np.isclose(got, ref, rtol=rtol, atol=atol, equal_nan=True)
    assert ok.mean() >= frac, (1 - ok.mean(), np.abs(got - ref)[~ok][:5])
    if loose is not None:
        far = ~np.isclose(got, ref, rtol=loose, atol=loose, equal_nan=True)
        assert not far.any(), (far.sum(), np.abs(got - ref)[far][:5])


# ------------------------------------------------------------------ bsdf.gold


def _bsdf_inputs():
    g = golden("bsdf.gold")
    i = g["inputs"]
    col = lambda k: t(i[:, k])
    light = tvec.Vec3(col(0), col(1), col(2))
    view = tvec.Vec3(col(3), col(4), col(5))
    albedo = tvec.Vec3(col(6), col(7), col(8))
    rough, metal, trans, eta = (col(k) for k in range(9, 13))
    u = tvec.Vec3(col(13), col(14), col(15))
    return g, light, view, albedo, rough, metal, trans, eta, u


def test_bsdf_eval_matches_oracle():
    g, light, view, albedo, rough, metal, trans, eta, u = _bsdf_inputs()
    color, pdf = tbsdf.bsdf_eval(light, view, albedo, rough, metal, trans, eta)
    rel = rel_err(stack((*color, pdf)), g["eval"], 1e-5)
    assert np.quantile(rel, 0.999) < 1e-3, np.quantile(rel, 0.999)
    assert np.median(rel) < 1e-5


def test_sample_bsdf_matches_oracle():
    g, light, view, albedo, rough, metal, trans, eta, u = _bsdf_inputs()
    s = tbsdf.sample_bsdf(u, view, albedo, rough, metal, trans, eta)
    rel = rel_err(stack((*s.direction, *s.attenuation, s.pdf)), g["sample"], 1e-5)
    # lobe selection at probability boundaries can flip on transcendental
    # ulps; almost all cases must match tightly
    assert np.quantile(rel, 0.995) < 1e-3, np.quantile(rel, 0.995)
    assert np.median(rel) < 1e-5


def test_bsdf_matches_jax_on_golden_inputs():
    g, light, view, albedo, rough, metal, trans, eta, u = _bsdf_inputs()
    i = g["inputs"]
    jc = lambda k: jnp.asarray(i[:, k])
    jl, jv, ja, ju = (jvec.Vec3(jc(k), jc(k + 1), jc(k + 2)) for k in (0, 3, 6, 13))
    jcolor, jpdf = jbsdf.bsdf_eval(jl, jv, ja, jc(9), jc(10), jc(11), jc(12))
    color, pdf = tbsdf.bsdf_eval(light, view, albedo, rough, metal, trans, eta)
    # the bars tests/test_bsdf.py holds the JAX package to against the oracle
    rel = rel_err(stack((*color, pdf)), stack((*jcolor, jpdf)), 1e-5)
    assert np.quantile(rel, 0.999) < 1e-3 and np.median(rel) < 1e-5
    js = jbsdf.sample_bsdf(ju, jv, ja, jc(9), jc(10), jc(11), jc(12))
    s = tbsdf.sample_bsdf(u, view, albedo, rough, metal, trans, eta)
    rel = rel_err(
        stack((*s.direction, *s.attenuation, s.pdf)),
        stack((*js.direction, *js.attenuation, js.pdf)), 1e-5,
    )
    assert np.quantile(rel, 0.995) < 1e-3 and np.median(rel) < 1e-5


# ------------------------------------------------------------------- samplers


def test_vec_helpers_match_jax():
    rs = _rs(1)
    a, b = _unit3(rs), _unit3(rs)
    eta = np.where(rs.random(N) < 0.5, np.float32(1.5), np.float32(1 / 1.5)).astype(np.float32)
    _close(stack(tvec.reflect(_t3(a), _t3(b))), stack(jvec.reflect(_j3(a), _j3(b))))
    _close(
        stack(tvec.refract(_t3(a), _t3(b), t(eta))),
        stack(jvec.refract(_j3(a), _j3(b), jnp.asarray(eta))), frac=0.999,
    )
    tm, jm = tvec.create_tangent_space(_t3(a)), jvec.create_tangent_space(_j3(a))
    for tr, jr in zip(tm, jm):
        _close(stack(tr), stack(jr))
    _close(stack(tm.mul_vec(_t3(b))), stack(jm.mul_vec(_j3(b))))
    _close(stack(tm.vec_mul(_t3(b))), stack(jm.vec_mul(_j3(b))))
    x = _f(rs, -0.999999, 0.999999)
    # measured: 97.83 % of lanes at the tight tolerance, worst lane 1.3e-4
    _close(n(tvec.inv_erf(t(x))), n(jvec.inv_erf(jnp.asarray(x))), frac=0.975, loose=1e-3)
    _close(n(tvec.luminance(_t3(a))), n(jvec.luminance(_j3(a))))


@pytest.mark.parametrize(
    "name", ["gaussian_disk", "cosine_hemisphere", "cone", "polygon", "ggx_vndf"]
)
def test_samplers_match_jax(name):
    rs = _rs(2)
    u = np.stack([_f(rs), _f(rs)], -1)
    u[0] = (0.0, 0.0)  # real pcg4d outputs: the guarded-sqrt corners
    u[1] = (1.0, 1.0)
    tu, ju = tvec.Vec2(t(u[:, 0]), t(u[:, 1])), jvec.Vec2(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    if name == "gaussian_disk":
        got = tsamp.sample_gaussian_weighted_disk(tu, 0.4)
        ref = jsamp.sample_gaussian_weighted_disk(ju, np.float32(0.4))
    elif name == "cosine_hemisphere":
        got, ref = tsamp.sample_cosine_hemisphere(tu), jsamp.sample_cosine_hemisphere(ju)
        _close(n(tsamp.cosine_hemisphere_pdf(got.z)), n(jsamp.cosine_hemisphere_pdf(ref.z)),
               frac=0.999, loose=1e-4)
    elif name == "cone":
        d = _unit3(rs)
        cmin = _f(rs, 0.9, 1.0)
        got = tsamp.sample_cone(_t3(d), t(cmin), tu)
        ref = jsamp.sample_cone(_j3(d), jnp.asarray(cmin), ju)
    elif name == "polygon":
        angle = _f(rs, 0.0, 1.0)
        sides = rs.integers(3, 9, N).astype(np.float32)
        got = tsamp.sample_regular_polygon(tu, t(angle), t(sides))
        ref = jsamp.sample_regular_polygon(ju, jnp.asarray(angle), jnp.asarray(sides))
    else:
        view = _unit3(rs)
        view[:, 2] = np.abs(view[:, 2])
        rough = _f(rs) ** 2
        rough[:64] = 0.0  # delta lobes
        got = tsamp.sample_ggx_vndf(_t3(view), t(rough), tu)
        ref = jsamp.sample_ggx_vndf(_j3(view), jnp.asarray(rough), ju)
    _close(stack(got), stack(ref), atol=2e-6, frac=0.99, loose=1e-3)


# ------------------------------------------------------------------------ sky


def _sky_inputs(rs):
    pos = np.stack([_f(rs, -50, 50), _f(rs, 0, 30), _f(rs, -50, 50)], -1)
    view = _unit3(rs)
    sun = np.tile(np.float32([0.0, 0.70710677, 0.70710677]), (N, 1))
    return pos, view, sun


def test_atmosphere_attenuation_matches_jax():
    rs = _rs(3)
    pos, view, _ = _sky_inputs(rs)
    jit, tmax = _f(rs), np.full(N, 1e9, np.float32)
    got = tsky.atmosphere_attenuation(t(jit), _t3(pos), _t3(view), t(tmax))
    ref = jsky.atmosphere_attenuation(jnp.asarray(jit), _j3(pos), _j3(view), jnp.asarray(tmax))
    # measured: 94.28 % of values at the tight tolerance, worst 3.8e-5 (the
    # march's heights are differences against the Earth's radius)
    _close(stack(got), stack(ref), frac=0.94, loose=2e-4)


def test_atmosphere_scattering_matches_jax_values_and_rng():
    rs = _rs(4)
    pos, view, sun = _sky_inputs(rs)
    color = np.tile(np.float32([4, 4, 4]), (N, 1))
    tmax = np.where(rs.random(N) < 0.3, _f(rs, 1.0, 5e3), np.float32(-1.0)).astype(np.float32)
    active = rs.random(N) < 0.8
    seeds = rs.integers(0, 2**32, size=(N, 4), dtype=np.uint64).astype(np.uint32)
    ts = trng.Seed(*(t(seeds[:, i]) for i in range(4)))
    js = jrng.Seed(*(jnp.asarray(seeds[:, i]) for i in range(4)))
    ts1, tatt, tin = tsky.atmosphere_scattering(
        ts, _t3(sun), _t3(color), _t3(pos), _t3(view), t(tmax), t(active)
    )
    js1, jatt, jin = jsky.atmosphere_scattering(
        js, _j3(sun), _j3(color), _j3(pos), _j3(view), jnp.asarray(tmax), jnp.asarray(active)
    )
    # the conditional draw: exactly the same lanes advance, to the same bits
    np.testing.assert_array_equal(
        np.stack([n(c).view(np.uint32) for c in ts1], -1), np.stack([n(c) for c in js1], -1)
    )
    assert (np.stack([n(c) for c in js1], -1) != seeds).any()
    # measured: 96.59 % and 94.52 % at the tight tolerance, worst 7.1e-5
    _close(stack(tatt), stack(jatt), frac=0.96, loose=2e-4)
    _close(stack(tin), stack(jin), frac=0.94, loose=2e-4)


# ------------------------------------------------------------- camera, shade


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return g, scene_device_from_golden(g, device="cpu"), jgolden.scene_device_from_golden(g)


def test_camera_ray_matches_jax(scenes):
    g, tscene, jscene = scenes
    rs = _rs(5)
    cam = n(tscene.sf_cam).copy()
    cam[1, 17], cam[1, 14], cam[1, 15] = 0.3, 10.0, np.float32(np.pi / 7)  # bokeh row
    idx = rs.integers(0, 2, N).astype(np.int32)
    u = np.stack([_f(rs), _f(rs)], -1)
    coord = np.stack([_f(rs, 0, 640), _f(rs, 0, 360)], -1)
    td, to = tcamera.get_camera_ray(
        tcamera.camera_from_table(t(cam), t(idx)),
        tvec.Vec2(t(u[:, 0]), t(u[:, 1])), tvec.Vec2(t(coord[:, 0]), t(coord[:, 1])), 640, 360,
    )
    jd, jo = jcamera.get_camera_ray(
        jcamera.camera_from_table(jnp.asarray(cam), jnp.asarray(idx)),
        jvec.Vec2(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])),
        jvec.Vec2(jnp.asarray(coord[:, 0]), jnp.asarray(coord[:, 1])), 640, 360,
    )
    _close(stack(td), stack(jd), atol=2e-6)
    _close(stack(to), stack(jo), atol=2e-6)


def test_shade_hit_matches_jax(scenes):
    """Hits from rays.gold's oracle columns (misses included: their inst is
    0xFFFFFFFF and must never be used as an index)."""
    g, tscene, jscene = scenes
    rg = golden("rays.gold")
    R = 2048
    o, d = rg["origins"][:R], rg["dirs"][:R]
    inst = rg["inst"][:R].view(np.int32)
    prim = np.where(rg["thit"][:R] < 0, 0, rg["prim"][:R].view(np.int32)).astype(np.int32)
    back = rg["back"][:R] != 0
    assert (inst < 0).any() and (inst >= 0).any()
    cols = (rg["thit"][:R], rg["bary"][:R, 0], rg["bary"][:R, 1], rg["bary"][:R, 2])
    thit = TRayHit(*(t(c) for c in cols), t(inst), t(prim), t(back))
    jhit = JRayHit(*(jnp.asarray(c) for c in cols), jnp.asarray(inst), jnp.asarray(prim), jnp.asarray(back))
    zeros = np.zeros(R, np.int32)
    tl = tinteg.light_from_table(tscene.sf_light, t(zeros))
    jl = jinteg.light_from_table(jscene.sf_light, jnp.asarray(zeros))
    ti = tinteg.shade_hit(tscene, tl, thit, _t3(o), _t3(d))
    ji = jinteg.shade_hit(jscene, jl, jhit, _j3(o), _j3(d))
    flat = lambda info: np.concatenate(
        [
            stack((info.thit,)), stack(info.pos), stack(info.tbn.r0), stack(info.tbn.r1),
            stack(info.tbn.r2), stack(info.albedo),
            stack((info.alpha, info.roughness, info.metallic, info.emission,
                   info.transmission, info.eta, info.nee_pdf)),
        ],
        axis=1,
    )
    _close(flat(ti), flat(ji), rtol=1e-4, atol=1e-5, frac=0.999)
    # the packed fetch needs a scene packed with wide=True
    with pytest.raises(ValueError, match="tri_shade"):
        tinteg.shade_hit(tscene, tl, thit, _t3(o), _t3(d), packed=True)
