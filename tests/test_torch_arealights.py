"""Area-light NEE (the port's ops/arealights.py and the scan's light branch)
vs the JAX package's, on the CPU.

The light tables byte-equal to JAX's (the two-panel scene of
tests/test_arealights.py and the Cornell box); the light functions on
seeded lanes within float tolerance (XLA:CPU contracts multiply-adds, the
port does not); ``path_trace_samples`` on the panel scene against ONE JAX
call: the RNG words of every draw equal on every lane, the radiance within
the JAX package's bar (>= 99 % finite, >= 97 % within 2e-4 + 2e-4 |ref|);
the path kernels' plain versions with lights equal to the scan, and the
record build refusing light tables."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu import models as jmodels
from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.ops import arealights as jal
from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu.ops.integrator import path_trace_samples as jax_path_trace_samples
from pathtracing_tpu.scene import builder as jbuilder
from pathtracing_tpu.utils import vec as jvec
from pathtracing_tpu_torch import models as tmodels
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import arealights as tal
from pathtracing_tpu_torch.ops import megakernel as tmk
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.ops import wavefront as twf
from pathtracing_tpu_torch.ops.integrator import HitInfo, path_trace_samples
from pathtracing_tpu_torch.render import render_pixels
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene.device import binary_tables
from pathtracing_tpu_torch.testing import assert_same_tables, n, stack, t
from pathtracing_tpu_torch.utils import vec as tvec

CFG = dataclasses.replace(TESTING, image_width=12, image_height=8, samples_per_pixel=2,
                          max_bounces=2)
RTOL, ATOL = 2e-5, 1e-5  # float ops in the same order; XLA:CPU fuses multiply-adds
LANES = 256


def _write_panel_scene(tmp):
    """tests/test_arealights.py's panel scene: a ground quad and an emissive
    8 x 8 panel facing down."""
    with open(os.path.join(tmp, "g.obj"), "w") as f:
        f.write(
            "mtllib m.mtl\nusemtl g\nv -20 0 -20\nv 20 0 -20\nv 20 0 20\n"
            "v -20 0 20\nvn 0 1 0\nf 1//1 2//1 3//1\nf 1//1 3//1 4//1\n"
        )
    with open(os.path.join(tmp, "p.obj"), "w") as f:
        f.write(
            "mtllib m.mtl\nusemtl light\nv -4 6 -4\nv 4 6 -4\nv 4 6 4\n"
            "v -4 6 4\nvn 0 -1 0\nf 1//1 3//1 2//1\nf 1//1 4//1 3//1\n"
        )
    with open(os.path.join(tmp, "m.mtl"), "w") as f:
        f.write("newmtl g\nKd 0.6 0.6 0.6\nPr 0.8\nnewmtl light\nKd 3 3 3\nKe 3 3 3\nPr 1.0\n")


def _build_panel(builder, tmp, **kw):
    """The scaled panel plus a second instance 30 to the side (four light
    rows), no sun."""
    b = builder.SceneBuilder()
    b.add_mesh("g", os.path.join(tmp, "g.obj"))
    b.add_mesh("p", os.path.join(tmp, "p.obj"))
    b.add_instance("g")
    b.add_instance("p", scale=(2, 1, 1))
    b.add_instance("p", pos=(30, 0, 0))
    b.set_camera(position=(0, 2.0, 12.0), pitch_yaw_roll=(8, 0, 0), fov=50)
    b.set_light(direction=(0, 1, 0), color=(0, 0, 0))  # no sun
    return b.build(**kw)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """(port scene, JAX scene) of the panel scene, both packed from the same
    OBJ files with the light tables."""
    tmp = str(tmp_path_factory.mktemp("panel"))
    _write_panel_scene(tmp)
    _, tdev = _build_panel(tbuilder, tmp, config=TESTING, emissive_nee=True, device="cpu")
    _, jdev = _build_panel(jbuilder, tmp, config=JTESTING, emissive_nee=True)
    return tdev, jdev


def test_light_tables_match_jax(panel, tmp_path):
    """lt_* byte-equal to JAX's on the panel scene and on the Cornell box,
    and the panel scene's layout as tests/test_arealights.py's
    test_light_table_layout asserts it: world vertices, per-instance
    segments, per-mesh ranks, the area CDF."""
    tdev, jdev = panel
    assert_same_tables(tdev, jdev)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    _, tcb = tmodels.build("cornell_box", CFG, asset_dir=str(tmp_path / "t"), device="cpu")
    _, jcb = jmodels.build("cornell_box", CFG, asset_dir=str(tmp_path / "j"))
    assert tcb.lt_tris is not None and tcb.lt_tris.shape == (2, 9)
    assert_same_tables(tcb, jcb)

    lt_tris, lt_cdf, lt_seg, lt_rank, lt_rows = (
        n(getattr(tdev, k)) for k in ("lt_tris", "lt_cdf", "lt_seg", "lt_rank", "lt_rows"))
    # panel mesh = 2 emissive triangles; two instances => 4 rows
    assert lt_tris.shape == (4, 9)
    assert lt_seg[0] == -1 and lt_seg[1] == 0 and lt_seg[2] == 2
    # ranks live on the mesh's global tri rows (both instances share them)
    assert (lt_rank >= 0).sum() == 2
    # the scaled instance (x2 in x): each panel triangle 8 x 8 / 2 = 32 -> 64
    areas = np.diff(np.concatenate([[0.0], lt_cdf]))
    np.testing.assert_allclose(areas, [64.0, 64.0, 32.0, 32.0], rtol=1e-5)
    # the world vertices of the second instance are translated by +30 in x
    np.testing.assert_allclose(lt_tris[2][0::3], lt_tris[0][0::3] / 2 + 30, rtol=1e-5)
    # lt_rows index the global tri table of the panel mesh for both
    assert list(lt_rows[:2]) == list(lt_rows[2:])
    assert tal.has_lights(tdev) and not tal.has_lights(binary_tables(tdev)._replace(
        lt_tris=None, lt_rows=None, lt_cdf=None, lt_seg=None, lt_rank=None))
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        tal.has_lights(tdev._replace(lt_cdf=None))


def _hit_infos(R, seed=3):
    """Seeded shading points above the ground, facing up-ish, with random
    materials: the same numbers as a port HitInfo and as a JAX one, plus a
    tangent-space view with z > 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.random(s, np.float32)
    pos = np.stack([f(R) * 24 - 12, f(R) * 5, f(R) * 24 - 12], -1).astype(np.float32)
    nrm = np.stack([f(R) - 0.5, f(R) + 0.5, f(R) - 0.5], -1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = np.stack([f(R) - 0.5, f(R) - 0.5, f(R) + 0.2], -1).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    mat = dict(albedo=f(R, 3), roughness=f(R) * 0.9 + 0.05, metallic=f(R) * 0.5,
               transmission=(f(R) < 0.2).astype(np.float32) * f(R),
               eta=np.where(f(R) < 0.5, 1.5, 1 / 1.5).astype(np.float32))
    u = f(R, 4)
    return pos, nrm, view, mat, u


def _port_info(pos, nrm, mat):
    v3 = lambda a: tvec.Vec3(*(t(a[:, i]) for i in range(3)))
    z = torch.zeros(len(pos))
    return HitInfo(thit=z + 1, pos=v3(pos), tbn=tvec.create_tangent_space(v3(nrm)),
                   albedo=v3(mat["albedo"]), alpha=z, roughness=t(mat["roughness"]),
                   metallic=t(mat["metallic"]), emission=z, transmission=t(mat["transmission"]),
                   eta=t(mat["eta"]), nee_pdf=z)


def _jax_info(pos, nrm, mat):
    from pathtracing_tpu.ops.integrator import HitInfo as JHitInfo

    v3 = lambda a: jvec.Vec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    z = jnp.zeros(len(pos), jnp.float32)
    return JHitInfo(thit=z + 1, pos=v3(pos), tbn=jvec.create_tangent_space(v3(nrm)),
                    albedo=v3(mat["albedo"]), alpha=z, roughness=jnp.asarray(mat["roughness"]),
                    metallic=jnp.asarray(mat["metallic"]), emission=z,
                    transmission=jnp.asarray(mat["transmission"]),
                    eta=jnp.asarray(mat["eta"]), nee_pdf=z)


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def test_light_functions_match_jax(panel):
    """sample_area_light, area_nee_color and light_pdf_of_hit on seeded
    lanes: the light rows picked equal, every output within RTOL / ATOL."""
    tdev, jdev = panel
    R = 512
    pos, nrm, view, mat, u = _hit_infos(R)
    active = np.random.default_rng(4).random(R) < 0.9
    tu = tvec.Vec4(*(t(u[:, i]) for i in range(4)))
    ju = jvec.Vec4(*(jnp.asarray(u[:, i]) for i in range(4)))
    tview = tvec.Vec3(*(t(view[:, i]) for i in range(3)))
    jview = jvec.Vec3(*(jnp.asarray(view[:, i]) for i in range(3)))
    ts = tal.sample_area_light(tdev, tu, _port_info(pos, nrm, mat), tview, t(active))
    js = jal.sample_area_light(jdev, ju, _jax_info(pos, nrm, mat), jview, jnp.asarray(active))
    for name in ("wi", "radiance", "bsdf"):
        _close(stack(getattr(ts, name)), stack(getattr(js, name)), name)
    for name in ("dist", "weighted_pdf"):
        _close(n(getattr(ts, name)), n(getattr(js, name)), name)
    lit = n(ts.shadow_active)
    assert (lit == n(js.shadow_active)).all() and 0.2 < lit.mean() < 0.95
    occ = np.random.default_rng(5).random(R) < 0.3
    _close(stack(tal.area_nee_color(ts, t(occ), t(active))),
           stack(jal.area_nee_color(js, jnp.asarray(occ), jnp.asarray(active))), "nee color")

    # light_pdf_of_hit: hits on both panels' triangles, the ground, misses
    rng = np.random.default_rng(6)
    inst = rng.integers(-1, 3, R).astype(np.int32)
    prim = rng.integers(0, 2, R).astype(np.int32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    thit = (rng.random(R) * 10).astype(np.float32)
    valid = inst >= 0
    tp = tal.light_pdf_of_hit(tdev, t(inst), t(prim), tvec.Vec3(*(t(d[:, i]) for i in range(3))),
                              t(thit), t(valid))
    jp = jal.light_pdf_of_hit(jdev, jnp.asarray(inst), jnp.asarray(prim),
                              jvec.Vec3(*(jnp.asarray(d[:, i]) for i in range(3))),
                              jnp.asarray(thit), jnp.asarray(valid))
    assert ((n(tp) > 0) == (np.asarray(jp) > 0)).all() and (n(tp) > 0).mean() > 0.3
    _close(n(tp), np.asarray(jp), "light pdf")


def _lanes(seed=7):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, TESTING.image_width, LANES).astype(np.int32)
    ys = rng.integers(0, TESTING.image_height, LANES).astype(np.int32)
    return xs, ys, np.full(LANES, 3, np.int32)


def test_scan_with_lights_matches_jax(panel, monkeypatch):
    """path_trace_samples with the light branch against one JAX call: the
    words of every masked draw (NEE, area light, BSDF, atmosphere) equal on
    every lane, in the same order; the radiance within the JAX bar."""
    tdev, jdev = panel
    xs, ys, si = _lanes()
    jwords, twords = [], []
    jdraw, tdraw = jrng.uniform4_masked, trng.uniform4_masked

    def jrecord(s, consume):
        s2, u = jdraw(s, consume)
        jax.debug.callback(lambda *w: jwords.append(np.stack([np.asarray(x) for x in w])),
                           *s2, ordered=True)
        return s2, u

    def trecord(s, consume):
        s2, u = tdraw(s, consume)
        twords.append(np.stack([n(x) for x in s2]))
        return s2, u

    monkeypatch.setattr(jrng, "uniform4_masked", jrecord)
    monkeypatch.setattr(trng, "uniform4_masked", trecord)
    ref = stack(jax.jit(lambda *a: jax_path_trace_samples(JTESTING, *a))(
        jdev, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(si)))
    got = stack(path_trace_samples(TESTING, tdev, t(xs), t(ys), t(si)))
    # per bounce: NEE, area light, BSDF, conditional atmosphere; and the
    # primary ray's conditional atmosphere
    assert len(twords) == len(jwords) == 1 + 4 * TESTING.max_bounces
    np.testing.assert_array_equal(np.stack(twords).view(np.uint32),
                                  np.stack(jwords).astype(np.uint32))
    finite = np.isfinite(ref).all(-1)
    assert finite.mean() >= 0.99 and np.isfinite(got).all()
    close = (np.abs(got - ref) <= 2e-4 + 2e-4 * np.abs(ref)).all(-1)
    assert close[finite].mean() >= 0.97, close.mean()
    assert ref.mean() > 0  # the panel lights the ground: the light branch adds


@pytest.mark.parametrize("kind", ["binary", "w8"])
def test_path_kernel_plains_with_lights_equal_the_scan(tmp_path, kind):
    """The plain versions of K2 and K5 on a lit scene are the scan's
    sample-ordered sums, bit for bit (the kernels are held to them on the
    card); render_pixels picks the light branch through every renderer; the
    record build refuses light tables, as in JAX."""
    _, scene = tmodels.build("cornell_box", CFG, asset_dir=str(tmp_path), wide=True,
                             device="cpu")
    if kind == "binary":
        scene = binary_tables(scene)
    N, spp, base = CFG.image_width * CFG.image_height, 2, 5
    idx = np.arange(N, dtype=np.int32)
    xs, ys = idx % CFG.image_width, idx // CFG.image_width
    sums = np.zeros((N, 3), np.float32)
    l2 = np.zeros(N, np.float32)
    for k in range(spp):
        c = stack(path_trace_samples(CFG, scene, t(xs), t(ys),
                                     torch.full((N,), base + k, dtype=torch.int32)))
        sums += c
        lum = (np.float32(0.2126) * c[:, 0] + np.float32(0.7152) * c[:, 1]) \
            + np.float32(0.0722) * c[:, 2]
        l2 += lum * lum
    wf, wl2 = twf.path_trace_wavefront(CFG, scene, xs, ys, spp, base, with_stats=True,
                                       device="cpu")
    assert stack(wf).tobytes() == sums.tobytes() and n(wl2).tobytes() == l2.tobytes()
    assert sums.mean() > 0 and np.isfinite(sums).all()
    pix = render_pixels(CFG, scene, xs, ys, spp=spp, sample_base=base, average=False,
                        wavefront=True, device="cpu")
    assert pix.tobytes() == sums.tobytes()
    if kind == "w8":
        mk = tmk.path_trace_megakernel(CFG, scene, N, spp, base, device="cpu")
        assert stack(mk).tobytes() == sums.tobytes()
        with pytest.raises(NotImplementedError, match="area-light"):
            tmk.path_trace_megakernel(CFG, scene, N, 1, record=True, device="cpu")
    with pytest.raises(NotImplementedError, match="area-light"):
        path_trace_samples(CFG, scene, t(xs), t(ys), t(idx * 0), record=True)
