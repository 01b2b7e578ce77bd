"""Plain version of the wide ray-query kernel vs JAX ``wide_ray_query``, vs
the port's plain binary walk, and vs the oracle's rays.gold, for the three
shipped layouts.

Tolerances. Against JAX: ``occluded`` and hit/miss equal; ``inst``/``prim``
equal on >= 99.8 % of hit rays and ``thit`` within rtol=2e-5, atol=1e-5 —
XLA:CPU contracts mul+add into FMA inside its compiled loop, eager PyTorch
rounds every op, so equal-t ties between coincident triangles may resolve
the other way; barycentrics, where ids agree, rtol=1e-4, atol=1e-5. Against
the port's own binary walk: everything bit-equal — same ``_finalize_hit``,
same triangle test, no FMA on either side, and the wide walk confirms the
same candidates. Against the oracle: the bars of tests/test_traversal.py.

The JAX function is compiled once per layout: every mode is expressed by
per-lane arrays (active, any-hit mask, tmin, tmax0), so the modes share one
trace. It runs with its defaults (two-speed loop, staged compaction) and, for
w8, once more at ``leaf_every=None, compact_schedule=()``, the one-speed walk
the port's plain version is."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops.wide_traversal import wide_ray_query as jax_wide_ray_query
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.ops.traversal import _octant, ray_query, ray_query_plain
from pathtracing_tpu_torch.ops.wide_traversal import (
    WideQueryCounts,
    root_cursor,
    wide_ray_query,
    wide_ray_query_plain,
)
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import assert_hits_agree, golden, n, t, vec3_t

import golden_scene as jgolden

LAYOUTS = ("w8", "w16", "s8")
MODES = ("closest", "anyhit", "mixed_windowed", "inactive_lanes", "inactive_mixed")
R = 4096  # all of rays.gold: the JAX defaults compact lanes only from 4096 up


def _mode(name):
    """(tmin, tmax0, active, anyhit) as per-lane numpy arrays."""
    rs = np.random.default_rng(3)
    f = lambda v: np.full(R, v, np.float32)
    on, off = np.ones(R, bool), np.zeros(R, bool)
    mask = rs.random(R) < 0.5
    some = rs.random(R) < 0.7
    tmax_w = np.where(rs.random(R) < 0.5, 15.0, 1e9).astype(np.float32)
    tmin_w = np.where(rs.random(R) < 0.5, 1e-4, 0.5).astype(np.float32)
    return {
        "closest": (f(0.0), f(1e9), on, off),
        "anyhit": (f(1e-4), f(1e9), on, on),
        # tests/test_wide.py's mixed case: any-hit mask, per-lane tmax0 and tmin
        "mixed_windowed": (tmin_w, tmax_w, on, mask),
        "inactive_lanes": (f(0.0), f(1e9), some, off),
        "inactive_mixed": (tmin_w, tmax_w, some, mask),
    }[name]


@pytest.fixture(scope="module")
def base():
    scene_g, rays_g = golden("scene.gold"), golden("rays.gold")
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    handles = (full(scene_g["tlas"][0]), full(scene_g["tlas"][1]))
    rays = (vec3_t(rays_g["origins"][:R]), vec3_t(rays_g["dirs"][:R]))
    return scene_g, rays_g, handles, rays, scene_device_from_golden(scene_g, device="cpu")


def _wide_setup(base, layout):
    scene_g, rays_g = base[0], base[1]
    kw = dict(wide=True, leaf_bundle=None, wide_layout=layout)
    tscene = scene_device_from_golden(scene_g, device="cpu", **kw)
    jscene = jgolden.scene_device_from_golden(scene_g, **kw)
    tlc = jnp.full(R, int(scene_g["tlas"][0]), jnp.int32)
    tlo = jnp.full(R, int(scene_g["tlas"][1]), jnp.int32)
    org = JVec3(*(jnp.asarray(rays_g["origins"][:R, i]) for i in range(3)))
    d = JVec3(*(jnp.asarray(rays_g["dirs"][:R, i]) for i in range(3)))

    def make(**knobs):
        return jax.jit(lambda tmin, tmax0, act, ah: jax_wide_ray_query(
            jscene, tlc, tlo, org, d, tmin, tmax0, act, anyhit=ah, **knobs))

    return layout, tscene, make


@pytest.fixture(scope="module", params=LAYOUTS)
def wide(request, base):
    """(layout, port scene, maker of the jitted JAX query)."""
    return _wide_setup(base, request.param)


def _torch_query(fn, scene, base, mode, **kw):
    tmin, tmax0, active, anyhit = _mode(mode)
    _, _, handles, rays, _ = base
    return fn(scene, *handles, *rays, t(tmin), t(tmax0), t(active), t(anyhit), **kw)


_JITTED = {}


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax_wide_ray_query(wide, base, mode):
    layout, tscene, make = wide
    if layout not in _JITTED:
        _JITTED[layout] = make()  # the JAX defaults: two-speed, compaction
    tmin, tmax0, active, anyhit = _mode(mode)
    hit_j, occ_j = _JITTED[layout](*map(jnp.asarray, (tmin, tmax0, active, anyhit)))
    hit_t, occ_t = _torch_query(wide_ray_query, tscene, base, mode)
    assert_hits_agree(hit_t, occ_t, hit_j, occ_j)
    if not active.all():
        assert (n(hit_t.thit)[~active] == -1).all() and not n(occ_t)[~active].any()


def test_plain_matches_jax_one_speed_walk(base):
    """``leaf_every=None, compact_schedule=()``: the schedule the plain
    version is. One layout is enough: the JAX tests prove the schedules
    result-invariant."""
    _, tscene, make = _wide_setup(base, "w8")
    one_speed = make(leaf_every=None, compact_schedule=())
    for mode in ("closest", "mixed_windowed"):
        hit_j, occ_j = one_speed(*map(jnp.asarray, _mode(mode)))
        hit_t, occ_t = _torch_query(wide_ray_query, tscene, base, mode)
        assert_hits_agree(hit_t, occ_t, hit_j, occ_j)


@pytest.mark.parametrize("mode", MODES)
def test_plain_wide_bit_equal_to_plain_binary(wide, base, mode):
    _, tscene, _ = wide
    tmin, tmax0, active, anyhit = _mode(mode)
    hit_w, occ_w = _torch_query(wide_ray_query_plain, tscene, base, mode)
    if mode in ("mixed_windowed", "inactive_mixed"):
        # the binary walk takes a scalar tmin: compare per tmin value
        _, _, handles, rays, bscene = base
        for value in np.unique(tmin):
            sel = tmin == value
            hit_b, occ_b = ray_query_plain(
                bscene, *handles, *rays, float(value), t(tmax0), t(active), t(anyhit)
            )
            for a, b in zip((*hit_w, occ_w), (*hit_b, occ_b)):
                assert torch.equal(a[t(sel)], b[t(sel)])
        return
    _, _, handles, rays, bscene = base
    hit_b, occ_b = ray_query_plain(
        bscene, *handles, *rays, float(tmin[0]), t(tmax0), t(active), t(anyhit)
    )
    for name, a, b in zip((*hit_w._fields, "occluded"), (*hit_w, occ_w), (*hit_b, occ_b)):
        assert torch.equal(a, b), name


def test_closest_and_anyhit_match_oracle(wide, base):
    _, tscene, _ = wide
    rays_g = base[1]
    hit, _ = _torch_query(wide_ray_query, tscene, base, "closest")
    miss_ref = rays_g["thit"] < 0
    np.testing.assert_array_equal(n(hit.thit) < 0, miss_ref)
    h = ~miss_ref
    np.testing.assert_allclose(n(hit.thit)[h], rays_g["thit"][h], rtol=2e-5, atol=1e-5)
    same = (n(hit.inst) == rays_g["inst"].view(np.int32)) & (
        n(hit.prim) == rays_g["prim"].view(np.int32)
    )
    diff = h & ~same
    assert diff.mean() <= 0.002, f"{diff.sum()} id mismatches"
    exact = h & same
    np.testing.assert_array_equal(
        n(hit.back)[exact].astype(np.uint32), rays_g["back"][exact]
    )
    for k, col in (("bary_u", 0), ("bary_v", 1)):
        np.testing.assert_allclose(
            n(getattr(hit, k))[exact], rays_g["bary"][exact, col], rtol=2e-5, atol=2e-6
        )
    hit_a, occ = _torch_query(wide_ray_query, tscene, base, "anyhit")
    np.testing.assert_array_equal(n(occ).astype(np.uint32), rays_g["occluded"])
    assert (n(hit_a.thit) == -1).all() and (n(hit_a.inst) == -1).all()


def test_scalar_arguments_and_dispatch(wide, base):
    """``ray_query`` sends a scene with ``wide_rows`` to the wide walk; on CPU
    tensors that is the plain version. Python scalars for tmin / tmax0 and a
    Python bool for anyhit give what the per-lane arrays give."""
    _, tscene, _ = wide
    _, _, handles, rays, bscene = base
    on = torch.ones(R, dtype=torch.bool)
    for mode, (tmin, anyhit) in {"closest": (0.0, False), "anyhit": (1e-4, True)}.items():
        hit_l, occ_l = _torch_query(wide_ray_query_plain, tscene, base, mode)
        hit_s, occ_s = ray_query(tscene, *handles, *rays, tmin, 1e9, on, anyhit)
        for a, b in zip((*hit_l, occ_l), (*hit_s, occ_s)):
            assert torch.equal(a, b)
    # the same call on the binary scene takes the binary walk: same answers
    hit_b, _ = ray_query(bscene, *handles, *rays, 0.0, 1e9, on)
    hit_w, _ = ray_query(tscene, *handles, *rays, 0.0, 1e9, on)
    assert torch.equal(hit_b.thit, hit_w.thit) and torch.equal(hit_b.prim, hit_w.prim)


def test_counts(wide, base):
    """Row visits counted by the plain version: at least a root row per
    active ray, an INST row per BLAS entry, LEAF rows only inside a BLAS;
    stub layouts read one tri_pos row per triangle test, the others none."""
    layout, tscene, _ = wide
    hit, occ, c = _torch_query(
        wide_ray_query_plain, tscene, base, "inactive_lanes", return_counts=True
    )
    hit2, occ2 = _torch_query(wide_ray_query_plain, tscene, base, "inactive_lanes")
    for a, b in zip((*hit, occ), (*hit2, occ2)):
        assert torch.equal(a, b)
    assert isinstance(c, WideQueryCounts)
    n_active = int(_mode("inactive_lanes")[2].sum())
    n_hit = int((hit.thit >= 0).sum())
    assert c.hits == n_hit > 0
    assert c.wide_rows >= n_active and c.inst_rows >= n_hit
    assert c.leaf_rows >= n_hit and c.tri_tests >= c.leaf_rows
    assert c.stub_tri_rows == (c.tri_tests if layout == "s8" else 0)
    lay_tris = {"w8": 4, "w16": 8, "s8": 8}[layout]
    assert c.tri_tests <= lay_tris * c.leaf_rows
    # a WIDE visit needs fewer slab tests than it has slots where it resumes
    # past slot 0 or holds empty slots; every BLAS entry was a needed slot
    slots = {"w8": 8, "w16": 16, "s8": 8}[layout]
    assert c.inst_rows <= c.slab_tests < slots * c.wide_rows
    assert 0 < c.rows_touched <= tscene.wide_rows.shape[0]
    # visits per row and per lane: both sum to the row visits; a row is
    # touched where it has a visit, and every active lane's root row has one
    visits = c.row_visits
    assert visits.shape == (tscene.wide_rows.shape[0],)
    assert int(visits.sum()) == c.wide_rows + c.leaf_rows + c.inst_rows
    assert int((visits > 0).sum()) == c.rows_touched
    active = t(_mode("inactive_lanes")[2])
    root = root_cursor(tscene, base[2][1], _octant(base[3][1]))
    assert (visits[root[active] >> {"w8": 3, "w16": 4, "s8": 3}[layout]] > 0).all()
    steps = c.lane_steps
    assert steps.dtype == torch.int32 and int(steps.sum()) == int(visits.sum())
    assert (steps[~active] == 0).all() and (steps[active] > 0).all()


def test_root_cursor_with_a_base(wide, base):
    """A frame packer ships a tail-only root table and its base: the root
    cursors are the same."""
    _, tscene, _ = wide
    _, _, handles, rays, _ = base
    off = int(handles[1][0])
    octs = torch.arange(R, dtype=torch.int32) % 8
    ref = root_cursor(tscene, handles[1], octs)
    tail = tscene._replace(
        wide_root=tscene.wide_root[off:].contiguous(),
        wide_root_base=torch.tensor([off], dtype=torch.int32),
    )
    assert torch.equal(root_cursor(tail, handles[1], octs), ref)
    hit_a, _ = wide_ray_query_plain(
        tail, *handles, *rays, 0.0, 1e9, torch.ones(R, dtype=torch.bool)
    )
    hit_b, _ = wide_ray_query_plain(
        tscene, *handles, *rays, 0.0, 1e9, torch.ones(R, dtype=torch.bool)
    )
    assert torch.equal(hit_a.thit, hit_b.thit) and torch.equal(hit_a.prim, hit_b.prim)
