"""Plain version of the ray-query kernel vs JAX ``ray_query``, vs the Pallas
kernel in interpret mode, and vs the oracle's rays.gold.

Tolerances: ``occluded`` and hit/miss equal; ``inst``/``prim`` equal on
>= 99.8 % of hit rays and ``thit`` within rtol=2e-5, atol=1e-5 — XLA:CPU
contracts mul+add into FMA inside its compiled loop, eager PyTorch rounds
every op, so equal-t ties between coincident triangles may resolve the other
way (the allowance of tests/test_traversal.py). Barycentrics, where ids agree:
rtol=1e-4, atol=1e-5 against XLA's results (differences of products, which
contraction moves by more ulps), rtol=2e-5, atol=2e-6 against the oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops.pallas_traversal import ray_query_pallas
from pathtracing_tpu.ops.traversal import ray_query as jax_ray_query
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.ops.traversal import ray_query, ray_query_plain
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, t, vec3_t

import golden_scene as jgolden

R = 1000  # not a multiple of the Pallas block: exercises its padding


@pytest.fixture(scope="module")
def setup():
    scene_g = golden("scene.gold")
    return (
        scene_g,
        golden("rays.gold"),
        scene_device_from_golden(scene_g, device="cpu"),
        jgolden.scene_device_from_golden(scene_g),
    )


def _mode(name, r):
    """(tmin, tmax0, active, anyhit) as numpy / Python values for a mode."""
    rs = np.random.default_rng(11)
    on = np.ones(r, bool)
    mask = rs.random(r) < 0.5
    some = rs.random(r) < 0.7
    tmax_lane = rs.uniform(0.5, 40.0, r).astype(np.float32)
    return {
        "closest": (0.0, 1e9, on, False),
        "anyhit": (1e-4, 1e9, on, True),
        "mixed_mask": (1e-4, 1e9, on, mask),
        "inactive_lanes": (0.0, 1e9, some, False),
        "inactive_mixed": (1e-4, 1e9, some, mask),
        "tmax_per_lane": (1e-4, tmax_lane, on, False),
        "tmax_per_lane_anyhit": (1e-4, tmax_lane, some, True),
    }[name]


def _torch_query(scene, scene_g, rays_g, r, tmin, tmax0, active, anyhit):
    full = lambda v: torch.full((r,), int(v), dtype=torch.int32)
    lane = lambda a: t(a) if isinstance(a, np.ndarray) else a
    return ray_query(
        scene, full(scene_g["tlas"][0]), full(scene_g["tlas"][1]),
        vec3_t(rays_g["origins"][:r]), vec3_t(rays_g["dirs"][:r]),
        tmin, lane(tmax0), t(active), lane(anyhit),
    )


def _jax_args(jscene, scene_g, rays_g, r, tmin, tmax0, active):
    lane = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    return (
        jscene,
        jnp.full(r, int(scene_g["tlas"][0]), jnp.int32),
        jnp.full(r, int(scene_g["tlas"][1]), jnp.int32),
        JVec3(*(jnp.asarray(rays_g["origins"][:r, i]) for i in range(3))),
        JVec3(*(jnp.asarray(rays_g["dirs"][:r, i]) for i in range(3))),
        tmin, lane(tmax0), jnp.asarray(active),
    )


def _assert_agree(hit_t, occ_t, hit_j, occ_j):
    np.testing.assert_array_equal(n(occ_t), n(occ_j))
    thit_t, thit_j = n(hit_t.thit), n(hit_j.thit)
    np.testing.assert_array_equal(thit_t < 0, thit_j < 0)
    h = thit_j >= 0
    np.testing.assert_allclose(thit_t[h], thit_j[h], rtol=2e-5, atol=1e-5)
    same = (n(hit_t.inst) == n(hit_j.inst)) & (n(hit_t.prim) == n(hit_j.prim))
    assert (h & ~same).sum() <= 0.002 * max(h.sum(), 1), (h & ~same).sum()
    np.testing.assert_array_equal(n(hit_t.inst)[~h], -1)
    np.testing.assert_array_equal(n(hit_t.prim)[~h], 0)
    exact = h & same
    np.testing.assert_array_equal(n(hit_t.back)[exact], n(hit_j.back)[exact])
    # barycentrics come from differences of products (the cross product of
    # the sheared edges): FMA contraction on the XLA side moves them by more
    # ulps than it moves t
    for k in ("bary_u", "bary_v", "bary_w"):
        np.testing.assert_allclose(
            n(getattr(hit_t, k))[exact], n(getattr(hit_j, k))[exact],
            rtol=1e-4, atol=1e-5,
        )


@pytest.mark.parametrize(
    "mode",
    ["closest", "anyhit", "mixed_mask", "inactive_lanes", "inactive_mixed",
     "tmax_per_lane", "tmax_per_lane_anyhit"],
)
def test_plain_matches_jax_ray_query(setup, mode):
    scene_g, rays_g, tscene, jscene = setup
    tmin, tmax0, active, anyhit = _mode(mode, R)
    hit_t, occ_t = _torch_query(tscene, scene_g, rays_g, R, tmin, tmax0, active, anyhit)
    ja = jnp.asarray(anyhit) if isinstance(anyhit, np.ndarray) else anyhit
    hit_j, occ_j = jax_ray_query(
        *_jax_args(jscene, scene_g, rays_g, R, tmin, tmax0, active), anyhit=ja
    )
    _assert_agree(hit_t, occ_t, hit_j, occ_j)
    if not active.all():
        assert (n(hit_t.thit)[~active] == -1).all() and not n(occ_t)[~active].any()


@pytest.mark.parametrize(
    "mode", ["closest", "anyhit", "inactive_lanes", "tmax_per_lane", "tmax_per_lane_anyhit"]
)
def test_plain_matches_pallas_interpret(setup, mode):
    """The TPU kernel the CUDA kernel replaces, run as tests/test_pallas.py
    runs it on the CPU (interpret mode, block 256; it takes a uniform anyhit)."""
    scene_g, rays_g, tscene, jscene = setup
    tmin, tmax0, active, anyhit = _mode(mode, R)
    hit_t, occ_t = _torch_query(tscene, scene_g, rays_g, R, tmin, tmax0, active, anyhit)
    hit_p, occ_p = ray_query_pallas(
        *_jax_args(jscene, scene_g, rays_g, R, tmin, tmax0, active),
        anyhit=anyhit, block=256, interpret=True,
    )
    _assert_agree(hit_t, occ_t, hit_p, occ_p)


def test_closest_hit_matches_oracle_all_rays(setup):
    scene_g, rays_g, tscene, jscene = setup
    r = len(rays_g["origins"])
    hit, _ = _torch_query(tscene, scene_g, rays_g, r, 0.0, 1e9, np.ones(r, bool), False)
    miss_ref = rays_g["thit"] < 0
    np.testing.assert_array_equal(n(hit.thit) < 0, miss_ref)
    h = ~miss_ref
    np.testing.assert_allclose(n(hit.thit)[h], rays_g["thit"][h], rtol=2e-5, atol=1e-5)
    same = (n(hit.inst) == rays_g["inst"].view(np.int32)) & (
        n(hit.prim) == rays_g["prim"].view(np.int32)
    )
    diff = h & ~same
    assert diff.mean() <= 0.002, f"{diff.sum()} id mismatches"
    # no FMA contraction here, as in the oracle: ids are expected to match it
    # at least as well as the JAX package's do
    hit_j, _ = jax_ray_query(
        *_jax_args(jscene, scene_g, rays_g, r, 0.0, 1e9, np.ones(r, bool))
    )
    same_j = (n(hit_j.inst) == rays_g["inst"].view(np.int32)) & (
        n(hit_j.prim) == rays_g["prim"].view(np.int32)
    )
    assert diff.sum() <= (h & ~same_j).sum()
    exact = h & same
    np.testing.assert_array_equal(
        n(hit.back)[exact].astype(np.uint32), rays_g["back"][exact]
    )
    np.testing.assert_allclose(
        n(hit.bary_u)[exact], rays_g["bary"][exact, 0], rtol=2e-5, atol=2e-6
    )
    np.testing.assert_allclose(
        n(hit.bary_v)[exact], rays_g["bary"][exact, 1], rtol=2e-5, atol=2e-6
    )


def test_anyhit_matches_oracle_all_rays(setup):
    scene_g, rays_g, tscene, _ = setup
    r = len(rays_g["origins"])
    hit, occ = _torch_query(tscene, scene_g, rays_g, r, 1e-4, 1e9, np.ones(r, bool), True)
    np.testing.assert_array_equal(n(occ).astype(np.uint32), rays_g["occluded"])
    assert (n(hit.thit) == -1).all() and (n(hit.inst) == -1).all()


def test_counts_and_dispatch(setup):
    """CPU tensors take the plain version; its row-read counts are those of
    the walk (at least one node row per active ray, one tri row per hit)."""
    scene_g, rays_g, tscene, _ = setup
    r = 256
    full = lambda v: torch.full((r,), int(v), dtype=torch.int32)
    args = (
        tscene, full(scene_g["tlas"][0]), full(scene_g["tlas"][1]),
        vec3_t(rays_g["origins"][:r]), vec3_t(rays_g["dirs"][:r]),
        0.0, 1e9, torch.ones(r, dtype=torch.bool),
    )
    hit_a, occ_a = ray_query(*args)
    hit_b, occ_b, counts = ray_query_plain(*args, return_counts=True)
    for a, b in zip((*hit_a, occ_a), (*hit_b, occ_b)):
        assert torch.equal(a, b)
    n_hit = int((hit_b.thit >= 0).sum())
    assert counts.node_rows >= r and counts.tri_rows >= 2 * n_hit > 0
    assert counts.inst_rows >= 2 * n_hit
