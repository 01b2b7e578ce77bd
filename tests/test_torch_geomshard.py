"""Geometry sharding (parallel/geomshard.py) on the CPU. The JAX
package's own test_geomshard.py needs the reference's meshes, which the
repo does not have; its scene is mirrored here from generated meshes (the
large scene's pine and bunny, written with normals, and the golden ground
plane) at its scale: a ground and five instances within |x| <= 5, built by
each package's SceneBuilder from the same files.

The numpy parts are byte-equal to the JAX package's: the assignment, the
TLAS leaf ids, and each shard's tables equal to the JAX shard's rows, whose
padding (JAX stacks the shards, zero-padded to the largest) is all zeros.
The geometry-sharded sums are held to one JAX ``make_geom_sharded_render``
on 2 virtual CPU devices under the JAX bar (> 97 % within 2e-4 +
2e-4·|ref|) and to the port's own replicated scan (measured: equal). The
large scene's recipe at n = 24 with 16 instances (terrain coordinates to
130) is sharded too, against the port's scan only: there the two
packages' scans themselves agree on 95.5-96.5 % of lanes (ROADMAP.md queue
3, A5: XLA:CPU contracts FMAs), below that bar, with or without sharding.
A mesh names the ``"cpu"`` device once per shard. One JAX call."""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.parallel import geomshard as jgeom
from pathtracing_tpu.scene import builder as jbuilder
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.parallel.geomshard import (
    _compact_shard,
    assign_instances,
    build_shard_scenes,
    make_geom_sharded_render,
    tlas_leaf_ids,
)
from pathtracing_tpu_torch.parallel.sharding import Mesh
from pathtracing_tpu_torch.render import _render_tile
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import large_scene
from pathtracing_tpu_torch.testing import n, stack

KW = dict(image_width=64, image_height=36, max_bounces=2)
CFG = dataclasses.replace(TESTING, **KW)
JCFG = dataclasses.replace(JTESTING, **KW)
N_TERRAIN, COUNT, SPP = 24, 16, 1
RAYS = 128
GROUND = pathlib.Path(__file__).resolve().parent.parent / "assets" / "golden" / "ground.obj"
INSTANCES = [("ground", {}), ("bunny", {"scale": (2, 2, 2)}), ("pine", {"pos": (4, 0, 0)}),
             ("bunny", {"pos": (-4, 0, 1), "pitch_yaw_roll": (0, 60, 0)}),
             ("pine", {"pos": (0, 0, -5), "scale": (1.5, 1.5, 1.5)}),
             ("bunny", {"pos": (3, 1, 4), "pitch_yaw_roll": (0, 120, 0)})]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return large_scene.write_files(tmp_path_factory.mktemp("large"), N_TERRAIN)


@pytest.fixture(scope="module")
def built(files):
    """(port host scene, port replicated SceneDevice), (JAX host scene, its
    SceneDevice), of the JAX test's scene from the same files."""

    def build(pkg, **kw):
        b = pkg.SceneBuilder()
        b.add_mesh("ground", str(GROUND))
        b.add_mesh("pine", files["pine_tree"])
        b.add_mesh("bunny", files["bunny"])
        for name, where in INSTANCES:
            b.add_instance(name, **where)
        b.set_camera(position=(0, 4, 12), pitch_yaw_roll=(15, 0, 0), fov=60)
        b.set_light(direction=(0.3, 1, 0.5), color=(4, 4, 4))
        return b.build(**kw)

    return (build(tbuilder, config=CFG, wide=False, device="cpu"),
            build(jbuilder, config=JCFG, wide=False))


def _pixels():
    rng = np.random.default_rng(3)
    return (rng.integers(0, CFG.image_width, RAYS).astype(np.int32),
            rng.integers(0, CFG.image_height, RAYS).astype(np.int32))


def _geom_mesh(shards, tiles=None):
    devs = np.array([torch.device("cpu")] * (shards * (tiles or 1)), dtype=object)
    if tiles:
        return Mesh(devs.reshape(shards, tiles), ("geom", "tiles"))
    return Mesh(devs, ("geom",))


@pytest.fixture(scope="module")
def scan(built):
    (_, dev), _ = built
    xs, ys = _pixels()
    return stack(_render_tile(CFG, dev, torch.from_numpy(xs), torch.from_numpy(ys), SPP))


def _within_bar(got, ref):
    finite = np.isfinite(ref).all(-1)
    assert finite.mean() > 0.99
    close = (np.abs(got[finite] - ref[finite]) <= 2e-4 + 2e-4 * np.abs(ref[finite])).all(-1)
    assert close.mean() > 0.97, close.mean()


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_assignment_and_leaf_ids_match_jax(built, shards):
    (ts, _), (js, _) = built
    got = assign_instances(ts, shards)
    np.testing.assert_array_equal(got, jgeom.assign_instances(js, shards))
    assert got.shape == (len(INSTANCES),) and set(got) <= set(range(shards))
    np.testing.assert_array_equal(
        tlas_leaf_ids(ts.bvh_buf.links, ts.subframes[0].tlas),
        jgeom.tlas_leaf_ids(js.bvh_buf.links, js.subframes[0].tlas))
    assert len(tlas_leaf_ids(ts.bvh_buf.links, ts.subframes[0].tlas)) == len(INSTANCES)


def test_shard_tables_match_jax_and_compact(built):
    (ts, dev), (js, _) = built
    shards, assign = build_shard_scenes(ts, CFG, 2, device="cpu")
    stacked, jassign = jgeom.build_shard_scenes(js, JCFG, 2)
    np.testing.assert_array_equal(assign, jassign)
    for s, sc in enumerate(shards):
        for name in sc._fields:
            mine, theirs = getattr(sc, name), getattr(stacked, name)
            assert (mine is None) == (theirs is None), name
            if mine is None:
                continue
            theirs = np.asarray(theirs[s])
            rows = mine.shape[0]
            assert n(mine).tobytes() == theirs[:rows].tobytes(), (s, name)
            assert not theirs[rows:].view(np.uint8).any(), (s, name)
        # compaction: the shard's instances only, and only their meshes
        mine = np.nonzero(assign == s)[0].tolist()
        assert sc.inst_u.shape[0] == max(len(mine), 1)
        arrays = _compact_shard(ts, mine)[0]
        assert sc.tri_pos.shape[0] == max(len(arrays[0]) // 3, 1) < dev.tri_pos.shape[0]
        assert sc.vattr.shape[0] == max(len(arrays[1]), 1) < dev.vattr.shape[0]


def test_geom_sharded_matches_jax_and_scan(built, scan):
    (ts, _), (js, _) = built
    xs, ys = _pixels()
    shards, _ = build_shard_scenes(ts, CFG, 2, device="cpu")
    got = stack(make_geom_sharded_render(CFG, _geom_mesh(2), SPP)(shards, xs, ys))
    stacked, _ = jgeom.build_shard_scenes(js, JCFG, 2)
    jfn = jgeom.make_geom_sharded_render(JCFG, JMesh(np.array(jax.devices()[:2]), ("geom",)),
                                         SPP)
    ref = stack(jfn(stacked, jnp.asarray(xs), jnp.asarray(ys)))
    _within_bar(got, ref)
    _within_bar(got, scan)
    assert (got == scan).all(-1).mean() > 0.97


@pytest.mark.parametrize("shards", [4, len(INSTANCES) + 3])
def test_more_shards_than_busy_shards(built, scan, shards):
    """From 4 shards on, the greedy assignment leaves shards without an
    instance (the pine's and the bunny's BLASes each stay resident on one
    shard): their tables have no node row, and every subframe's TLAS there
    has no node, so each of their rays exhausts at once."""
    (ts, _), _ = built
    shard_scenes, assign = build_shard_scenes(ts, CFG, shards, device="cpu")
    empty = [s for s in range(shards) if not (assign == s).any()]
    assert empty and all(shard_scenes[s].nl8.shape[0] == 0 for s in empty)
    assert all(int(shard_scenes[s].sf_tlas_count.max()) == 0 for s in empty)
    xs, ys = _pixels()
    got = stack(make_geom_sharded_render(CFG, _geom_mesh(shards), SPP)(shard_scenes, xs, ys))
    _within_bar(got, scan)


def test_geom_and_tiles_mesh(built):
    """A (geom 2, tiles 2) mesh splits the rays over the tiles: the same
    sums as the geometry-only mesh, bit for bit."""
    (ts, _), _ = built
    shards, _ = build_shard_scenes(ts, CFG, 2, device="cpu")
    xs, ys = _pixels()
    ref = stack(make_geom_sharded_render(CFG, _geom_mesh(2), SPP)(shards, xs, ys))
    got = stack(make_geom_sharded_render(CFG, _geom_mesh(2, tiles=2), SPP,
                                         tile_axis="tiles")(shards, xs, ys))
    assert got.tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="mesh"):
        make_geom_sharded_render(CFG, _geom_mesh(2, tiles=2), SPP)
    with pytest.raises(ValueError, match="3 shard scenes"):
        make_geom_sharded_render(CFG, _geom_mesh(2), SPP)(shards + shards[:1], xs, ys)


def test_area_light_scenes_are_refused(built):
    (ts, _), _ = built
    shards, _ = build_shard_scenes(ts, CFG, 2, device="cpu")
    lit = [sc._replace(lt_tris=torch.zeros((1, 9))) for sc in shards]
    xs, ys = _pixels()
    with pytest.raises(NotImplementedError, match="area-light"):
        make_geom_sharded_render(CFG, _geom_mesh(2), SPP)(lit, xs, ys)


def test_large_recipe_sharded_equals_scan(files):
    """The large scene's recipe (terrain, 8 pines, 8 bunnies) over 2 and 4
    shards (the terrain alone on shard 0; at 4 one shard without
    instances): equal to the port's replicated scan."""
    b = tbuilder.SceneBuilder()
    large_scene.describe(b, files, large_scene.placements(COUNT))
    ts, dev = b.build(CFG, wide=False, device="cpu")
    xs, ys = _pixels()
    ref = stack(_render_tile(CFG, dev, torch.from_numpy(xs), torch.from_numpy(ys), SPP))
    for shards in (2, 4):
        shard_scenes, assign = build_shard_scenes(ts, CFG, shards, device="cpu")
        assert (assign == 0).sum() == 1  # the terrain
        got = stack(make_geom_sharded_render(CFG, _geom_mesh(shards), SPP)(
            shard_scenes, xs, ys))
        assert got.tobytes() == ref.tobytes()
