"""The animated scene's host code (scene/animation.py, scene/loader.py)
against the JAX package's, on the CPU, from stand-in meshes
(scene/standins.py) and the repo's generated terrain.

Tolerances. The animation track, the loaded meshes and BLASes, the
cameras, lights, subframe grid and the frame's instances: equal, bit for
bit. The placement: the same mesh for every instance, the rotations equal,
the translations within rtol 1e-6 / atol 1e-4. A placed position is
origin + dir * thit on a ray cast from y = 200; the two packages' walks
find the same triangle and barycentrics on every ray, but JAX's thit
differs by a few ulps of a ray ~200 long, which moved a position by up to
6.1e-5 on these stand-ins. The share of bit-equal instance transforms is
held at its measured 71 % (a change of either walk's arithmetic moves it).

Why (traced): the cause is JAX's XLA:CPU arithmetic, not the port. JAX's
own placement cast run op by op (``jax.disable_jit``, every op rounded on
its own) equals the port's bit for bit on all 1,024 rays
(``test_placement_is_jax_op_by_op``). Its compiled loop contracts the
triangle test (ops/traversal.py ``_tri_intersect``; reference
math.hh:358-401) into FMAs: every component of ``uvw = cross(y3, x3)`` as
``fma(a, b, -(c * d))``, and ``t``'s dot product as ``fma(wz, qz, fma(wx,
qx, wy * qy))``; that emulation gives the compiled ``thit`` on all 294
rays where it differs. First lane: ray 0 (origin (-92.04409, 200,
13.728508), tri_pos row 7489), where the first op that differs is ``wy =
y3.z * x3.x - y3.x * x3.z`` (IEEE -0.5654682, contracted -0.56546825), and
``thit`` 198.60582 becomes 198.60585. The port's IEEE walk is what the
oracle's goldens require, so the tolerance stays.
One JAX compile: the placement's ``ray_query`` in JAX's ``load_scene``."""

import copy
import dataclasses

import jax
import numpy as np
import pytest

from pathtracing_tpu.scene import animation as janim
from pathtracing_tpu.scene import loader as jloader
from pathtracing_tpu_torch.config import PRODUCTION, TESTING
from pathtracing_tpu_torch.scene import animation as tanim
from pathtracing_tpu_torch.scene import loader as tloader
from pathtracing_tpu_torch.scene.standins import TREES, write_standins

CFG = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=16)
FRAMES = (0, 1000, 1750, 1799)


def test_track_matches_jax_and_keeps_its_quirks():
    ts = np.concatenate([np.arange(0.0, 1800.0, 3.7), [140.0, 1104.5, 1107.0, 1799.0]])
    for t in ts:
        a, b = tanim.initial_frame_state(), janim.initial_frame_state()
        tanim.play_animation_track(a, t)
        janim.play_animation_track(b, t)
        assert a.keys() == b.keys()
        for k in a:
            assert type(a[k]) is np.float32 and a[k].tobytes() == b[k].tobytes(), (t, k)
    state = lambda t: (tanim.play_animation_track(s := tanim.initial_frame_state(), t), s)[1]
    # a duration of 0 snaps
    assert state(140.0)["cam_pos_x"] == np.float32(-11.6)
    # the walk stops at the first start > t: the (1104, ...) stops after the
    # (1105, ...) one are unreachable in [1104, 1105)
    assert state(1104.5)["bunny_pos_x"] == np.float32(-34.5)
    f = np.float32
    lt = f(f(3.0) / f(5.0))
    assert state(1107.0)["bunny_pos_x"] == f(f(-34.5) * (f(1.0) - lt) + f(-25.5) * lt)
    assert tloader.get_animation_frame_count(PRODUCTION) == 1800


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("standins"))
    paths = write_standins(d)
    assert sorted(paths) == sorted(tloader.MESH_ORDER[1:]) and len(paths) == 17
    assert set(TREES) <= set(paths)
    return (d, tloader.load_scene(data_dir=d, config=CFG, device="cpu"),
            jloader.load_scene(data_dir=d, config=CFG))


def _name_of(s):
    return {b.node_offset: k for k, (_, b) in s.meshes.items()}


def test_load_scene_matches_jax(loaded):
    _, ts, js = loaded
    for a, b in zip(ts.mesh_buf.arrays(), js.mesh_buf.arrays()):
        assert a.tobytes() == b.tobytes()  # the terrain recoloured alike
    assert ts.bvh_buf.nodes.tobytes() == js.bvh_buf.nodes.tobytes()
    assert ts.bvh_buf.links.tobytes() == js.bvh_buf.links.tobytes()
    assert list(ts.meshes) == list(js.meshes) == tloader.MESH_ORDER
    assert ts.static_instance_count == js.static_instance_count == len(ts.instances)
    names = [_name_of(ts)[i.blas.node_offset] for i in ts.instances]
    assert names == [_name_of(js)[i.blas.node_offset] for i in js.instances]
    assert names[0] == "terrain" and 500 < len(names) <= 1 + tloader.OBJECT_COUNT
    T = np.stack([i.transform for i in ts.instances])
    J = np.stack([i.transform for i in js.instances])
    np.testing.assert_array_equal(T[:, :3, :3], J[:, :3, :3])  # rotations
    np.testing.assert_array_equal(T[:, :, 3], J[:, :, 3])
    np.testing.assert_allclose(T[:, 3, :3], J[:, 3, :3], rtol=1e-6, atol=1e-4)
    share = float((T == J).all((1, 2)).mean())
    assert 0.65 < share < 0.8, share
    for i, j in zip(ts.instances, js.instances):
        assert (i.blas.node_offset, i.blas.node_count) == (j.blas.node_offset, j.blas.node_count)


def test_setup_animation_frame_matches_jax(loaded):
    _, ts, js = loaded
    ts, js = copy.deepcopy(ts), copy.deepcopy(js)
    for frame in FRAMES:
        tloader.setup_animation_frame(ts, frame, CFG)
        jloader.setup_animation_frame(js, frame, CFG)
        assert ts.subframe_entries == js.subframe_entries
        assert ts.frame_static_end == js.frame_static_end
        assert len(ts.subframes) == len(js.subframes) == CFG.subframe_count
        for a, b in zip(ts.subframes, js.subframes):
            assert (a.tlas.node_count, a.tlas.node_offset) == (b.tlas.node_count,
                                                               b.tlas.node_offset)
            for x, y in ((a.cam, b.cam), (a.light, b.light)):
                for k, v in x.__dict__.items():
                    assert np.asarray(v).tobytes() == np.asarray(getattr(y, k)).tobytes(), k
        n_static = ts.static_instance_count
        frame_t = [i.transform for i in ts.instances[n_static:]]
        frame_j = [i.transform for i in js.instances[n_static:]]
        assert len(frame_t) == len(frame_j) > 0
        for a, b in zip(frame_t, frame_j):
            assert a.tobytes() == b.tobytes()
        assert len(ts.bvh_buf.nodes) == len(js.bvh_buf.nodes)
        names = {_name_of(ts)[i.blas.node_offset] for i in ts.instances[n_static:]}
        if frame == 1000:
            # the bunny and the dragon in view, at aperture 0.4
            assert {"buddha", "teapot", "bunny", "dragon"} <= names
            assert ts.subframes[0].cam.aperture_radius == np.float32(0.4)


def test_placement_is_jax_op_by_op(loaded):
    """The placement casts through both packages' ``_terrain_trace_batch``
    on the loaded scene's terrain: the port's hits, positions and normals
    equal JAX's op-by-op run bit for bit (JAX's compiled run differs on
    some positions: the module docstring)."""
    from pathtracing_tpu.accel.builder_py import build_tlas as jbuild_tlas
    from pathtracing_tpu_torch.accel.builder_py import build_tlas as tbuild_tlas

    _, ts, js = loaded
    ts, js = copy.deepcopy(ts), copy.deepcopy(js)
    f32 = np.float32
    us = tloader._placement_uniforms()
    origins = np.stack([us[:, 0] * f32(200.0) - f32(100.0), np.full(len(us), 200.0, f32),
                        us[:, 1] * f32(200.0) - f32(100.0)], -1).astype(f32)
    dirs = np.tile(np.array([0.0, -1.0, 0.0], f32), (len(us), 1))
    mine = tloader._terrain_trace_batch(
        ts, tbuild_tlas(ts.instances[:1], [0], ts.bvh_buf.nodes, ts.bvh_buf), origins, dirs,
        "cpu")
    with jax.disable_jit():
        theirs = jloader._terrain_trace_batch(
            js, jbuild_tlas(js.instances[:1], [0], js.bvh_buf.nodes, js.bvh_buf), origins,
            dirs)
    for a, b in zip(mine, theirs):
        assert a.tobytes() == b.tobytes()
    assert 900 < mine[0].sum() < len(us)  # water and misses rejected


def test_sun_sets(loaded):
    """The sunset curve: the sun stands high mid-animation and below the
    horizon on the last frame."""
    _, ts, _ = loaded
    ts = copy.deepcopy(ts)
    tloader.setup_animation_frame(ts, 900, CFG)
    assert all(sf.light.direction[1] > 0.9 for sf in ts.subframes)
    tloader.setup_animation_frame(ts, tloader.get_animation_frame_count(CFG) - 1, CFG)
    assert all(sf.light.direction[1] < 0 for sf in ts.subframes)


def test_load_scene_needs_a_mesh_folder(monkeypatch):
    monkeypatch.delenv("PT_DATA_DIR", raising=False)
    with pytest.raises(ValueError, match="data_dir"):
        tloader.load_scene(config=CFG, device="cpu")
