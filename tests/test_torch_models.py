"""The port's scene assembly vs the JAX package's, on the CPU: SceneBuilder
and rebuild_static_tlas, the model presets, and the large procedural
scene's recipe at a small size; every packed table byte-equal, for both
table kinds; a small frame of the port's own build bit-equal to its frame of
the JAX build carried across. Host code on both sides: the only JAX work is
packing, and no JAX render runs."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from pathtracing_tpu import models as jmodels
from pathtracing_tpu.scene import builder as jbuilder
from pathtracing_tpu_torch import models as tmodels
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.convert import scene_from_jax
from pathtracing_tpu_torch.render import render_frame
from pathtracing_tpu_torch.scene import builder as tbuilder
from pathtracing_tpu_torch.scene import large_scene
from pathtracing_tpu_torch.scene.device import binary_tables
from pathtracing_tpu_torch.testing import assert_same_tables
from pathtracing_tpu_torch.utils import native_build

ROOT = pathlib.Path(__file__).resolve().parent.parent
OBJS = {"ground": ROOT / "assets" / "golden" / "ground.obj",
        "pine_tree": ROOT / "assets" / "generated" / "pine_tree.obj",
        "bunny": ROOT / "assets" / "generated" / "bunny.obj"}
CFG = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=1)
SMALL_N, SMALL_COUNT = 24, 16  # the large scene's recipe, cut to size


def _fields(jscene):
    return {k: np.asarray(v) for k, v in jscene._asdict().items() if v is not None}


def _describe(b):
    for name in ("ground", "pine_tree", "bunny"):
        b.add_mesh(name, str(OBJS[name]))
    b.add_instance("ground", scale=(0.5, 1.0, 0.5))
    b.add_instance("pine_tree", pos=(1.0, 0.0, -2.0), pitch_yaw_roll=(0.0, 30.0, 0.0))
    b.add_instance("bunny", pos=(-1.0, 0.0, -1.0), scale=(2.0, 2.0, 2.0))
    b.add_instance("bunny", transform=np.eye(4, dtype=np.float32))
    b.set_camera(position=(0, 3, 8), pitch_yaw_roll=(15, 0, 0), fov=55)
    return b


@pytest.mark.parametrize("wide", [False, True], ids=["binary", "w8"])
def test_scene_builder_and_rebuild_match_jax(wide):
    """SceneBuilder.build on the repo's OBJs (the default light included),
    then rebuild_static_tlas after moving, adding and removing instances."""
    tb, jb = _describe(tbuilder.SceneBuilder()), _describe(jbuilder.SceneBuilder())
    ts, tdev = tb.build(CFG, wide=wide, device="cpu")
    js, jdev = jb.build(CFG, wide=wide)
    assert_same_tables(tdev, jdev)
    assert ts.static_instance_count == js.static_instance_count == 4
    assert len(ts.subframes) == CFG.subframe_count
    for s in (ts, js):
        s.instances[1].transform[3, :3] = (2.0, 0.5, -3.0)
        s.instances.append(s.instances[2])
        del s.instances[0]
    assert_same_tables(tbuilder.rebuild_static_tlas(ts, CFG, device="cpu"),
                       jbuilder.rebuild_static_tlas(js, CFG))
    assert ts.bvh_buf.nodes.tobytes() == js.bvh_buf.nodes.tobytes()


def test_scene_builder_refusals():
    b = tbuilder.SceneBuilder()
    with pytest.raises(ValueError, match="no instances"):
        b.build(CFG, device="cpu")
    _describe(b)
    # emissive_nee=True on meshes with no emissive vertex: no light tables,
    # as in the JAX package
    assert b.build(CFG, emissive_nee=True, device="cpu")[1].lt_tris is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _describe(tbuilder.SceneBuilder()).build(CFG)


@pytest.mark.parametrize("wide", [False, True], ids=["binary", "w8"])
@pytest.mark.parametrize("name,kwargs", [
    ("sphere_ground", {"sphere_pos": (0.3, 1.2, -0.5)}),
    ("cornell_box", {"emissive_nee": False}),
    ("cornell_box", {}),  # the default: the area-light tables
])
def test_presets_match_jax(name, kwargs, wide, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ts, tdev = tmodels.build(name, CFG, asset_dir=str(tmp_path / "t"), wide=wide,
                             device="cpu", **kwargs)
    js, jdev = jmodels.build(name, CFG, asset_dir=str(tmp_path / "j"), wide=wide, **kwargs)
    assert_same_tables(tdev, jdev)
    assert len(ts.instances) == len(js.instances)


def test_preset_registry(monkeypatch):
    assert tmodels.names() == ["cornell_box", "full_animation", "sphere_ground",
                               "teapot_rocks"]
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.build("no_such_model", CFG, device="cpu")
    # the reference's meshes come from a folder the caller names
    monkeypatch.delenv("PT_DATA_DIR", raising=False)
    with pytest.raises(ValueError, match="data_dir"):
        tmodels.build("full_animation", CFG, device="cpu")
    # the Cornell box's default packs the area-light tables (the ceiling
    # panel's two triangles)
    _, dev = tmodels.build("cornell_box", CFG, device="cpu")
    assert dev.lt_tris.shape == (2, 9) and dev.lt_cdf.shape == (2,)


@pytest.fixture(scope="module")
def large_small(tmp_path_factory):
    """The large scene's recipe at n = 24 with 16 instances, by the port's
    large_scene.build, and by a SceneBuilder of either package described as
    the recipe describes it on the same files."""
    d = tmp_path_factory.mktemp("large")
    native_build.reset_builds()
    s, dev, sec = large_scene.build(d, CFG, n=SMALL_N, count=SMALL_COUNT, wide=True,
                                    device="cpu")
    builds = dict(native_build.builds)
    paths = large_scene.write_files(d, SMALL_N)

    def builder(pkg):
        """A fresh SceneBuilder (a builder's TLAS goes into its buffers at
        each build)."""
        b = pkg.SceneBuilder()
        large_scene.describe(b, paths, large_scene.placements(SMALL_COUNT))
        return b

    return (s, dev, sec, builds), builder


def test_large_scene_recipe_matches_jax(large_small):
    (s, dev, sec, builds), builder = large_small
    assert set(sec) == {"write", "load", "blas", "tlas", "binary_pack", "wide_pack"}
    assert all(v >= 0 for v in sec.values())
    assert builds == {"obj_native": 3, "bvh_native": 4, "wide_native": 2}
    assert len(s.instances) == SMALL_COUNT + 1
    assert dev.tri_pos.shape[0] == 2 * (SMALL_N - 1) ** 2 + 2 + 46 + 704
    ts, tdev = builder(tbuilder).build(CFG, wide=True, device="cpu")
    js, jdev = builder(jbuilder).build(CFG, wide=True)
    assert_same_tables(dev, tdev)
    assert_same_tables(tdev, jdev)
    assert binary_tables(dev).wide_rows is None
    # the binary tables alone, as SceneBuilder.build(wide=False) packs them
    _, jbin = builder(jbuilder).build(CFG, wide=False)
    assert_same_tables(binary_tables(dev), jbin)
    # the placed objects are whole meshes (vertex normals, slashed faces):
    # the pine 5.2 units wide, not a sliver
    pine = s.meshes["pine_tree"][0]
    ppos = s.mesh_buf.arrays()[1][pine.base_vertex_offset:][:pine.vertex_count]
    np.testing.assert_allclose(np.ptp(ppos[:, 0]), 5.2, atol=1e-3)


def test_own_build_renders_as_the_jax_build(large_small):
    """A 16x9 x 1 spp frame of the port's own large-scene build is bit-equal
    to its frame of the JAX package's build carried across, on both table
    kinds."""
    (s, dev, sec, builds), builder = large_small
    js, jdev = builder(jbuilder).build(CFG, wide=True)
    theirs = scene_from_jax(_fields(jdev), device="cpu")
    for own, other in ((dev, theirs), (binary_tables(dev), binary_tables(theirs))):
        a, ai = render_frame(CFG, own, device="cpu")
        b, bi = render_frame(CFG, other, device="cpu")
        assert np.isfinite(a).all() and a.tobytes() == b.tobytes() and ai.tobytes() == bi.tobytes()
