"""Port's scene packing vs the JAX package's: every table byte-equal, and
``scene_from_jax`` carries a JAX scene across byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracing_tpu.scene import device as jdevice
from pathtracing_tpu_torch import convert
from pathtracing_tpu_torch.config import PRODUCTION, TESTING
from pathtracing_tpu_torch.convert import scene_from_jax
from pathtracing_tpu_torch.scene import golden as tgolden
from pathtracing_tpu_torch.scene.device import pack_scene
from pathtracing_tpu_torch.testing import assert_same_tables, golden, n

import golden_scene as jgolden


def _jax_fields(jscene) -> dict:
    return {k: np.asarray(v) for k, v in jscene._asdict().items() if v is not None}


def test_config_presets_equal_jax():
    from pathtracing_tpu import config as jconfig

    for name in ("TESTING", "PRODUCTION"):
        assert dataclasses.asdict(getattr(jconfig, name)) == dataclasses.asdict(
            {"TESTING": TESTING, "PRODUCTION": PRODUCTION}[name]
        )
    assert PRODUCTION.subframe_count == jconfig.PRODUCTION.subframe_count == 128


def test_golden_scene_tables_byte_equal():
    g = golden("scene.gold")
    assert_same_tables(
        tgolden.scene_device_from_golden(g, device="cpu"),
        jgolden.scene_device_from_golden(g),
    )


def test_tlas_instance_rows_equal_jax():
    """The packer's host handle: ``TlasInstance.create`` derives the inverse
    transform (GLM-order float32 cofactors) and the rows byte-equal the JAX
    package's."""
    from pathtracing_tpu.accel.types import BvhHandle as JBvh
    from pathtracing_tpu.io.obj import MeshHandle as JMesh
    from pathtracing_tpu.scene.device import _instance_rows as j_instance_rows
    from pathtracing_tpu.scene.types import TlasInstance as JTlasInstance
    from pathtracing_tpu_torch.accel.types import BvhHandle
    from pathtracing_tpu_torch.io.obj import MeshHandle
    from pathtracing_tpu_torch.scene.device import _instance_rows
    from pathtracing_tpu_torch.scene.types import TlasInstance

    g = golden("scene.gold")
    tinst, jinst = [], []
    for fu, ff in zip(g["instances_u"], g["instances_f"]):
        blas = dict(node_count=int(fu[0]), node_offset=int(fu[1]))
        mesh = dict(vertex_count=int(fu[2]), triangle_count=int(fu[3]),
                    index_offset=int(fu[4]), base_vertex_offset=int(fu[5]))
        xf = ff[:16].reshape(4, 4)
        tinst.append(TlasInstance.create(BvhHandle(**blas), MeshHandle(**mesh), xf))
        jinst.append(JTlasInstance.create(JBvh(**blas), JMesh(**mesh), xf))
    for a, b in zip(tinst, jinst):
        assert a.inv_transform.tobytes() == b.inv_transform.tobytes()
    for a, b in zip(_instance_rows(tinst), j_instance_rows(jinst)):
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype


def test_golden_scene_follows_config_subframes():
    g = golden("scene.gold")
    cfg = dataclasses.replace(TESTING, samples_per_pixel=8)
    ts = tgolden.scene_device_from_golden(g, cfg, device="cpu")
    assert ts.sf_cam.shape[0] == 1
    assert_same_tables(ts, jgolden.scene_device_from_golden(g, cfg))


def test_motion_scene_tables_byte_equal():
    g = golden("motion.gold")
    assert_same_tables(
        tgolden.scene_device_from_motion_golden(g, device="cpu"),
        jgolden.scene_device_from_motion_golden(g),
    )


def test_link_bit_patterns_survive_upload():
    """nl8[:, 6:8] are int32 links in float columns: subnormals and NaN
    patterns must come through bit for bit."""
    g = golden("scene.gold")
    ts = tgolden.scene_device_from_golden(g, device="cpu")
    links = n(ts.nl8)[:, 6:8].copy().view(np.uint32)
    seg = slice(8 * int(g["tlas"][1]), 8 * (int(g["tlas"][1]) + int(g["tlas"][0])))
    np.testing.assert_array_equal(links[seg], g["links"][seg])
    assert (links == 0xFFFFFFFF).any()  # the sentinel is a NaN pattern


@pytest.mark.parametrize("which", ["scene", "motion"])
def test_scene_from_jax_round_trips_byte_equal(which):
    if which == "scene":
        js = jgolden.scene_device_from_golden(golden("scene.gold"))
    else:
        js = jgolden.scene_device_from_motion_golden(golden("motion.gold"))
    assert_same_tables(scene_from_jax(_jax_fields(js), device="cpu"), js)


def test_scene_from_jax_refuses_tables_of_later_slices():
    js = jgolden.scene_device_from_golden(golden("scene.gold"))
    fields = _jax_fields(js)
    # the tables of once later slices come across: the bf16 node rows (S2,
    # tests/test_torch_bf16_nodes.py) and the hot rows (S10,
    # tests/test_torch_hotperm.py); no table is refused any more
    assert convert._LATER == ()
    assert scene_from_jax({**fields, "nl5": np.zeros((4, 5), np.float32)},
                          device="cpu").nl5.shape == (4, 5)
    hot = scene_from_jax({**fields, "hot_rows": np.arange(192, dtype=np.float32).reshape(4, 48),
                          "hot_planes": np.full((4, 192), -7, np.int8)}, device="cpu")
    assert n(hot.hot_rows).tobytes() == np.arange(192, dtype=np.float32).tobytes()
    assert hot.hot_planes.dtype == torch.int8 and int(hot.hot_planes.sum()) == -7 * 768
    with pytest.raises(KeyError):
        scene_from_jax({k: v for k, v in fields.items() if k != "vattr"}, device="cpu")
    with pytest.raises(KeyError):
        scene_from_jax({**fields, "not_a_field": np.zeros(1)}, device="cpu")


@pytest.mark.parametrize(
    "kw", [{"emissive_nee": True, "wide": True}, {"emissive_nee": True}]
)
def test_pack_scene_later_slices_raise(kw):
    """emissive_nee=True, once a later slice, packs as the JAX package's
    pack_scene does (no light tables without emissive triangles; the tables
    themselves are held to JAX's in tests/test_torch_arealights.py)."""
    g = golden("scene.gold")
    args = ((g["indices"], g["pos"], g["normal"], g["albedo"], g["material"]),
            g["nodes"], g["links"], [], [])
    got = pack_scene(*args, device="cpu", **kw)
    assert got.lt_tris is None
    assert_same_tables(got, jdevice.pack_scene(*args, **kw))
