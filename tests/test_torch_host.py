"""The port's host pipeline vs the JAX package's, on the CPU: the generated
assets, the OBJ loaders (Python and native), the BVH builders (Python and
native, and the oracle's blas_teapot.gold), the wide-tree builders (native
against Python) and the host matrix helpers. Everything here is numpy on
both sides: no JAX call compiles."""

import filecmp
import pathlib

import numpy as np
import pytest

from pathtracing_tpu.accel import builder_py as jbuilder
from pathtracing_tpu.accel import native as jnative
from pathtracing_tpu.io import obj as jobj
from pathtracing_tpu.scene import assets as jassets
from pathtracing_tpu.utils import hostmath as jhm
from pathtracing_tpu_torch.accel import builder_py as tbuilder
from pathtracing_tpu_torch.accel import native as tnative
from pathtracing_tpu_torch.accel.types import BvhBuffers
from pathtracing_tpu_torch.accel.wide import (
    LAYOUT_S8,
    LAYOUT_W8,
    LAYOUT_W16,
    WideStaticRegion,
    build_frame_tail,
)
from pathtracing_tpu_torch.io import native_loader
from pathtracing_tpu_torch.io import obj as tobj
from pathtracing_tpu_torch.io.obj import MeshHandle
from pathtracing_tpu_torch.scene import assets as tassets
from pathtracing_tpu_torch.scene.golden import _GoldenInstance
from pathtracing_tpu_torch.scene.loader import make_transform
from pathtracing_tpu_torch.scene.types import Subframe, TlasInstance
from pathtracing_tpu_torch.accel.types import BvhHandle
from pathtracing_tpu_torch.testing import golden
from pathtracing_tpu_torch.utils import hostmath as thm
from pathtracing_tpu_torch.utils import native_build

ROOT = pathlib.Path(__file__).resolve().parent.parent
GENERATED = ROOT / "assets" / "generated"
OBJS = {
    "terrain": GENERATED / "terrain.obj",
    "bunny": GENERATED / "bunny.obj",
    "pine_tree": GENERATED / "pine_tree.obj",
    "ground": ROOT / "assets" / "golden" / "ground.obj",
}
# the files whose faces carry slashes ("p//n"); the generated bunny and pine
# write bare "f a b c", which the native loader reads the reference's way
SLASHED = ("terrain", "ground")


def _load(module, path, loader, monkeypatch):
    if loader == "python":
        monkeypatch.setenv("PT_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("PT_NO_NATIVE", raising=False)
    mb = module.MeshBuffers()
    m = module.load_mesh(mb, str(path))
    return m, mb.arrays()


@pytest.fixture(scope="module", autouse=True)
def native_libraries():
    """Both packages' native libraries build here (g++ is on the test
    machines); a test of the native path must not pass on the Python one."""
    assert native_loader.LIBRARY.load() is not None
    assert tnative.BVH_LIBRARY.load() is not None and tnative.WIDE_LIBRARY.load() is not None
    assert jnative.get_lib() is not None and jnative.get_wide_lib() is not None


# ------------------------------------------------------------------ assets


@pytest.mark.parametrize("name", ["terrain", "bunny", "pine_tree"])
def test_generated_assets_are_the_committed_files(name, tmp_path):
    """write_terrain_obj (n = 160), write_bunny_obj and write_pine_obj give
    the committed assets/generated files byte for byte, material files
    included; ensure_substitutes writes the same three."""
    writer = {"terrain": tassets.write_terrain_obj, "bunny": tassets.write_bunny_obj,
              "pine_tree": tassets.write_pine_obj}[name]
    writer(str(tmp_path / f"{name}.obj"))
    for ext in ("obj", "mtl"):
        assert filecmp.cmp(tmp_path / f"{name}.{ext}", GENERATED / f"{name}.{ext}",
                           shallow=False), (name, ext)
    paths = tassets.ensure_substitutes(str(tmp_path / "subs"))
    assert filecmp.cmp(paths[name], GENERATED / f"{name}.obj", shallow=False)


def test_height_matches_jax():
    rs = np.random.default_rng(0)
    x, z = (rs.uniform(-130, 130, 4096).astype(np.float32) for _ in range(2))
    got, ref = tassets._height(x, z), jassets._height(x, z)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


# ----------------------------------------------------------------- loaders


@pytest.mark.parametrize("loader", ["python", "native"])
@pytest.mark.parametrize("name", list(OBJS))
def test_load_mesh_matches_jax(name, loader, monkeypatch):
    """The same loader of both packages: the same handle and buffers, byte
    for byte; the builder count says which loader ran."""
    native_build.reset_builds()
    tm, tarr = _load(tobj, OBJS[name], loader, monkeypatch)
    assert native_build.builds == {f"obj_{loader}": 1}
    jm, jarr = _load(jobj, OBJS[name], loader, monkeypatch)
    assert tm.__dict__ == jm.__dict__
    for a, b in zip(tarr, jarr):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_native_and_python_loaders(monkeypatch):
    """Where faces carry slashes the two loaders give the same bytes. On bare
    "f a b c" faces they differ, in both packages alike: the native loader
    reads a corner the reference's way (strtol skips the blank and takes the
    next number as the texture index), the Python one by blank-separated
    tokens."""
    for name in OBJS:
        pm, parr = _load(tobj, OBJS[name], "python", monkeypatch)
        nm, narr = _load(tobj, OBJS[name], "native", monkeypatch)
        same = pm == nm and all(a.tobytes() == b.tobytes() for a, b in zip(parr, narr))
        assert same == (name in SLASHED), name
    _, parr = _load(tobj, OBJS["bunny"], "python", monkeypatch)
    _, narr = _load(tobj, OBJS["bunny"], "native", monkeypatch)
    assert (len(parr[1]), len(narr[1])) == (396, 705)


@pytest.mark.parametrize("name", ["bunny", "pine_tree"])
def test_substitutes_with_normals_load_alike(name, tmp_path, monkeypatch):
    """Written with vertex normals and slashed faces, the bunny and the pine
    load to the same bytes by every loader of both packages: the Python
    loader's mesh of the bare faces, with unit normals turned outward."""
    path = tmp_path / f"{name}.obj"
    {"bunny": tassets.write_bunny_obj, "pine_tree": tassets.write_pine_obj}[name](
        str(path), normals=True)
    ref_m, ref = _load(tobj, path, "python", monkeypatch)
    for module in (tobj, jobj):
        for loader in ("python", "native"):
            m, arr = _load(module, path, loader, monkeypatch)
            assert m.__dict__ == ref_m.__dict__
            assert all(a.tobytes() == b.tobytes() for a, b in zip(arr, ref))
    _, bare = _load(tobj, OBJS[name], "python", monkeypatch)
    for k in (0, 1, 3, 4):  # indices, positions, albedo, material
        assert ref[k].tobytes() == bare[k].tobytes()
    pos, nrm = ref[1], ref[2]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-3)
    # outward: at the mesh's extreme vertices the normal points out of it
    for k in range(3):
        assert nrm[np.argmax(pos[:, k]), k] > 0 and (k == 1 or nrm[np.argmin(pos[:, k]), k] < 0)


def test_two_meshes_share_the_buffers(monkeypatch):
    """A second mesh appends: its handle's offsets are the first's sizes."""
    mb = tobj.MeshBuffers()
    a = tobj.load_mesh(mb, str(OBJS["ground"]))
    b = tobj.load_mesh(mb, str(OBJS["pine_tree"]))
    assert (b.index_offset, b.base_vertex_offset) == (3 * a.triangle_count, a.vertex_count)
    assert mb.index_count == 3 * (a.triangle_count + b.triangle_count)


def test_load_mtl_and_bake_match_jax(tmp_path):
    """MTL parsing and the per-vertex material baking (emission scaled by
    max(Kd, Ke), NaN to 0, transmission as its largest component)."""
    (tmp_path / "m.mtl").write_text(
        "newmtl a\nKd 0.5 0.25 0\nKe 1 0 0\nd 0.5\nPr 0.3\nPm 0.7\nTf 0.1 0.9 0.2\n"
        "newmtl b\nKd 0 0 0\nKe 0 0 0\n"
    )
    tm, jm = [], []
    tobj.load_mtl(tm, str(tmp_path / "m.mtl"))
    jobj.load_mtl(jm, str(tmp_path / "m.mtl"))
    assert [m.__dict__ for m in tm] == [m.__dict__ for m in jm]
    for t_, j_ in zip(tm, jm):
        for a, b in zip(tobj._bake_material(t_), jobj._bake_material(j_)):
            assert a.tobytes() == b.tobytes()
    assert tobj._parse_face_vertex("3//7") == jobj._parse_face_vertex("3//7") == (2, -1, 6)


# ---------------------------------------------------------------- builders


def test_blas_builders_match_teapot_golden():
    """Both builders on the leaves of mesh_teapot.gold's own buffers give
    blas_teapot.gold's nodes and links exactly."""
    mg, bg = golden("mesh_teapot.gold"), golden("blas_teapot.gold")
    vc, tc, io, bvo = (int(v) for v in mg["handle"])
    m = MeshHandle(vertex_count=vc, triangle_count=tc, index_offset=io, base_vertex_offset=bvo)
    leaves = tbuilder.compute_blas_leaves(m, (mg["indices"], mg["pos"]))
    for nodes, links in (tnative.build_bvh_native(*leaves),
                         tbuilder.build_from_leaves_py(*leaves)):
        assert len(nodes) == int(bg["bvh"][0])
        np.testing.assert_array_equal(nodes, bg["nodes"])
        np.testing.assert_array_equal(links, bg["links"])


@pytest.mark.parametrize("name", list(OBJS))
def test_bvh_builders_match_jax(name, monkeypatch):
    """The port's native builder (and, on the small meshes, its Python one)
    against the JAX package's, on the repo's OBJs; build_blas counts the
    builder that served it."""
    m, arr = _load(tobj, OBJS[name], "native", monkeypatch)
    leaves = tbuilder.compute_blas_leaves(m, arr)
    ref = jnative.build_bvh_native(*jbuilder.compute_blas_leaves(m, arr))
    native_build.reset_builds()
    bc = BvhBuffers()
    h = tbuilder.build_blas(m, arr, bc)
    assert native_build.builds == {"bvh_native": 1}
    assert (h.node_offset, h.node_count) == (0, len(ref[0]))
    outs = [(bc.nodes, bc.links)]
    if name != "terrain":  # 51,314 leaves: minutes in numpy
        outs.append(tbuilder.build_from_leaves_py(*leaves))
    for nodes, links in outs:
        assert nodes.tobytes() == ref[0].tobytes() and links.tobytes() == ref[1].tobytes()


def _tlas_instances(monkeypatch):
    """Ground, pine and bunny BLASes in one buffer and eight placements."""
    mb, bc = tobj.MeshBuffers(), BvhBuffers()
    monkeypatch.delenv("PT_NO_NATIVE", raising=False)
    meshes = {}
    for name in ("ground", "pine_tree", "bunny"):
        m = tobj.load_mesh(mb, str(OBJS[name]))
        meshes[name] = (m, tbuilder.build_blas(m, mb.arrays(), bc))
    rs = np.random.default_rng(3)
    insts = []
    for i in range(8):
        m, blas = meshes[("ground", "pine_tree", "bunny")[i % 3]]
        pos = rs.uniform(-20, 20, 3).astype(np.float32)
        insts.append(TlasInstance.create(blas, m, make_transform(pos, (5.0 * i, 40.0 * i, 0.0))))
    return mb, bc, insts


def test_tlas_builders_match_jax(monkeypatch):
    """build_tlas over eight instances: the world AABBs of the BLAS roots'
    transformed corners as leaves, native and Python, equal to JAX's."""
    mb, bc, insts = _tlas_instances(monkeypatch)
    idx = list(range(len(insts)))[::-1]
    ref = BvhBuffers(bc.nodes.copy(), bc.links.copy())
    jh = jbuilder.build_tlas(insts, idx, ref.nodes, ref)
    th = tbuilder.build_tlas(insts, idx, bc.nodes, bc)
    assert (th.node_offset, th.node_count) == (jh.node_offset, jh.node_count)
    assert bc.nodes.tobytes() == ref.nodes.tobytes()
    assert bc.links.tobytes() == ref.links.tobytes()
    lmin = np.stack([bc.nodes[th.node_offset][:3]] * 2)  # a two-leaf build
    lmax = lmin + 1
    py = tbuilder.build_from_leaves_py(lmin, lmax, np.array([4, 9], np.uint32))
    nat = tnative.build_bvh_native(lmin, lmax, np.array([4, 9], np.uint32))
    assert all(a.tobytes() == b.tobytes() for a, b in zip(py, nat))


@pytest.mark.parametrize("layout", [LAYOUT_W8, LAYOUT_W16, LAYOUT_S8], ids=["w8", "w16", "s8"])
def test_wide_native_matches_python(layout, monkeypatch):
    """The wide-tree builder's two implementations on the golden scene: the
    static region's rows and roots and the frame tail, byte for byte (as
    tests/test_wide_native.py holds the JAX package's); the builder count
    follows PT_NATIVE_WIDE."""
    g = golden("scene.gold")
    insts = [_GoldenInstance(g["instances_u"][i], g["instances_f"][i])
             for i in range(len(g["instances_u"]))]
    arrays = (g["indices"], g["pos"], g["normal"], g["albedo"], g["material"])
    sub = [Subframe(BvhHandle(int(g["tlas"][0]), int(g["tlas"][1])), None, None)]

    def build(native):
        monkeypatch.setenv("PT_NATIVE_WIDE", "1" if native else "0")
        native_build.reset_builds()
        static = WideStaticRegion(arrays, g["nodes"], g["links"],
                                  [(i.mesh, i.blas) for i in insts],
                                  leaf_bundle=None, layout=layout)
        tail, root = build_frame_tail(static, g["nodes"], g["links"], insts, sub)
        assert native_build.builds == {f"wide_{'native' if native else 'python'}": 2}
        return static, tail, root

    (sp, tp, rp), (sn, tn, rn) = build(False), build(True)
    assert sn.rows.tobytes() == sp.rows.tobytes()
    assert sn.blas_roots.keys() == sp.blas_roots.keys()
    for k in sp.blas_roots:
        assert np.asarray(sn.blas_roots[k], np.uint32).tobytes() == \
            np.asarray(sp.blas_roots[k], np.uint32).tobytes()
    assert tn.tobytes() == tp.tobytes() and rn.tobytes() == rp.tobytes()


# ---------------------------------------------------------------- hostmath


def test_hostmath_matches_jax():
    rs = np.random.default_rng(4)
    m4 = rs.normal(size=(4, 4)).astype(np.float32)
    b4 = rs.normal(size=(4, 4)).astype(np.float32)
    m3 = rs.normal(size=(3, 3)).astype(np.float32)
    v4 = rs.normal(size=4).astype(np.float32)
    v3 = rs.normal(size=3).astype(np.float32)
    e = rs.uniform(-3, 3, 3).astype(np.float32)
    cases = [
        ("mul_m4v4", (m4, v4)), ("mul_m3v3", (m3, v3)), ("mul_v3m3", (v3, m3)),
        ("mul_m4m4", (b4, m4)), ("expand_m3m4", (m3,)), ("extract_m4m3", (m4,)),
        ("rotation_euler", (e,)), ("rotation", (v3 / np.linalg.norm(v3), 0.7)),
        ("scaling", (v3,)), ("translation", (v3,)), ("inverse4", (m4,)),
    ]
    for name, args in cases:
        got, ref = getattr(thm, name)(*args), getattr(jhm, name)(*args)
        assert got.dtype == ref.dtype == np.float32 and got.tobytes() == ref.tobytes(), name
    for n in (np.float32([0.0, 1.0, 0.0]), np.float32([0.8, 0.0, 0.6]), v3 / np.linalg.norm(v3),
              np.float32([0.0, 0.0, 1.0])):
        n = n.astype(np.float32)
        assert thm.create_tangent_np(n).tobytes() == jhm.create_tangent_np(n).tobytes()
        assert thm.create_tangent_space_np(n).tobytes() == jhm.create_tangent_space_np(n).tobytes()
    pos, pyr, scale = (1.5, -2.0, 3.0), (10.0, 35.0, -5.0), (2.0, 1.0, 0.5)
    from pathtracing_tpu.scene.loader import make_transform as jmake_transform

    assert make_transform(pos, pyr, scale).tobytes() == jmake_transform(pos, pyr, scale).tobytes()
