"""The bf16 node rows (S2) in the port: ``scene/device.pack_nl5`` /
``with_bf16_nodes`` against the JAX package's, and every binary walk of the
port through them on the CPU.

The packed rows are byte-equal to the JAX package's on the golden ``nl8``
and on a seeded table of edge values (signed zeros, denormals, infinities,
exact bf16 values, inexact negatives, NaN patterns in every column). The
boxes are rounded outward, so a walk accepts a superset of the nodes and
every extra candidate fails the exact triangle test or the strict t bounds:
the port's plain walk on nl5 rows gives closest hits bit-equal to its walk
on nl8 and the same ``occluded`` (an any-hit ray's first passing triangle may
be another one, as in tests/test_traversal_bf16.py). Against JAX's
``ray_query(with_bf16_nodes(scene))`` the walk is held as
tests/test_torch_traversal.py holds it (XLA:CPU contracts FMAs): ids,
barycentrics and ``back`` are checked bit-equal on top of that. Frames (the
scan, the wavefront's plain version, a frame packer's scene) and the
port's gradient with nl5 rows are bit-equal to the same with nl8; a scene
with wide tables walks them and ignores nl5. One JAX call: ``ray_query`` on
rays.gold with a per-lane any-hit mask.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops.traversal import ray_query as jax_ray_query
from pathtracing_tpu.scene import device as jdevice
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch import models
from pathtracing_tpu_torch.accel.builder_py import build_blas, build_tlas
from pathtracing_tpu_torch.accel.types import BvhBuffers
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.convert import grads_to_numpy, scene_from_jax
from pathtracing_tpu_torch.diff.render import make_fast_grad_fn
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.ops import cuda_wavefront as CWF
from pathtracing_tpu_torch.io.obj import MeshHandle
from pathtracing_tpu_torch.ops.traversal import ray_query, ray_query_plain
from pathtracing_tpu_torch.ops.wavefront import path_trace_wavefront
from pathtracing_tpu_torch.render import render_pixels
from pathtracing_tpu_torch.scene.device import (
    DevicePacker,
    pack_nl5,
    pack_scene,
    with_bf16_nodes,
)
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.scene.types import Camera, DirectionalLight, Subframe, TlasInstance
from pathtracing_tpu_torch.testing import assert_hits_agree, golden, n, stack, t, vec3_t
from pathtracing_tpu_torch.utils.hostmath import mul_m4m4, rotation_euler, scaling, translation
from pathtracing_tpu_torch.utils.vec import Vec3

import golden_scene as jgolden

f32 = np.float32
SMALL = dataclasses.replace(TESTING, image_width=16, image_height=9, max_bounces=2,
                            samples_per_pixel=2)
HIT_FIELDS = ("thit", "bary_u", "bary_v", "bary_w", "inst", "prim", "back")

# f32 bit patterns that round, or refuse to round, in every way: signed
# zeros, the smallest and a large denormal, +-inf, exact bf16 values, values
# one ulp past a bf16 value on either sign, the largest finite values (whose
# outward rounding reaches inf), NaN patterns (quiet, signalling, all ones),
# and the link sentinel 0xFFFFFFFF
EDGE_BITS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
    0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000, 0x3F800001, 0xBF800001,
    0x3F80FFFF, 0xBF80FFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F0001, 0xFF7F0001,
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0xFFFFFFFF, 0x0000FFFF,
    0x8000FFFF, 0xFFFF0000, 0x00010000, 0x80010000,
], np.uint32)


def _edge_table(seed=5, rows=512) -> np.ndarray:
    """An (8N, 8) f32 table: half its words drawn from EDGE_BITS, half
    uniform random bit patterns, in every column."""
    rs = np.random.default_rng(seed)
    edge = rs.choice(EDGE_BITS, size=(rows // 2, 8))
    rand = rs.integers(0, 1 << 32, size=(rows // 2, 8), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([edge, rand]).view(f32)


def _bits(a) -> bytes:
    """The bytes of an array or tensor (floats compared bit for bit, NaN
    patterns and signed zeros included)."""
    return np.ascontiguousarray(n(a)).tobytes()


def _unpack(nl5: np.ndarray):
    """(bmin, bmax) (N, 3) f32 boxes of nl5 rows (tests/test_traversal_bf16.py)."""
    bits = np.ascontiguousarray(nl5[:, 0:3]).view(np.uint32)
    hi = (bits & np.uint32(0xFFFF0000)).view(f32)
    lo = (bits << np.uint32(16)).view(f32)
    return (np.stack([hi[:, 0], lo[:, 0], hi[:, 1]], axis=1),
            np.stack([lo[:, 1], hi[:, 2], lo[:, 2]], axis=1))


@pytest.fixture(scope="module")
def golden_scenes():
    sg = golden("scene.gold")
    scene = scene_device_from_golden(sg, device="cpu")
    return sg, scene, with_bf16_nodes(scene)


@pytest.mark.parametrize("table", ["golden", "edge"])
def test_pack_nl5_byte_equal_to_jax(golden_scenes, table):
    """pack_nl5 (numpy) and with_bf16_nodes (torch, on the scene's device)
    against the JAX package's pack_nl5 and with_bf16_nodes."""
    _, scene, scene5 = golden_scenes
    nl8 = n(scene.nl8) if table == "golden" else _edge_table()
    want = jdevice.pack_nl5(nl8)
    assert want.shape == (len(nl8), 5)
    assert _bits(pack_nl5(nl8)) == _bits(want)
    got = with_bf16_nodes(scene._replace(nl8=torch.from_numpy(nl8.copy())))
    assert got.nl5.dtype == torch.float32 and got.nl5.is_contiguous()
    assert tuple(got.nl5.shape) == want.shape and _bits(got.nl5) == _bits(want)
    if table == "golden":
        js = jdevice.with_bf16_nodes(jgolden.scene_device_from_golden(golden("scene.gold")))
        assert _bits(scene5.nl5) == _bits(js.nl5)
        # the other tables are untouched
        assert all(getattr(scene5, k) is getattr(scene, k)
                   for k in scene._fields if k != "nl5")


def test_pack_nl5_bounds_conservative(golden_scenes):
    """tests/test_traversal_bf16.py's checks on the port's rows."""
    _, scene, scene5 = golden_scenes
    nl8, nl5 = n(scene.nl8), n(scene5.nl5)
    bmin, bmax = _unpack(nl5)
    assert (bmin <= nl8[:, 0:3]).all()
    assert (bmax >= nl8[:, 3:6]).all()
    # within one bf16 ulp of the exact bounds (no wild inflation)
    span = np.maximum(np.abs(nl8[:, 0:6]), 1e-30)
    err = np.concatenate([nl8[:, 0:3] - bmin, bmax - nl8[:, 3:6]], axis=1)
    assert (err <= span * 2.0 ** -7 + 1e-30).all()
    # links unchanged (bit compare: 0xFFFFFFFF sentinels are NaN as floats)
    assert (np.ascontiguousarray(nl5[:, 3:5]).view(np.uint32)
            == np.ascontiguousarray(nl8[:, 6:8]).view(np.uint32)).all()
    # on the edge table: every box without a NaN contains its f32 box (a NaN
    # 0xFFFF.... rounded down carries into its neighbour's half, in the JAX
    # package's packer as in this one)
    edge = _edge_table()
    bmin, bmax = _unpack(pack_nl5(edge))
    ok = ~np.isnan(edge[:, 0:6]).any(axis=1)
    assert ok.sum() > 100
    assert (bmin[ok] <= edge[ok, 0:3]).all() and (bmax[ok] >= edge[ok, 3:6]).all()


def test_plain_walk_nl5_matches_jax_and_nl8(golden_scenes):
    """rays.gold through the plain walk on nl5 rows: against JAX's
    ray_query(with_bf16_nodes(scene)) with a per-lane any-hit mask (one
    call), and against the port's walk on nl8 in closest-hit, any-hit and
    mixed modes. Closest hits bit-equal to nl8's; ``occluded`` equal."""
    sg, scene, scene5 = golden_scenes
    rg = golden("rays.gold")
    R = len(rg["origins"])
    mask = np.random.default_rng(3).random(R) < 0.5
    js = jdevice.with_bf16_nodes(jgolden.scene_device_from_golden(sg))
    hj, oj = jax_ray_query(
        js, jnp.full(R, int(sg["tlas"][0]), jnp.int32), jnp.full(R, int(sg["tlas"][1]), jnp.int32),
        JVec3(*(jnp.asarray(rg["origins"][:, i]) for i in range(3))),
        JVec3(*(jnp.asarray(rg["dirs"][:, i]) for i in range(3))),
        1e-4, 1e9, jnp.ones(R, bool), anyhit=jnp.asarray(mask))

    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    args = lambda s, tmin: (s, full(sg["tlas"][0]), full(sg["tlas"][1]),
                            vec3_t(rg["origins"]), vec3_t(rg["dirs"]), tmin, 1e9,
                            torch.ones(R, dtype=torch.bool))
    mixed5, omixed5 = ray_query_plain(*args(scene5, 1e-4), anyhit=t(mask))
    # the JAX package's bars, on the closest-hit lanes; ids, barycentrics
    # and back bit for bit
    cl = ~mask
    sub = lambda h: type(h)(*(torch.as_tensor(np.asarray(n(x))[cl]) for x in h))
    assert_hits_agree(sub(mixed5), omixed5[t(cl)], sub(hj), torch.as_tensor(np.asarray(oj)[cl]))
    for k in ("inst", "prim", "back", "bary_u", "bary_v"):
        np.testing.assert_array_equal(n(getattr(mixed5, k))[cl], np.asarray(getattr(hj, k))[cl],
                                      err_msg=k)
    np.testing.assert_array_equal(n(omixed5), np.asarray(oj))

    # against the port's nl8 walk: closest hits bit-equal, occluded equal
    for tmin, anyhit in ((0.0, False), (1e-4, True), (1e-4, t(mask))):
        h5, o5 = ray_query(*args(scene5, tmin), anyhit=anyhit)
        h8, o8 = ray_query(*args(scene, tmin), anyhit=anyhit)
        assert torch.equal(o5, o8), anyhit
        closest = torch.ones(R, dtype=torch.bool) if anyhit is False else (
            torch.zeros(R, dtype=torch.bool) if anyhit is True else ~anyhit)
        for k in HIT_FIELDS:
            assert _bits(getattr(h5, k)[closest]) == _bits(getattr(h8, k)[closest]), k
    assert n(h5.thit[closest] >= 0).mean() > 0.2  # the mixed batch hits


def test_plain_walk_counts_sectors(golden_scenes):
    """The counts of a walk on nl5 rows: at least nl8's node visits (the
    boxes are larger), one or two 32 B sectors a visit, and the distinct
    sectors of the rows touched (neighbouring rows share sectors); on nl8 a
    sector a row."""
    sg, scene, scene5 = golden_scenes
    rg = golden("rays.gold")
    R = 1024
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    a = lambda s: (s, full(sg["tlas"][0]), full(sg["tlas"][1]), vec3_t(rg["origins"][:R]),
                   vec3_t(rg["dirs"][:R]), 0.0, 1e9, torch.ones(R, dtype=torch.bool))
    *_, c8 = ray_query_plain(*a(scene), return_counts=True)
    *_, c5 = ray_query_plain(*a(scene5), return_counts=True)
    assert c8.node_sectors == c8.node_rows and c8.node_sectors_touched == c8.node_rows_touched
    assert c5.node_rows >= c8.node_rows and c5.node_rows_touched >= c8.node_rows_touched
    assert c5.node_rows < c5.node_sectors < 2 * c5.node_rows
    assert (c5.inst_rows, c5.tri_rows) >= (c8.inst_rows, c8.tri_rows)
    # distinct sectors: at least the rows' 20 B packed together, at most two
    # a row
    touched = c5.node_rows_touched
    assert -(-touched * 20 // 32) <= c5.node_sectors_touched <= 2 * touched


# ------------------------------------------------- a random scene, brute force


def _random_scene(rng, n_meshes=3, n_instances=6, tris_per_mesh=64):
    """tests/test_traversal_property.py's random scene, built by the port's
    accel/builder_py and packed by its pack_scene."""
    chunks, handles, io, bv = [], [], 0, 0
    for _ in range(n_meshes):
        centers = rng.uniform(-1, 1, (tris_per_mesh, 3)).astype(f32)
        tris = centers[:, None, :] + rng.uniform(-0.08, 0.08, (tris_per_mesh, 3, 3)).astype(f32)
        pos = tris.reshape(-1, 3)
        v = len(pos)
        chunks.append((np.arange(tris_per_mesh * 3, dtype=np.uint32), pos,
                       np.tile(np.array([0, 1, 0], f32), (v, 1)), np.ones((v, 4), f32),
                       np.ones((v, 4), f32)))
        handles.append(MeshHandle(vertex_count=v, triangle_count=tris_per_mesh,
                                  index_offset=io, base_vertex_offset=bv))
        io += 3 * tris_per_mesh
        bv += v
    mesh_arrays = tuple(np.concatenate([c[k] for c in chunks]) for k in range(5))
    bc = BvhBuffers()
    blas = [build_blas(h, mesh_arrays, bc) for h in handles]
    instances = []
    for _ in range(n_instances):
        m = rng.integers(0, n_meshes)
        tr = scaling(rng.uniform(0.5, 2.0, 3).astype(f32))
        tr = mul_m4m4(rotation_euler(rng.uniform(0, 2 * np.pi, 3).astype(f32)), tr)
        tr = mul_m4m4(translation(rng.uniform(-3, 3, 3).astype(f32)), tr)
        instances.append(TlasInstance.create(blas[m], handles[m], tr))
    tlas = build_tlas(instances, list(range(n_instances)), bc.nodes, bc)
    sub = Subframe(tlas, Camera(np.eye(3, dtype=f32), np.zeros(3, f32), 1.0, 1.0, 1.0, 0.0, 0,
                                0.0),
                   DirectionalLight(np.array([0, 1, 0], f32), np.ones(3, f32), 0.5))
    scene = pack_scene(mesh_arrays, bc.nodes, bc.links, instances, [sub], device="cpu")
    return scene, tlas, instances, mesh_arrays


def _world_triangles(instances, mesh_arrays):
    """Every instance triangle in world space, (M, 3, 3) float64, and its
    (instance, prim)."""
    indices, pos = mesh_arrays[0], mesh_arrays[1]
    tris, ids = [], []
    for i, inst in enumerate(instances):
        m = inst.mesh
        tri = indices[m.index_offset:m.index_offset + 3 * m.triangle_count]
        p = pos[m.base_vertex_offset + tri].reshape(-1, 3, 3)
        hom = np.concatenate([p, np.ones((*p.shape[:2], 1), f32)], -1)
        tris.append((hom @ inst.transform.astype(np.float64))[..., :3])
        ids += [(i, k) for k in range(m.triangle_count)]
    return np.concatenate(tris), ids


def _brute_force(w, ids, org, d):
    """Moller-Trumbore closest hit in float64 over the world-space
    triangles ``w``: (t, (instance, prim)) per ray, inf / None for a miss."""
    v0, e1, e2 = w[:, 0], w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
    best_t, best = np.full(len(org), np.inf), [None] * len(org)
    for r in range(len(org)):
        o, dd = org[r].astype(np.float64), d[r].astype(np.float64)
        p = np.cross(dd, e2)
        det = np.einsum("ij,ij->i", e1, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            tv = o - v0
            u = np.einsum("ij,ij->i", tv, p) * inv
            q = np.cross(tv, e1)
            v = q @ dd * inv
            tt = np.einsum("ij,ij->i", e2, q) * inv
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
        tt = np.where(ok, tt, np.inf)
        k = int(np.argmin(tt))
        if np.isfinite(tt[k]):
            best_t[r], best[r] = tt[k], ids[k]
    return best_t, best


@pytest.mark.parametrize("seed", [0, 1])
def test_random_scene_nl5_matches_brute_force(seed):
    """tests/test_traversal_property.py's property on the port's own
    builder, with nl5 rows: near-total agreement with brute force, and every
    closest-hit field bit-equal to the walk on nl8."""
    rng = np.random.default_rng(seed)
    scene, tlas, instances, mesh_arrays = _random_scene(rng)
    scene5 = with_bf16_nodes(scene)
    R = 256
    w, ids = _world_triangles(instances, mesh_arrays)
    org = rng.uniform(-5, 5, (R, 3)).astype(f32)
    d = rng.normal(size=(R, 3))
    # three rays in four aimed at a random triangle's centroid, so that
    # most of them hit
    aim = rng.random(R) < 0.75
    d[aim] = w[rng.integers(0, len(w), aim.sum())].mean(axis=1) - org[aim]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)
    q = lambda s, any_=False: ray_query(
        s, torch.full((R,), tlas.node_count, dtype=torch.int32),
        torch.full((R,), tlas.node_offset, dtype=torch.int32), vec3_t(org), vec3_t(d),
        0.0, 1e9, torch.ones(R, dtype=torch.bool), any_)
    (h5, _), (h8, _) = q(scene5), q(scene)
    for k in HIT_FIELDS:
        assert _bits(getattr(h5, k)) == _bits(getattr(h8, k)), k
    assert torch.equal(q(scene5, True)[1], q(scene, True)[1])

    bf_t, bf_id = _brute_force(w, ids, org, d)
    got_t = n(h5.thit).astype(np.float64)
    agree = (got_t >= 0) == np.isfinite(bf_t)
    assert agree.mean() > 0.99, agree.mean()
    both = agree & (got_t >= 0)
    assert both.sum() > R // 2
    np.testing.assert_allclose(got_t[both], bf_t[both], rtol=2e-3, atol=2e-3)
    same = sum(bf_id[r] == (int(h5.inst[r]), int(h5.prim[r])) for r in np.nonzero(both)[0])
    assert same >= 0.98 * both.sum(), (same, both.sum())


# ------------------------------------------------------ frames and gradients


def _frame_lists():
    idx = np.arange(SMALL.image_width * SMALL.image_height, dtype=np.int32)
    return idx % SMALL.image_width, idx // SMALL.image_width


@pytest.fixture(scope="module")
def small_scenes():
    g = golden("scene.gold")
    binary = scene_device_from_golden(g, SMALL, device="cpu")
    wide = scene_device_from_golden(g, SMALL, wide=True, device="cpu")
    return binary, wide


@pytest.mark.parametrize("path", ["scan", "wavefront_plain", "wide_scan", "gradient"])
def test_frames_and_gradient_nl5_equal_nl8(small_scenes, path):
    """A tiny frame through the scan and through the wavefront's plain
    version on the binary tables, and the port's gradient (record/replay on
    the binary tables), each with nl5 rows bit-equal to the same with nl8; a
    wide scene carrying nl5 walks its wide tables and renders equal to one
    without it."""
    binary, wide = small_scenes
    xs, ys = _frame_lists()
    base = wide if path == "wide_scan" else binary
    scene5 = with_bf16_nodes(base)
    if path == "gradient":
        lanes = (torch.from_numpy(xs[40:72].copy()), torch.from_numpy(ys[40:72].copy()),
                 torch.arange(32, dtype=torch.int32) % 3)
        fn = make_fast_grad_fn(SMALL)
        (l8, g8), (l5, g5) = fn(base, *lanes), fn(scene5, *lanes)
        assert _bits(l8) == _bits(l5) and float(l8) > 0
        g8, g5 = grads_to_numpy(g8), grads_to_numpy(g5)
        assert g8.keys() == g5.keys()
        for k in g8:
            assert g8[k].tobytes() == g5[k].tobytes(), k
        assert any(np.abs(v).max() > 0 for v in g8.values())
        return
    if path == "wavefront_plain":
        run = lambda s: stack(path_trace_wavefront(SMALL, s, xs, ys, 2, 1, device="cpu"))
    else:
        run = lambda s: render_pixels(SMALL, s, xs, ys, spp=2, tile_pixels=64, device="cpu")
    c8, c5 = run(base), run(scene5)
    assert c5.tobytes() == c8.tobytes() and c8.mean() > 0


def test_frame_packer_scene_nl5():
    """with_bf16_nodes on a DevicePacker frame scene (its nl8 the static
    rows and the frame's TLAS tail, concatenated): byte-equal to pack_nl5 of
    that nl8, and a frame through it bit-equal to the frame through nl8."""
    cfg = dataclasses.replace(SMALL, image_width=8, image_height=6)
    s, _ = models.build("sphere_ground", cfg, wide=False, device="cpu")
    frame = DevicePacker(s, device="cpu").pack_frame(s)
    frame5 = with_bf16_nodes(frame)
    assert _bits(frame5.nl5) == _bits(pack_nl5(n(frame.nl8)))
    idx = np.arange(cfg.image_width * cfg.image_height, dtype=np.int32)
    run = lambda sc: render_pixels(cfg, sc, idx % cfg.image_width, idx // cfg.image_width,
                                   spp=2, device="cpu")
    c8, c5 = run(frame), run(frame5)
    assert c5.tobytes() == c8.tobytes() and c8.mean() > 0


def test_scene_from_jax_carries_nl5():
    """scene_from_jax takes a JAX scene with nl5 across byte for byte."""
    js = jdevice.with_bf16_nodes(jgolden.scene_device_from_golden(golden("scene.gold")))
    fields = {k: np.asarray(v) for k, v in js._asdict().items() if v is not None}
    got = scene_from_jax(fields, device="cpu")
    assert got.nl5 is not None and _bits(got.nl5) == _bits(fields["nl5"])
    assert _bits(got.nl8) == _bits(fields["nl8"])
    assert _bits(with_bf16_nodes(got._replace(nl5=None)).nl5) == _bits(fields["nl5"])


def test_kernel_wrappers_check_the_nl5_table(golden_scenes):
    """What the kernels' wrappers take (checked on CPU tensors; on the CPU
    no kernel launches): the table walked is nl5 when the scene carries it,
    a contiguous (8N, 5) f32 table; the wavefront walks a wide scene's
    tables whatever its nl5."""
    _, scene, scene5 = golden_scenes
    cpu = torch.device("cpu")
    assert CT.node_table(scene, cpu)[0] == "nl8"
    rows, table = CT.node_table(scene5, cpu)
    assert rows == "nl5" and table is scene5.nl5
    assert CWF.check_scene(scene5, cpu) == 0
    # the wavefront's argument list passes the nl5 table as the node rows,
    # and a wide scene's tables whatever its nl5
    z = torch.zeros(4, dtype=torch.int32)
    args = lambda s, w: CWF.kernel_args(TESTING, s, w, z, z, 1, 0, 8, *[None] * 7)
    assert args(scene5, 0)[5] == scene5.nl5.data_ptr()
    assert args(scene, 0)[5] == scene.nl8.data_ptr()
    wide = scene_device_from_golden(golden("scene.gold"), wide=True, device="cpu")
    wide5 = with_bf16_nodes(wide)
    assert CWF.check_scene(wide5, cpu) == 48
    assert args(wide5, 48)[5] is None and args(wide5, 48)[0] == wide.wide_rows.data_ptr()
    with pytest.raises(ValueError, match="shape"):
        CT.node_table(scene5._replace(nl5=scene5.nl5[:-8].contiguous()), cpu)
    with pytest.raises(TypeError, match="dtype"):
        CT.node_table(scene5._replace(nl5=scene5.nl5.view(torch.int32)), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        CT.node_table(scene5._replace(nl5=torch.cat([scene5.nl5] * 2, 1)[:, 0:5]), cpu)
    # a CPU tensor never reaches a kernel
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        CT.ray_query_cuda(scene5, z.int(), z.int(), Vec3(z, z, z), Vec3(z, z, z), 0.0, 1e9,
                          z.bool())
