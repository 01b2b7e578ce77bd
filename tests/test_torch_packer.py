"""The animated frame loop's packer (scene/device.DevicePacker) and the
chunked static region (accel/chunks.py) against the JAX package's, on the
CPU.

One host ``Scene`` is shared: the reference's animated scene loaded by the
port from stand-in meshes (scene/standins.py) at frame 1000 with two
subframes, copied field by field into the JAX package's host types. On it:
every packed table of the binary, the wide and the chunked packer
byte-equal to the JAX package's; the incremental wide pack walks as the
one-shot ``pack_scene(wide=True)`` does; a repack of the next frame keeps
every table's shape; ``_concat_rows_bitsafe`` keeps subnormal bit patterns;
the plain wide walk on the chunked tables finds the hits of the unchunked
tables (the chunked region's contract, tests/test_chunked.py: the same
candidates, the order differing only on exact-t ties, any-hit identical)
and of JAX's ``wide_ray_query`` on the same tables and rays (the
tolerances of tests/test_torch_wide_traversal.py), within the path kernels'
step cap. One JAX compile: ``wide_ray_query`` on the chunked tables."""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.accel.types import BvhBuffers as JBvhBuffers
from pathtracing_tpu.accel.types import BvhHandle as JBvhHandle
from pathtracing_tpu.io.obj import MeshBuffers as JMeshBuffers
from pathtracing_tpu.io.obj import MeshHandle as JMeshHandle
from pathtracing_tpu.ops.wide_traversal import wide_ray_query as jax_wide_ray_query
from pathtracing_tpu.scene import device as jdevice
from pathtracing_tpu.scene import types as jtypes
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query_plain
from pathtracing_tpu_torch.scene.device import (
    DevicePacker,
    _concat_rows_bitsafe,
    pack_scene,
)
from pathtracing_tpu_torch.scene.loader import load_scene, setup_animation_frame
from pathtracing_tpu_torch.scene.standins import write_standins
from pathtracing_tpu_torch.testing import assert_hits_agree, assert_same_tables, n, t
from pathtracing_tpu_torch.utils.vec import Vec3

CFG = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=16)
FRAME = 1000  # the bunny and the dragon in view, aperture 0.4
R = 512
JAX_CHUNK_MAX = 1024  # the JAX CLI's; the port's chunks.CHUNK_MAX


def to_jax_scene(s):
    """The port's host Scene copied field by field into the JAX package's
    host types (arrays copied)."""
    mesh = lambda m: JMeshHandle(m.vertex_count, m.triangle_count, m.index_offset,
                                 m.base_vertex_offset)
    bvh = lambda b: JBvhHandle(b.node_count, b.node_offset)
    mb = JMeshBuffers(**{k: [a.copy() for a in getattr(s.mesh_buf, k)]
                         for k in ("indices", "pos", "normal", "albedo", "material")})
    cam = lambda c: jtypes.Camera(**{k: copy.deepcopy(v) for k, v in c.__dict__.items()})
    light = lambda l: jtypes.DirectionalLight(**{k: copy.deepcopy(v)
                                                 for k, v in l.__dict__.items()})
    return jtypes.Scene(
        mesh_buf=mb,
        bvh_buf=JBvhBuffers(s.bvh_buf.nodes.copy(), s.bvh_buf.links.copy()),
        meshes={k: (mesh(m), bvh(b)) for k, (m, b) in s.meshes.items()},
        instances=[jtypes.TlasInstance(bvh(i.blas), mesh(i.mesh), i.transform.copy(),
                                       i.inv_transform.copy()) for i in s.instances],
        static_instance_count=s.static_instance_count,
        subframes=[jtypes.Subframe(bvh(sf.tlas), cam(sf.cam), light(sf.light))
                   for sf in s.subframes],
        subframe_entries=list(s.subframe_entries),
        frame_static_end=s.frame_static_end,
    )


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("standins")
    write_standins(d)
    s = load_scene(data_dir=str(d), config=CFG, device="cpu")
    setup_animation_frame(s, FRAME, CFG)
    assert len(s.subframes) == CFG.subframe_count == 2
    return s, to_jax_scene(s)


# the port's DevicePacker arguments and the JAX package's for the same tables
PACKERS = {
    "binary": ({}, {}),
    "w8": ({"wide": True}, {"wide": True}),
    "chunked": ({"wide": True, "chunk_max": CHUNK_MAX}, {"wide": True, "chunk_max": JAX_CHUNK_MAX}),
}


@pytest.fixture(scope="module")
def packed(scenes):
    s, _ = scenes
    return {k: DevicePacker(s, device="cpu", **kw).pack_frame(s) for k, (kw, _) in PACKERS.items()}


@pytest.mark.parametrize("kind", PACKERS)
def test_packer_tables_match_jax(scenes, packed, kind):
    s, js = scenes
    jdev = jdevice.DevicePacker(js, **PACKERS[kind][1]).pack_frame(js)
    assert_same_tables(packed[kind], jdev)
    assert int(packed[kind].nl8.shape[0]) > 8 * len(s.bvh_buf.nodes) - 8 * 256


def _rays(s, seed=0, aimed=64):
    """R rays over the terrain, the last ``aimed`` of them dropped from
    above onto the frame's instances (buddha, teapot, dragon, bunny, ...),
    which only the subframes' dynamic trees hold."""
    rs = np.random.default_rng(seed)
    org = np.stack([rs.uniform(-90, 90, R), rs.uniform(2, 45, R), rs.uniform(-90, 90, R)],
                   1).astype(np.float32)
    d = rs.normal(size=(R, 3)).astype(np.float32)
    d[:, 1] -= 0.5  # most rays go down to the terrain and the objects
    frame = s.instances[s.static_instance_count:]
    target = np.stack([frame[k % len(frame)].transform[3, :3] for k in range(aimed)])
    target = target + rs.uniform(-0.3, 0.3, (aimed, 3)) + (0.0, 0.45, 0.0)
    org[-aimed:] = target + (0.0, 15.0, 0.0)
    d[-aimed:] = target - org[-aimed:]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _walk(scene, sf, org, d, anyhit=False, **kw):
    full = lambda v: torch.full((R,), v, dtype=torch.int32)
    vec = lambda a: tuple(t(a[:, i]) for i in range(3))
    return wide_ray_query_plain(
        scene, full(sf.tlas.node_count), full(sf.tlas.node_offset), Vec3(*vec(org)),
        Vec3(*vec(d)), 1e-4, 1e9, torch.ones(R, dtype=torch.bool), anyhit, **kw)


def _same_hits(a, b):
    for k in ("inst", "prim", "thit", "bary_u", "bary_v", "bary_w"):
        np.testing.assert_array_equal(n(getattr(a, k)), n(getattr(b, k)), err_msg=k)


def test_chunked_walk_matches_unchunked_and_jax(scenes, packed):
    """Closest hits on the chunked tables equal the unchunked tables' (no
    exact-t tie among these rays), any-hit occlusion identical, on both
    subframes; JAX's wide_ray_query on the same chunked tables agrees at
    the JAX bar; the longest walk stays within the step cap."""
    s, _ = scenes
    chunked, plain = packed["chunked"], packed["w8"]
    org, d = _rays(s)
    for k, sf in enumerate(s.subframes):
        hc, _, counts = _walk(chunked, sf, org, d, return_counts=True)
        hp, _ = _walk(plain, sf, org, d)
        _same_hits(hc, hp)
        hit_share = float((n(hc.thit) >= 0).mean())
        assert 0.5 < hit_share < 1.0, hit_share
        assert int(counts.lane_steps.max()) <= CM.step_cap(chunked)
        if k == 0:
            _, oc = _walk(chunked, sf, org, d, anyhit=True)
            _, op = _walk(plain, sf, org, d, anyhit=True)
            np.testing.assert_array_equal(n(oc), n(op))
            first = (hc, org, d, sf)
    # the chunked terrain (one instance id on many chunk INST rows), the
    # placed objects, and the frame's instances, which only the subframe's
    # dynamic tree (exit-chained into the static root) holds
    inst = n(first[0].inst)
    assert (inst == 0).sum() > 0 and ((inst > 0) & (inst < s.static_instance_count)).sum() > 0
    assert (inst >= s.static_instance_count).sum() == 64

    hc, org, d, sf = first
    jscene = jdevice.SceneDevice(**{k: (None if v is None else jnp.asarray(n(v)))
                                    for k, v in chunked._asdict().items()})
    jf = lambda v: jnp.full(R, v, jnp.int32)
    hj, oj = jax.jit(lambda o, dd: jax_wide_ray_query(
        jscene, jf(sf.tlas.node_count), jf(sf.tlas.node_offset), o, dd, 1e-4, 1e9,
        jnp.ones(R, bool)))(JVec3(*(jnp.asarray(org[:, i]) for i in range(3))),
                            JVec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    _, oc = _walk(chunked, sf, org, d)
    # the origins reach |x| = 90 against the golden scene's 12: the atols
    # scale by 8 (on these rays JAX's FMA contraction moves one thit by
    # 3.6e-5 and its barycentrics by 3.0e-5, same triangle; 58 % of thit
    # bit-equal)
    assert_hits_agree(hc, oc, hj, oj, atol_scale=8.0)


def test_incremental_walks_as_oneshot(scenes, packed):
    """The frame packer's wide tables (static region + frame tail, indexed
    through wide_root_base) give the hits of pack_scene(wide=True)'s one-shot
    tables on the same Scene."""
    s, _ = scenes
    oneshot = pack_scene(s.mesh_buf.arrays(), s.bvh_buf.nodes, s.bvh_buf.links,
                         s.instances, s.subframes, wide=True, device="cpu")
    assert oneshot.wide_root_base is None and packed["w8"].wide_root_base is not None
    org, d = _rays(s, seed=1)
    sf = s.subframes[1]
    _same_hits(_walk(packed["w8"], sf, org, d)[0], _walk(oneshot, sf, org, d)[0])


def test_repack_is_shape_stable(scenes):
    """The next frame's pack has every table in the shape of this frame's
    (the buckets), the static tables are the same tensors, and the
    subframe rows differ."""
    s, _ = scenes
    s = copy.deepcopy(s)
    packer = DevicePacker(s, wide=True, chunk_max=CHUNK_MAX, device="cpu")
    a = packer.pack_frame(s)
    setup_animation_frame(s, FRAME + 1, CFG)
    b = packer.pack_frame(s)
    for k in a._fields:
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            assert va.shape == vb.shape, k
    assert a.tri_shade is b.tri_shade and a.vattr is b.vattr
    assert not torch.equal(a.sf_cam, b.sf_cam)  # the focal distance moves


def test_concat_rows_bitsafe_preserves_subnormal_patterns():
    """tests/test_packer_wide.py's bit patterns: subnormals, NaN and inf
    patterns and signed zeros come through the device concat unchanged."""
    pat = np.array(
        [[0x0037EB38, 0x803649D0, 0xC0000000, 0x00000001,
          0x7F800000, 0x00000000, 0x80000000, 0x3F800000]], np.uint32
    )
    static = np.tile(pat, (700, 1)).view(np.float32)
    tail = np.tile(pat[:, ::-1], (300, 1)).view(np.float32)
    out = n(_concat_rows_bitsafe(torch.from_numpy(static.copy()), tail)).view(np.uint32)
    np.testing.assert_array_equal(out[:700], static.view(np.uint32))
    np.testing.assert_array_equal(out[700:], tail.view(np.uint32))


def test_packer_refusals(scenes):
    s, _ = scenes
    # the hot-row permutation needs the chunked static region (as JAX's
    # needs chunk_max); tests/test_torch_hotperm.py holds the tables
    for kw in ({"wide": True}, {}):
        with pytest.raises(ValueError, match="chunked"):
            DevicePacker(s, hot_rows=64, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePacker(s)
