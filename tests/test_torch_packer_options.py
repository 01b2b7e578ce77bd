"""The chunked packer's options, ``setup_animation_frame(build_tlas_trees=
False)`` and the bounded binary walk against the JAX package's, on the CPU.

The packs (scene/device.DevicePacker, accel/chunks.py) on the animated
scene of tests/test_torch_packer.py (stand-in meshes, frame 1000, two
subframes): for ``chunk_max`` 256 / 1024 x ``octants`` 1 / 8, for
``bake_static=True`` and for ``hot_rows=1024`` on ``octants=1``, the static
region's rows and ``static_root8`` and every table of the frame byte-equal
to the JAX package's. The plain wide walk on the ``octants=1`` and the
baked packs against the base pack: ``octants=1`` keeps every candidate and
its arithmetic, so ids are equal up to exact-t ties and ``thit`` is
bit-equal; the baked pack tests world-space triangles, so ``thit`` moves by
ulps (measured: 85.4 % of lanes bit-equal, at most 1.3e-5) and ids are equal
on these rays (the JAX ray-query bar allows 99.8 %).

``build_tlas_trees=False``: the port's form of tests/test_scene_loader.py's
``test_skip_tlas_trees_same_wide_tables``: the chunked frame tables and
every subframe's root cursors byte-identical to ``True``'s, and equal to the
JAX package's tables after its own ``build_tlas_trees=False``.

The bounded walk, on the golden scene and rays.gold (nl8 and nl5 rows):
``ray_query_plain(max_steps=k, return_state=True)`` for k in 1, 4, 16 has
every ``_TravState`` field bit-equal to JAX's ``ray_query(max_steps=k,
return_state=True, leaf_every=None, compact_after=None)`` run op by op
(``jax.disable_jit``), and the bounded hit is finalized from that state.
JAX's compiled loop is held on the integer fields only: XLA:CPU contracts
the instance transform's and the triangle test's mul + add into FMAs, which
moves ``b_org`` / ``b_inv`` / ``b_S`` / ``tmax`` by ulps (the op-by-op run
rounds every op, as the port and the oracle do). One compiled JAX call (the
bounded walk on nl8 rows); the rest of JAX's work is packing and the
op-by-op walks (~60 s for the file on one worker)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops.traversal import ray_query as jax_ray_query
from pathtracing_tpu.scene import device as jdevice
from pathtracing_tpu.scene import loader as jloader
from pathtracing_tpu.utils.vec import Vec3 as JVec3
from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops.traversal import _TravState, ray_query, ray_query_plain
from pathtracing_tpu_torch.scene.device import DevicePacker, with_bf16_nodes
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.scene.loader import load_scene, setup_animation_frame
from pathtracing_tpu_torch.scene.standins import write_standins
from pathtracing_tpu_torch.testing import assert_same_tables, golden, n, vec3_t

import golden_scene as jgolden
from test_torch_packer import CFG, FRAME, _rays, _walk, to_jax_scene

# DevicePacker options per case; the JAX package's packer takes the same
PACKS = {
    "c1024_o8": {"chunk_max": CHUNK_MAX},
    "c256_o8": {"chunk_max": 256},
    "c1024_o1": {"chunk_max": CHUNK_MAX, "octants": 1},
    "c256_o1": {"chunk_max": 256, "octants": 1},
    "bake": {"chunk_max": CHUNK_MAX, "bake_static": True},
    "hot_o1": {"chunk_max": CHUNK_MAX, "octants": 1, "hot_rows": 1024},
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("standins")
    write_standins(d)
    s = load_scene(data_dir=str(d), config=CFG, device="cpu")
    setup_animation_frame(s, FRAME, CFG)
    return s, to_jax_scene(s)


@pytest.fixture(scope="module")
def packs(scenes):
    """The port's (packer, frame tables) per case, packed once."""
    s, _ = scenes
    out = {}

    def get(case):
        if case not in out:
            p = DevicePacker(s, wide=True, device="cpu", **PACKS[case])
            out[case] = (p, p.pack_frame(s))
        return out[case]

    return get


@pytest.mark.parametrize("case", PACKS)
def test_pack_matches_jax(scenes, packs, case):
    s, js = scenes
    mine, frame = packs(case)
    theirs = jdevice.DevicePacker(js, wide=True, **PACKS[case])
    a, b = mine._wide_static, theirs._wide_static
    assert (a.chunk_max, a.octants, a.bake_static) == (b.chunk_max, b.octants, b.bake_static)
    assert a.rows.tobytes() == np.asarray(b.rows).tobytes()
    assert np.asarray(a.static_root8).tobytes() == np.asarray(b.static_root8).tobytes()
    assert_same_tables(frame, theirs.pack_frame(js))
    if a.octants == 1:
        # one tree per chunk and TLAS: every root cursor aliases octant 0's
        assert (a.static_root8 == a.static_root8[0]).all()
        for _, _, r8 in a.chunks_of.values():
            assert (r8 == r8[:, :1]).all()
    if "hot_rows" in PACKS[case]:
        assert a.hot_count == b.hot_count == PACKS[case]["hot_rows"]


def test_bake_needs_the_native_builder(scenes, monkeypatch):
    import pathtracing_tpu_torch.accel.chunks as chunks

    s, _ = scenes
    monkeypatch.setattr(chunks, "_use_native", lambda: False)
    with pytest.raises(RuntimeError, match="native wide builder"):
        DevicePacker(s, wide=True, chunk_max=CHUNK_MAX, bake_static=True, device="cpu")
    with pytest.raises(AssertionError):
        DevicePacker(s, wide=True, chunk_max=CHUNK_MAX, octants=4, device="cpu")


def test_octants_1_and_bake_walk_as_the_base_pack(scenes, packs):
    """The plain wide walk on the octants=1 and the baked packs against the
    base pack, closest and any-hit, on both subframes and within the path
    kernels' step cap."""
    s, _ = scenes
    base, o1, bake = (packs(c)[1] for c in ("c1024_o8", "c1024_o1", "bake"))
    org, d = _rays(s)
    for sf in s.subframes:
        hb, _ = _walk(base, sf, org, d)
        _, ob = _walk(base, sf, org, d, anyhit=True)
        for scene, name in ((o1, "o1"), (bake, "bake")):
            h, _, counts = _walk(scene, sf, org, d, return_counts=True)
            _, oc = _walk(scene, sf, org, d, anyhit=True)
            assert int(counts.lane_steps.max()) <= CM.step_cap(scene)
            np.testing.assert_array_equal(n(oc), n(ob))
            same_ids = (n(h.inst) == n(hb.inst)) & (n(h.prim) == n(hb.prim))
            if name == "o1":
                # another order over the same candidates: a differing id is
                # an exact-t tie, and t is the same bits
                np.testing.assert_array_equal(n(h.thit), n(hb.thit))
            else:
                assert same_ids.mean() >= 0.998, same_ids.mean()
                # the atol of tests/test_torch_packer.py at |x| <= 90
                np.testing.assert_allclose(n(h.thit), n(hb.thit), rtol=2e-5, atol=8e-5)
                assert 0.8 < float((n(h.thit) == n(hb.thit)).mean()) < 1.0
            assert same_ids.mean() == 1.0  # measured on these rays


def test_skip_tlas_trees_same_tables(scenes):
    """build_tlas_trees=False: zero-count subframe handles, the chunked
    tables and root cursors of True's byte for byte, and the JAX package's
    tables after its own False."""
    s, js = scenes
    s, js = copy.deepcopy(s), copy.deepcopy(js)
    packer = DevicePacker(s, wide=True, chunk_max=512, device="cpu")

    def roots(dev, subframes):
        base = int(dev.wide_root_base)
        return [n(dev.wide_root[sf.tlas.node_offset - base]).tobytes() for sf in subframes]

    setup_animation_frame(s, 42, CFG)
    a = packer.pack_frame(s)
    roots_a = roots(a, s.subframes)
    setup_animation_frame(s, 42, CFG, build_tlas_trees=False)
    assert all(sf.tlas.node_count == 0 for sf in s.subframes)
    assert len({sf.tlas.node_offset for sf in s.subframes}) == len(s.subframes)
    b = packer.pack_frame(s)
    assert n(a.wide_rows).tobytes() == n(b.wide_rows).tobytes()
    assert roots_a == roots(b, s.subframes)

    jpacker = jdevice.DevicePacker(js, wide=True, chunk_max=512)
    jloader.setup_animation_frame(js, 42, CFG, build_tlas_trees=False)
    assert_same_tables(b, jpacker.pack_frame(js))
    # the next frame with the trees again starts from the static buffers
    setup_animation_frame(s, 43, CFG)
    assert all(sf.tlas.node_count > 0 for sf in s.subframes)


@pytest.fixture(scope="module")
def golden_walk():
    sg, rg = golden("scene.gold"), golden("rays.gold")
    R = len(rg["origins"])
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    jfull = lambda v: jnp.full(R, int(v), jnp.int32)
    port = (full(sg["tlas"][0]), full(sg["tlas"][1]), vec3_t(rg["origins"]),
            vec3_t(rg["dirs"]), 0.0, 1e9, torch.ones(R, dtype=torch.bool))
    jax_args = (jfull(sg["tlas"][0]), jfull(sg["tlas"][1]),
                JVec3(*(jnp.asarray(rg["origins"][:, i]) for i in range(3))),
                JVec3(*(jnp.asarray(rg["dirs"][:, i]) for i in range(3))),
                0.0, 1e9, jnp.ones(R, bool))
    scene = scene_device_from_golden(sg, device="cpu")
    jscene = jgolden.scene_device_from_golden(sg)
    return {
        "nl8": (scene, jscene),
        "nl5": (with_bf16_nodes(scene), jdevice.with_bf16_nodes(jscene)),
    }, port, jax_args, sg


def _jax_bounded(jscene, jax_args, k, **kw):
    return jax_ray_query(jscene, *jax_args, max_steps=k, leaf_every=None,
                         compact_after=None, **kw)


@pytest.mark.parametrize("rows", ["nl8", "nl5"])
def test_bounded_state_matches_jax(golden_walk, rows):
    tables, port, jax_args, sg = golden_walk
    scene, jscene = tables[rows]
    done = []
    for k in (1, 4, 16):
        mine = ray_query_plain(scene, *port, max_steps=k, return_state=True)
        with jax.disable_jit():
            theirs = _jax_bounded(jscene, jax_args, k, return_state=True)
        for f in _TravState._fields:
            a, b = n(getattr(mine, f)), np.asarray(getattr(theirs, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (k, f)
        done.append(int(n(mine.done).sum()))
    assert 0 == done[0] < done[1] < done[2] < len(n(mine.done))  # mid-walk states

    # the bounded hit: finalized from the bounded state, as JAX's
    hit, occ = ray_query_plain(scene, *port, max_steps=16)
    with jax.disable_jit():
        jhit, jocc = _jax_bounded(jscene, jax_args, 16)
    for f in hit._fields:
        assert n(getattr(hit, f)).tobytes() == np.asarray(getattr(jhit, f)).tobytes(), f
    np.testing.assert_array_equal(n(occ), np.asarray(jocc))
    np.testing.assert_array_equal(n(hit.thit) >= 0, n(mine.c_inst) >= 0)

    if rows == "nl8":
        # JAX's compiled loop: the same integer state; the floats of the
        # instance transform and the triangle test within FMA ulps
        theirs = jax.jit(lambda *a: _jax_bounded(jscene, a, 16, return_state=True))(*jax_args)
        for f in _TravState._fields:
            a, b = n(getattr(mine, f)), np.asarray(getattr(theirs, f))
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6, err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_bounded_walk_routes_and_ends(golden_walk):
    """max_steps / return_state take the binary walk on a wide scene; a bound
    past the longest lane gives the unbounded walk's hits; no bound with
    return_state gives the finished state."""
    tables, port, _, sg = golden_walk
    scene = tables["nl8"][0]
    wide = scene_device_from_golden(sg, wide=True, device="cpu")
    full = ray_query_plain(scene, *port)
    state = ray_query(wide, *port, return_state=True)
    assert bool(n(state.done).all())
    longest = next(k for k in (64, 128, 256, 512, 1024)
                   if bool(n(ray_query(wide, *port, max_steps=k, return_state=True).done).all()))
    bounded = ray_query(wide, *port, max_steps=longest)
    for a, b in zip((*full[0], full[1]), (*bounded[0], bounded[1])):
        assert n(a).tobytes() == n(b).tobytes()
    short = ray_query(wide, *port, max_steps=4)
    assert (n(short[0].thit) >= 0).sum() < (n(full[0].thit) >= 0).sum()
    with pytest.raises(ValueError, match="return_counts"):
        ray_query_plain(scene, *port, return_counts=True, return_state=True)


def test_bounded_kernel_wrapper_on_cpu(golden_walk):
    """The bounded kernel's wrapper refuses CPU tensors (no way to the plain
    version), and its decoding of the kernel's int32 planes gives back a
    state field for field: floats by their bits, bools from 0 / 1."""
    from pathtracing_tpu_torch.ops import cuda_traversal as CT

    tables, port, _, _ = golden_walk
    scene = tables["nl8"][0]
    with pytest.raises(ValueError, match="CUDA"):
        CT.ray_query_cuda(scene, *port, max_steps=4, return_state=True)
    want = ray_query_plain(scene, *port, max_steps=16, return_state=True)
    planes = torch.stack([
        v.view(torch.int32) if v.dtype == torch.float32 else v.to(torch.int32)
        for v in want])
    got = CT.state_from_planes(planes)
    assert list(CT.STATE_DTYPES) == list(_TravState._fields)
    for f in _TravState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and n(a).tobytes() == n(b).tobytes(), f
