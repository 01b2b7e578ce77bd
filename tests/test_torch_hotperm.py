"""The hot-row permutation (accel/hotperm.py) and the hot tables of
``DevicePacker(hot_rows=)`` against the JAX package's, on the CPU, on the
chunked tables of the animated scene at frame 1000 loaded from stand-in
meshes (tests/test_torch_packer.py's scene, copied into the JAX package's
host types).

The permutation moves row addresses only: the permuted static region, its
root tables, ``wide_rows``, ``hot_rows`` and ``hot_planes`` are byte-equal
to the JAX package's; the port's walks read every row from ``wide_rows``
(the JAX walk's one-hot hot-row fetch is a plain row gather here), so the
plain wide walk's hits and the megakernel's plain sums on the permuted pack
are bit-equal to the unpermuted pack's. No JAX render runs."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracing_tpu.accel import hotperm as jhotperm
from pathtracing_tpu.scene import device as jdevice
from pathtracing_tpu_torch.accel.hotperm import build_perm, scan_kinds
from pathtracing_tpu_torch.convert import scene_from_jax
from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel_plain
from pathtracing_tpu_torch.scene.device import DevicePacker, _hot_byte_planes
from pathtracing_tpu_torch.scene.loader import load_scene, setup_animation_frame
from pathtracing_tpu_torch.scene.standins import write_standins
from pathtracing_tpu_torch.testing import assert_same_tables, n

from test_torch_packer import CFG, FRAME, JAX_CHUNK_MAX, _rays, _walk, to_jax_scene

HOT = 1024  # the JAX CLI's hot table


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("standins")
    write_standins(d)
    s = load_scene(data_dir=str(d), config=CFG, device="cpu")
    setup_animation_frame(s, FRAME, CFG)
    return s, to_jax_scene(s)


@pytest.fixture(scope="module")
def packers(scenes):
    s, _ = scenes
    base = DevicePacker(s, wide=True, chunk_max=JAX_CHUNK_MAX, device="cpu")
    hot = DevicePacker(s, wide=True, chunk_max=JAX_CHUNK_MAX, hot_rows=HOT, device="cpu")
    return base, hot, base.pack_frame(s), hot.pack_frame(s)


def test_hot_tables_match_jax(scenes, packers):
    s, js = scenes
    _, hot, base_dev, hot_dev = packers
    jpacker = jdevice.DevicePacker(js, wide=True, chunk_max=JAX_CHUNK_MAX, hot_rows=HOT)
    assert_same_tables(hot_dev, jpacker.pack_frame(js))
    mine, theirs = hot._wide_static, jpacker._wide_static
    assert mine.hot_count == theirs.hot_count == HOT
    assert np.asarray(mine.rows).tobytes() == np.asarray(theirs.rows).tobytes()
    np.testing.assert_array_equal(mine.static_root8, theirs.static_root8)
    assert mine.chunks_of.keys() == theirs.chunks_of.keys()
    for k in mine.chunks_of:
        np.testing.assert_array_equal(mine.chunks_of[k][2], theirs.chunks_of[k][2])
    # the permutation moved rows: the table differs from the unpermuted
    # one, its prefix is the hot table, and the planes hold its words
    assert n(hot_dev.wide_rows).tobytes() != n(base_dev.wide_rows).tobytes()
    assert n(hot_dev.hot_rows).tobytes() == n(hot_dev.wide_rows)[:HOT].tobytes()
    planes = n(hot_dev.hot_planes).astype(np.int32) + 128
    words = sum(planes[:, b * 48:(b + 1) * 48].astype(np.uint32) << (8 * b) for b in range(4))
    assert words.astype(np.uint32).tobytes() == n(hot_dev.hot_rows).tobytes()
    assert base_dev.hot_rows is None and base_dev.hot_planes is None
    np.testing.assert_array_equal(_hot_byte_planes(n(hot_dev.hot_rows)),
                                  jdevice._hot_byte_planes(n(hot_dev.hot_rows)))


def test_scan_kinds_and_measured_score_match_jax(packers):
    """The BFS row kinds of the static region, and a measured score's
    prefix: the top-scored rows at [0, H) in score order, the rest in their
    order after them; both equal to the JAX package's."""
    base = packers[0]._wide_static
    lay = base.layout
    rows = np.asarray(base.rows, np.float32).view(np.uint32)
    roots = np.concatenate([np.asarray(base.static_root8, np.uint32)] +
                           [np.asarray(r8, np.uint32).ravel()
                            for _, _, r8 in base.chunks_of.values()])
    kinds, levels = scan_kinds(rows, lay, roots)
    jkinds, jlevels = jhotperm.scan_kinds(rows, lay, roots)
    np.testing.assert_array_equal(kinds, jkinds)
    np.testing.assert_array_equal(levels, jlevels)
    assert (kinds >= 0).mean() > 0.99  # every row reached
    score = np.random.default_rng(0).permutation(1000).astype(np.float64)
    perm = build_perm(score, 16)
    np.testing.assert_array_equal(perm, jhotperm.build_perm(score, 16))
    top = np.argsort(-score)[:16]
    np.testing.assert_array_equal(perm[top], np.arange(16))
    rest = np.setdiff1d(np.arange(1000), top)
    assert (np.diff(perm[rest]) > 0).all()


def test_measured_score_packs_as_jax(scenes):
    """DevicePacker(hot_score=) takes the measured order: the same tables
    as the JAX package's packer given the same score."""
    s, js = scenes
    score = np.random.default_rng(1).random(50_000)
    got = DevicePacker(s, wide=True, chunk_max=JAX_CHUNK_MAX, hot_rows=256, hot_score=score,
                       device="cpu").pack_frame(s)
    want = jdevice.DevicePacker(js, wide=True, chunk_max=JAX_CHUNK_MAX, hot_rows=256,
                                hot_score=score).pack_frame(js)
    assert_same_tables(got, want)


def test_permuted_walks_are_bit_equal(scenes, packers):
    """The plain wide walk (K1's plain version) and the megakernel's plain
    version on the permuted pack: every hit, occlusion and sum equal to the
    unpermuted pack's."""
    s, _ = scenes
    _, _, base, hot = packers
    org, d = _rays(s, seed=2)
    for sf in s.subframes:
        for anyhit in (False, True):
            ha, oa = _walk(base, sf, org, d, anyhit)
            hb, ob = _walk(hot, sf, org, d, anyhit)
            for k in ha._fields:
                np.testing.assert_array_equal(n(getattr(ha, k)), n(getattr(hb, k)), err_msg=k)
            np.testing.assert_array_equal(n(oa), n(ob))
    cfg = dataclasses.replace(CFG, max_bounces=3)
    a = path_trace_megakernel_plain(cfg, base, 48, 1, sample_base=0, pixel_base=60)
    b = path_trace_megakernel_plain(cfg, hot, 48, 1, sample_base=0, pixel_base=60)
    for x, y in zip(a[:3], b[:3]):
        assert n(x).tobytes() == n(y).tobytes()
    assert float(a[0].sum()) > 0


def test_hot_rows_need_the_chunked_region_and_cross_over(scenes, packers):
    s, _ = scenes
    for kw in ({"wide": True}, {"chunk_max": JAX_CHUNK_MAX}, {}):
        with pytest.raises(ValueError, match="chunked"):
            DevicePacker(s, hot_rows=HOT, device="cpu", **kw)
    hot = packers[3]
    back = scene_from_jax({k: n(v) for k, v in hot._asdict().items() if v is not None},
                          device="cpu")
    for k, v in hot._asdict().items():
        if v is None:
            assert getattr(back, k) is None, k
        else:
            assert getattr(back, k).dtype == v.dtype and n(getattr(back, k)).tobytes() == \
                n(v).tobytes(), k
    assert back.hot_planes.dtype == torch.int8
