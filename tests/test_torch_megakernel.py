"""The megakernel slice: ``ops/megakernel.path_trace_megakernel`` (its plain
version on the CPU) against the JAX package's persistent-lane megakernel,
and the port-only parts of the slice (render_pixels' megakernel branch, spp
chunking, auto-selection, error paths, the kernel's wrapper and library).

Bars against JAX, as tests/test_megakernel.py holds the JAX megakernel to
its scan: >= 99 % of the reference's pixels finite, and >= 97 % of them
within 2e-4 + 2e-4 |ref| per channel (the chaotic-lane allowance: a few
ulps of difference turn a bounce elsewhere). The luminance-squared plane is
a square, so its relative error is twice as large: 4e-4 + 4e-4 |ref|.

One JAX megakernel call only: each call traces and compiles its while-loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracing_tpu import render as jrender
from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.ops import megakernel as jmk
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops import cuda_wide_traversal as CW
from pathtracing_tpu_torch.ops import megakernel as tmk
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.traversal import ray_query_plain
from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query_plain
from pathtracing_tpu_torch.scene.golden import (
    scene_device_from_golden,
    scene_device_from_motion_golden,
)
from pathtracing_tpu_torch.testing import golden, n, stack, vec3_t

import golden_scene as jgolden

# a 16x9 frame of the golden camera: every pixel list below is row-major
# [0, N) of it, so the megakernel takes it
SMALL = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=4)


@pytest.fixture(scope="module")
def wide_scene():
    return scene_device_from_golden(golden("scene.gold"), TESTING, wide=True, device="cpu")


@pytest.fixture(scope="module")
def small_xy():
    idx = np.arange(SMALL.image_width * SMALL.image_height, dtype=np.int32)
    return idx % SMALL.image_width, idx // SMALL.image_width


def _within(got, ref, bar):
    """Share of the reference's finite pixels within bar + bar |ref| on every
    channel, and the reference's finite share."""
    finite = np.isfinite(ref).all(-1)
    close = (np.abs(got[finite] - ref[finite]) <= bar + bar * np.abs(ref[finite])).all(-1)
    return close.mean(), finite.mean()


def test_megakernel_matches_jax_megakernel(wide_scene):
    """Samples [5, 7) of 256 pixels from row 200 (walls, floor and objects:
    every walk and bounce of the path runs; row 0 is all sky) with the
    luminance-squared plane, against one call of the JAX megakernel."""
    n_pixels, spp, base = 256, 2, 5
    pixel_base = 200 * TESTING.image_width + 64
    jscene = jgolden.scene_device_from_golden(golden("scene.gold"), wide=True)
    jacc, jl2 = jmk.path_trace_megakernel(
        JTESTING, jscene, n_pixels, spp, base, lanes=64, pixel_base=pixel_base,
        with_stats=True,
    )
    acc, l2, n_trunc = tmk.path_trace_megakernel(
        TESTING, wide_scene, n_pixels, spp, base, pixel_base=pixel_base,
        with_stats=True, return_truncated=True, device="cpu",
    )
    ref, got = stack(jacc)[:n_pixels], stack(acc)
    assert got.shape == (n_pixels, 3) and int(n_trunc[0]) == 0
    close, finite = _within(got, ref, 2e-4)
    assert finite >= 0.99 and close >= 0.97, (finite, close)
    close2, finite2 = _within(n(l2)[:, None], np.asarray(jl2)[:n_pixels, None], 4e-4)
    assert finite2 >= 0.99 and close2 >= 0.97, (finite2, close2)
    # the paths here do hit geometry: not the sky alone
    assert (ref.max(-1) < 0.2).mean() > 0.5


def test_plain_version_is_a_sample_ordered_sum(wide_scene, small_xy):
    """The plain version against its definition: ``path_trace_samples`` per
    sample, summed in sample order, each sample's luminance squared beside
    it; a pixel order only moves which slot renders a pixel."""
    xs, ys = (torch.from_numpy(a) for a in small_xy)
    N = len(xs)
    r, g, b, l2 = tmk.path_trace_megakernel_plain(SMALL, wide_scene, N, 2, 3, 0, True)
    want = np.zeros((N, 3), np.float32)
    want_l2 = np.zeros(N, np.float32)
    for j in range(2):
        c = stack(path_trace_samples(SMALL, wide_scene, xs, ys, torch.full_like(xs, 3 + j)))
        want += c
        lum = (np.float32(0.2126) * c[:, 0] + np.float32(0.7152) * c[:, 1]
               + np.float32(0.0722) * c[:, 2])
        want_l2 += lum * lum
    assert stack((r, g, b)).tobytes() == want.tobytes()
    assert n(l2).tobytes() == want_l2.tobytes()
    order = torch.from_numpy(np.random.default_rng(0).permutation(N).astype(np.int32))
    shuffled = tmk.path_trace_megakernel_plain(SMALL, wide_scene, N, 2, 3, 0, True, order)
    assert all(torch.equal(a, b) for a, b in zip(shuffled, (r, g, b, l2)))


def test_morton_pixel_order_equals_jax():
    for w, h in ((16, 9), (640, 360), (7, 5)):
        got = tmk.morton_pixel_order(w, h)
        want = jmk.morton_pixel_order(w, h)
        assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize(
    "n_pix,spp,acc_mb",
    [(2 * 640, 4, None), (2 * 640, 4, "0"), (1920 * 1080, 1024, None),
     (1920 * 1080, 8, None), (1000, 7, "0"), (640 * 360, 300, "1")],
)
def test_mk_spp_chunk_equals_jax(monkeypatch, n_pix, spp, acc_mb):
    if acc_mb is None:
        monkeypatch.delenv("PT_MK_ACC_MB", raising=False)
    else:
        monkeypatch.setenv("PT_MK_ACC_MB", acc_mb)
    for stats_bytes in (12, 16):
        assert trender._mk_spp_chunk(n_pix, spp, bytes_per_pixel=stats_bytes) == (
            jrender._mk_spp_chunk(n_pix, spp, bytes_per_pixel=stats_bytes)
        )
    assert (trender.DEFAULT_MK_ACC_MB, trender.DEFAULT_MK_DISPATCH_SAMPLES,
            trender.DEFAULT_MK_DISPATCH_SAMPLES_LARGE) == (
        jrender.DEFAULT_MK_ACC_MB, jrender.DEFAULT_MK_DISPATCH_SAMPLES,
        jrender.DEFAULT_MK_DISPATCH_SAMPLES_LARGE)


def test_megakernel_spp_chunking(monkeypatch, wide_scene, small_xy):
    """Chunked partial sums reproduce the single-dispatch result (the
    sample-range seeding contract), as tests/test_megakernel.py checks it."""
    xs, ys = small_xy
    whole = trender.render_pixels(SMALL, wide_scene, xs, ys, spp=4, megakernel=True,
                                  device="cpu")
    monkeypatch.setenv("PT_MK_ACC_MB", "0")
    assert trender._mk_spp_chunk(len(xs), 4) == 1
    chunked = trender.render_pixels(SMALL, wide_scene, xs, ys, spp=4, megakernel=True,
                                    device="cpu")
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-7)
    assert np.isfinite(whole).all() and whole.shape == (len(xs), 3)


def test_megakernel_supported_gives_jax_answer(wide_scene, small_xy):
    binary = scene_device_from_golden(golden("scene.gold"), SMALL, device="cpu")
    xs, ys = small_xy
    perm = np.random.default_rng(1).permutation(len(xs))
    for scene in (wide_scene, binary):
        for px, py in ((xs, ys), (xs[perm], ys[perm]), (xs[:50], ys[:50])):
            assert trender.megakernel_supported(scene, px, py, SMALL.image_width) == (
                jrender.megakernel_supported(scene, px, py, SMALL.image_width)
            )
    assert trender.megakernel_supported(wide_scene, xs, ys, SMALL.image_width)
    assert not trender.megakernel_supported(binary, xs, ys, SMALL.image_width)


def test_megakernel_auto_selection_on_the_cpu_takes_the_scan(monkeypatch, wide_scene,
                                                             small_xy):
    calls = []
    orig = trender.path_trace_megakernel

    def spy(*a, **k):
        calls.append(k.get("device"))
        return orig(*a, **k)

    monkeypatch.setattr(trender, "path_trace_megakernel", spy)
    xs, ys = small_xy
    scan = trender.render_pixels(SMALL, wide_scene, xs, ys, spp=1, device="cpu")
    assert calls == []
    pinned = trender.render_pixels(SMALL, wide_scene, xs, ys, spp=1, megakernel=False,
                                   device="cpu")
    assert calls == [] and scan.tobytes() == pinned.tobytes()
    mk = trender.render_pixels(SMALL, wide_scene, xs, ys, spp=1, megakernel=True,
                               device="cpu")
    assert len(calls) == 1
    # one sample per pixel, both through path_trace_samples: the same bytes
    assert mk.tobytes() == scan.tobytes()


def test_megakernel_error_paths(monkeypatch, wide_scene, small_xy):
    xs, ys = small_xy
    binary = scene_device_from_golden(golden("scene.gold"), SMALL, device="cpu")
    with pytest.raises(ValueError, match="wide tables"):
        trender.render_pixels(SMALL, binary, xs, ys, spp=1, megakernel=True, device="cpu")
    with pytest.raises(ValueError, match="row-major"):
        trender.render_pixels(SMALL, wide_scene, xs[::-1], ys[::-1], spp=1,
                              megakernel=True, device="cpu")
    with pytest.raises(ValueError, match="wide=True"):
        tmk.path_trace_megakernel(SMALL, binary, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="with_stats"):
        tmk.path_trace_megakernel(SMALL, wide_scene, 4, 1, record=True, with_stats=True,
                                  device="cpu")
    # area lights are in; a part of their tables is refused
    lit = wide_scene._replace(lt_tris=torch.zeros((1, 9)))
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        tmk.path_trace_megakernel(SMALL, lit, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        trender.render_pixels(SMALL, lit, xs, ys, spp=1, megakernel=True, device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        tmk.path_trace_megakernel(SMALL, wide_scene, 4, 1, pixel_order=[0, 1, 1, 3],
                                  device="cpu")
    with pytest.raises(TypeError):
        tmk.path_trace_megakernel(SMALL, wide_scene, 4, 1, lanes=64, device="cpu")

    # the step cap's report: render_pixels refuses a darkened frame
    def truncating(*a, **k):
        acc, _ = orig(*a, **k)
        return acc, torch.ones(1, dtype=torch.int32)

    orig = tmk.path_trace_megakernel
    monkeypatch.setattr(trender, "path_trace_megakernel", truncating)
    with pytest.raises(RuntimeError, match="abandoned 1 samples"):
        trender.render_pixels(SMALL, wide_scene, xs, ys, spp=1, megakernel=True,
                              device="cpu")


def test_megakernel_wrapper_refuses_cpu_tensors_and_has_no_fallback(wide_scene):
    before = CM.launches
    with pytest.raises(ValueError, match="CUDA"):
        CM.megakernel_cuda(SMALL, wide_scene, 4, 1)
    assert CM.launches == before  # counted only where the kernel is launched
    src = (CM.SOURCE.parent.parent / "ops" / "cuda_megakernel.py").read_text()
    assert "except" not in src and "path_trace_megakernel_plain(" not in src
    cpu = torch.device("cpu")
    assert CM.check_scene(wide_scene, cpu).w_row == 48
    with pytest.raises(ValueError, match="tri_shade"):
        CM.check_scene(wide_scene._replace(tri_shade=None), cpu)
    with pytest.raises(ValueError, match="no subframe rows"):
        CM.check_scene(wide_scene._replace(sf_light=wide_scene.sf_light[:0]), cpu)
    with pytest.raises(ValueError, match="wide=True"):
        CM.check_scene(wide_scene._replace(wide_rows=None), cpu)
    # the step cap is derived from the tables (CM.step_cap): (instances + 1)
    # trees of at most rows x slots cursors (wide) or nl8 nodes (binary)
    binary = scene_device_from_golden(golden("scene.gold"), SMALL, device="cpu")
    trees = wide_scene.inst_u.shape[0] + 1
    assert CM.step_cap(wide_scene) == trees * wide_scene.wide_rows.shape[0] * 8 > 0
    assert CM.step_cap(binary) == trees * (binary.nl8.shape[0] // 8) > 0
    # one name per counter of the counting build (csrc/path.cuh's enum)
    enum = CM.PATH_HEADER.read_text().split("kSamples,", 1)[1].split("kNCounts", 1)[0]
    assert len(CM.COUNT_NAMES) == len(set(CM.COUNT_NAMES)) == enum.count(",") + 1 == 15


def test_k1_and_k2_share_the_walk():
    """The wide walk lives in one header that both kernels include; K1 is a
    thin caller of it, K2 calls it through the path body of path.cuh (its
    wide walk policy), and both libraries' hashes cover it."""
    assert CW.WALK_HEADER in CW.LIBRARY.headers and CW.WALK_HEADER in CM.LIBRARY.headers
    assert CM.PATH_HEADER in CM.LIBRARY.headers
    k1 = CW.SOURCE.read_text()
    k2 = CM.SOURCE.read_text()
    walk = CW.WALK_HEADER.read_text()
    path = CM.PATH_HEADER.read_text()
    assert "while (cursor != kEndTlas)" in walk
    for src in (k1, k2):
        assert '#include "wide_walk.cuh"' in src and "while (cursor" not in src
    assert "wide_walk<" in k1 and "WideWalk<" in k2 and "wide_walk<" in path
    assert "__global__" in k2 and "torch/extension.h" not in k2


def test_motion_golden_wide_tables_walk_to_the_binary_hits():
    """scene_device_from_motion_golden(wide=True): per subframe, the wide
    walk gives the binary walk's hits on the same rays (ids may differ only
    on an exactly equal t, as between the golden scene's two walks)."""
    g = golden("motion.gold")
    wide = scene_device_from_motion_golden(g, wide=True, device="cpu")
    binary = scene_device_from_motion_golden(g, device="cpu")
    assert wide.tri_shade.shape == (wide.tri_pos.shape[0], 48)
    # the binary tables are the same bytes (nl8's link columns hold NaN bit
    # patterns, so bytes, not values)
    assert all(n(getattr(wide, k)).tobytes() == n(getattr(binary, k)).tobytes()
               for k in ("nl8", "tri_pos", "inst_f", "sf_cam", "sf_light", "sf_tlas_offset"))
    rg = golden("rays.gold")
    R = 512
    org, d = vec3_t(rg["origins"][:R]), vec3_t(rg["dirs"][:R])
    on = torch.ones(R, dtype=torch.bool)
    for s in range(wide.sf_tlas_offset.shape[0]):
        tlc = torch.full((R,), int(wide.sf_tlas_count[s]), dtype=torch.int32)
        tlo = torch.full((R,), int(wide.sf_tlas_offset[s]), dtype=torch.int32)
        for anyhit in (False, True):
            args = (tlc, tlo, org, d, 1e-4, 1e9, on)
            hw, ow = wide_ray_query_plain(wide, *args, anyhit=anyhit)
            hb, ob = ray_query_plain(binary, *args, anyhit=anyhit)
            assert torch.equal(ow, ob) and torch.equal(hw.thit, hb.thit)
            same = (hw.inst == hb.inst) & (hw.prim == hb.prim)
            assert int((~same).sum()) <= 0.002 * R
            if not anyhit:
                assert int((hw.thit > 0).sum()) > R // 4  # the rays do hit
