"""The wavefront slice: ``ops/wavefront.path_trace_wavefront`` (its plain
version on the CPU) against the JAX package's path-regeneration renderer,
and the port-only parts of the slice (render_pixels' and render_frame's
wavefront branch, the device-side sums and average, the kernel's wrapper and
library, the step cap derived from the tables).

Bars against JAX, as tests/test_wavefront.py holds the JAX wavefront to its
scan: >= 99 % of the reference's entries finite, and >= 97 % of them within
2e-4 + 2e-4 |ref| per channel (the chaotic-lane allowance); the
luminance-squared plane is a square: 4e-4 + 4e-4 |ref|.

One JAX wavefront call only: each call traces and compiles its while-loop.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.ops import wavefront as jwf
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.ops import cuda_wavefront as CWF
from pathtracing_tpu_torch.ops import wavefront as twf
from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel_plain
from pathtracing_tpu_torch.ops.traversal import ray_query_plain
from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query_plain
from pathtracing_tpu_torch.scene.golden import (
    scene_device_from_golden,
    scene_device_from_motion_golden,
)
from pathtracing_tpu_torch.testing import golden, n, stack, vec3_t

import golden_scene as jgolden

SMALL = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=3)


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return {
        "binary": scene_device_from_golden(g, TESTING, device="cpu"),
        "wide": scene_device_from_golden(g, TESTING, wide=True, device="cpu"),
    }


@pytest.fixture(scope="module")
def pixel_list():
    """256 entries of the golden 640x360 frame: most from the rows with
    geometry (row 150 down; the rows above are sky), a few anywhere, and a
    run of duplicates of the first entry."""
    rng = np.random.default_rng(6)
    xs = rng.integers(0, TESTING.image_width, 256).astype(np.int32)
    ys = rng.integers(150, TESTING.image_height, 256).astype(np.int32)
    ys[:16] = rng.integers(0, TESTING.image_height, 16)
    xs[40:48], ys[40:48] = xs[16], ys[16]
    return xs, ys


def _within(got, ref, bar):
    finite = np.isfinite(ref).all(-1)
    close = (np.abs(got[finite] - ref[finite]) <= bar + bar * np.abs(ref[finite])).all(-1)
    return close.mean(), finite.mean()


def test_wavefront_matches_jax_wavefront(scenes, pixel_list):
    """Samples [6, 8) of the list on the binary tables, with the
    luminance-squared plane, against one call of the JAX wavefront."""
    xs, ys = pixel_list
    jscene = jgolden.scene_device_from_golden(golden("scene.gold"))
    jacc, jl2 = jwf.path_trace_wavefront(JTESTING, jscene, xs, ys, 2, sample_base=6,
                                         with_stats=True)
    acc, l2, n_trunc = twf.path_trace_wavefront(
        TESTING, scenes["binary"], xs, ys, 2, sample_base=6, with_stats=True,
        return_truncated=True, device="cpu",
    )
    ref, got = stack(jacc), stack(acc)
    assert got.shape == (256, 3) and int(n_trunc[0]) == 0
    close, finite = _within(got, ref, 2e-4)
    assert finite >= 0.99 and close >= 0.97, (finite, close)
    close2, finite2 = _within(n(l2)[:, None], np.asarray(jl2)[:, None], 4e-4)
    assert finite2 >= 0.99 and close2 >= 0.97, (finite2, close2)
    # duplicate entries each get their own (equal) sums; the paths hit
    # geometry, not the sky alone
    assert (got[40:48] == got[16]).all()
    assert (ref.max(-1) < 0.2).mean() > 0.5


def test_plain_wavefront_binary_and_wide_bit_equal(scenes, pixel_list):
    """The wide walk confirms the binary walk's candidates: the same sums to
    the bit, with the lum^2 plane."""
    xs, ys = (torch.from_numpy(a) for a in pixel_list)
    a = twf.path_trace_wavefront_plain(TESTING, scenes["binary"], xs, ys, 2, 3, True)
    b = twf.path_trace_wavefront_plain(TESTING, scenes["wide"], xs, ys, 2, 3, True)
    assert all(n(u).tobytes() == n(v).tobytes() for u, v in zip(a, b))


def test_megakernel_plain_is_the_wavefront_plain_over_its_list(scenes):
    """One plain path loop: the megakernel's plain version is the wavefront's
    over the slots' pixels, put at their pixels."""
    W = TESTING.image_width
    N, base = 96, 200 * W + 64
    order = torch.from_numpy(np.random.default_rng(2).permutation(N).astype(np.int32))
    got = path_trace_megakernel_plain(TESTING, scenes["wide"], N, 2, 5, base, True, order)
    pix = order + base
    want = twf.path_trace_wavefront_plain(TESTING, scenes["wide"], pix % W, pix // W, 2, 5,
                                          True)
    for g, w in zip(got, want):
        assert torch.equal(g[order.long()], w)


def test_render_pixels_wavefront_equals_the_scan(scenes):
    """A list that is not row-major, in ragged tiles: the wavefront's plain
    version gives the scan's bytes (same tiles, same samples, same fold), raw
    sums and averages on the binary tables, raw sums on the wide ones."""
    rng = np.random.default_rng(4)
    xs = rng.integers(0, SMALL.image_width, 70).astype(np.int32)
    ys = rng.integers(0, SMALL.image_height, 70).astype(np.int32)
    for kind, average in (("binary", True), ("binary", False), ("wide", False)):
        kw = dict(spp=2, sample_base=2, tile_pixels=32, average=average, device="cpu")
        wf = trender.render_pixels(SMALL, scenes[kind], xs, ys, wavefront=True, **kw)
        scan = trender.render_pixels(SMALL, scenes[kind], xs, ys, **kw)
        assert wf.shape == (70, 3) and wf.tobytes() == scan.tobytes()
    with pytest.raises(ValueError, match="pick one"):
        trender.render_pixels(SMALL, scenes["wide"], xs, ys, wavefront=True,
                              megakernel=True, device="cpu")


@pytest.mark.parametrize("wavefront", [False, True])
def test_render_frame_bytes_equal_the_host_path(scenes, wavefront):
    """render_frame averages and tonemaps on the device, and copies back
    once: its colours and BGRA are the bytes of the host path (raw sums,
    numpy's float32 division, to_bgra) at spp 3, where a division by 3 and a
    multiply by its reciprocal differ."""
    scene = scene_device_from_golden(golden("scene.gold"), SMALL, device="cpu")
    colors, image = trender.render_frame(SMALL, scene, wavefront=wavefront, device="cpu")
    idx = np.arange(16 * 9, dtype=np.int32)
    raw = trender.render_pixels(SMALL, scene, idx % 16, idx // 16, average=False,
                                wavefront=wavefront, device="cpu")
    want = (raw / np.float32(3)).reshape(9, 16, 3)
    assert colors.dtype == np.float32 and colors.tobytes() == want.tobytes()
    assert image.tobytes() == trender.to_bgra(want, "cpu").tobytes()
    # the division itself, on values where the reciprocal's product differs
    x = np.random.default_rng(1).uniform(0, 50, 4096).astype(np.float32)
    x[:4] = (0.0, 1e-40, 3.0, np.float32(0.1))
    for spp in (3, 8):
        got = n(trender._average(torch.from_numpy(x), spp))
        assert got.tobytes() == (x / np.float32(spp)).tobytes()
    assert (x * (np.float32(1) / np.float32(3)) != x / np.float32(3)).any()


def test_wavefront_error_paths(monkeypatch, scenes):
    xs = np.arange(4, dtype=np.int32)
    # area lights are in; a part of their tables is refused
    lit = scenes["binary"]._replace(lt_tris=torch.zeros((1, 9)))
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        twf.path_trace_wavefront(TESTING, lit, xs, xs, 1, device="cpu")
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        trender.render_pixels(TESTING, lit, xs, xs, spp=1, wavefront=True, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        twf.path_trace_wavefront(TESTING, scenes["binary"], xs, xs[:3], 1, device="cpu")
    with pytest.raises(ValueError, match="scene is on"):
        twf.path_trace_wavefront(TESTING, scenes["binary"]._replace(
            nl8=scenes["binary"].nl8.to("meta")), xs, xs, 1, device="cpu")
    # the step cap's report: render_pixels refuses a darkened output
    def truncating(*a, **k):
        acc, _ = twf.path_trace_wavefront(*a, **k)
        return acc, torch.ones(1, dtype=torch.int32)

    monkeypatch.setattr(trender, "path_trace_wavefront", truncating)
    with pytest.raises(RuntimeError, match="wavefront step cap abandoned 1 samples"):
        trender.render_pixels(SMALL, scenes["binary"], xs, xs, spp=1, wavefront=True,
                              device="cpu")


def test_wavefront_wrapper_refuses_what_the_kernel_does_not_take(scenes):
    """The wrapper raises on CPU tensors and never gives way to the plain
    version; its table checks cover both table kinds."""
    binary, wide = scenes["binary"], scenes["wide"]
    xs = torch.zeros(4, dtype=torch.int32)
    before = CWF.launches
    with pytest.raises(ValueError, match="CUDA"):
        CWF.wavefront_cuda(TESTING, binary, xs, xs, 1)
    assert CWF.launches == before  # counted only where the kernel is launched
    src = CWF.SOURCE.parent.parent.joinpath("ops", "cuda_wavefront.py").read_text()
    assert "except" not in src and "path_trace_wavefront_plain(" not in src
    cpu = torch.device("cpu")
    assert CWF.check_scene(binary, cpu) == 0 and CWF.check_scene(wide, cpu) == 48
    with pytest.raises(TypeError, match="dtype"):
        CWF.check_scene(binary._replace(tri_idx=binary.tri_idx.float()), cpu)
    with pytest.raises(ValueError, match="shape"):
        CWF.check_scene(binary._replace(vattr=binary.vattr[:, :11].contiguous()), cpu)
    flat = torch.zeros(binary.nl8.numel() + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        CWF.check_scene(binary._replace(nl8=flat[1:].view(binary.nl8.shape)), cpu)
    with pytest.raises(ValueError, match="no subframe rows"):
        CWF.check_scene(binary._replace(sf_tlas_count=binary.sf_tlas_count[:0]), cpu)
    with pytest.raises(ValueError, match="tri_shade"):
        CWF.check_scene(wide._replace(tri_shade=None), cpu)
    with pytest.raises(ValueError, match="area-light tables incomplete"):
        CWF.check_scene(binary._replace(lt_tris=torch.zeros((1, 9))), cpu)
    # one argument per parameter of pt_wavefront, pointers where it takes them
    r = torch.zeros(4)
    args = CWF.kernel_args(TESTING, binary, 0, xs, xs, 1, 0, 8, r, r, r, None,
                           torch.zeros(1, dtype=torch.int32), None, None)
    assert len(args) == len(CWF.ARGTYPES)
    assert args[0] is None and args[5] == binary.nl8.data_ptr()


def test_p1_k2_and_k5_share_the_headers():
    """P1 and K5 include the binary walk, K2 and K5 the path body; each
    library's hash covers the headers its source includes."""
    assert CT.WALK_HEADER == CWF.WALK_HEADER
    assert CT.WALK_HEADER in CT.LIBRARY.headers and CT.WALK_HEADER in CWF.LIBRARY.headers
    assert CM.PATH_HEADER in CM.LIBRARY.headers and CM.PATH_HEADER in CWF.LIBRARY.headers
    p1, k2, k5 = (lib.source.read_text() for lib in (CT.LIBRARY, CM.LIBRARY, CWF.LIBRARY))
    walk = CT.WALK_HEADER.read_text()
    path = CM.PATH_HEADER.read_text()
    assert "binary_walk(" in walk and "while (!done)" in walk
    for src in (p1, k5):
        assert '#include "binary_walk.cuh"' in src and "while (" not in src
    assert "binary_walk<" in p1 and "BinaryWalk" in k5 and "binary_walk<" in path
    for src in (k2, k5):
        assert '#include "path.cuh"' in src and "trace_samples(" in src
        assert "for (int b = 0;" not in src
    assert "bool trace_sample(" in path and "torch/extension.h" not in k5


def test_step_cap_bounds_the_plain_walks(scenes):
    """The derived cap is at or above the longest walk the plain walks make
    (``lane_steps``) on the golden and the motion scene, for both table
    kinds, in closest and any-hit mode, from each distinct TLAS root."""
    rg = golden("rays.gold")
    R = 256
    org, d = vec3_t(rg["origins"][:R]), vec3_t(rg["dirs"][:R])
    on = torch.ones(R, dtype=torch.bool)
    mg = golden("motion.gold")
    cases = [
        (scenes["binary"], scenes["wide"]),
        (scene_device_from_motion_golden(mg, device="cpu"),
         scene_device_from_motion_golden(mg, wide=True, device="cpu")),
    ]
    for binary, wide in cases:
        roots = set(zip(binary.sf_tlas_count.tolist(), binary.sf_tlas_offset.tolist()))
        for count, offset in sorted(roots):
            tlc = torch.full((R,), count, dtype=torch.int32)
            tlo = torch.full((R,), offset, dtype=torch.int32)
            for anyhit in (False, True):
                args = (tlc, tlo, org, d, 1e-4, 1e9, on)
                *_, cb = ray_query_plain(binary, *args, anyhit=anyhit, return_counts=True)
                *_, cw = wide_ray_query_plain(wide, *args, anyhit=anyhit,
                                              return_counts=True)
                assert 0 < int(cb.lane_steps.max()) <= CM.step_cap(binary)
                assert 0 < int(cw.lane_steps.max()) <= CM.step_cap(wide)
