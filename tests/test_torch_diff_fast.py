"""The port's record/replay gradients (``diff/render.make_fast_grad_fn``,
``make_fast_grad_frame_fn``), the megakernel's record mode
(``path_trace_megakernel(record=True)``, whose plain version runs here), and
the walks kept out of the autograd graph. Port only: no JAX call.

The fast paths must give the slow path's fixed-topology gradients up to
float summation order: held at tests/test_diff_fast.py's bar (loss rtol
1e-4; every field rtol 2e-2, atol 2e-2 * max|ref|; support within 2
entries). The replay's radiance is bit-equal to the direct radiance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.convert import grads_to_numpy
from pathtracing_tpu_torch.diff import render as drender
from pathtracing_tpu_torch.diff.render import (
    frame_items,
    make_fast_grad_fn,
    make_fast_grad_frame_fn,
    render_value_and_grad,
)
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops import megakernel as tmk
from pathtracing_tpu_torch.ops.integrator import (
    path_trace_samples,
    path_trace_samples_masked_records,
)
from pathtracing_tpu_torch.ops.traversal import ray_query
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, stack
from pathtracing_tpu_torch.utils.vec import Vec3

CFG = dataclasses.replace(TESTING, max_bounces=2)
# a 16x9 frame of the golden camera (tests/test_torch_megakernel.py's SMALL)
SMALL = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=4)

XS = np.array([300, 320, 340, 360, 380, 400, 420, 440], np.int32)
YS = np.array([170, 180, 190, 160, 170, 180, 190, 200], np.int32)


def _lanes():
    return (torch.from_numpy(XS), torch.from_numpy(YS),
            torch.zeros(len(XS), dtype=torch.int32))


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return {"binary": scene_device_from_golden(g, TESTING, device="cpu"),
            "wide": scene_device_from_golden(g, TESTING, wide=True, device="cpu")}


def _assert_grads_close(loss_a, ga, loss_b, gb):
    np.testing.assert_allclose(float(loss_b), float(loss_a), rtol=1e-4)
    a_np, b_np = grads_to_numpy(ga), grads_to_numpy(gb)
    assert a_np.keys() == b_np.keys()
    for k, a in a_np.items():
        b = b_np[k]
        assert np.isfinite(b).all(), k
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=2e-2 * scale + 1e-9, err_msg=k)
        assert abs(int((np.abs(a) > 1e-12).sum()) - int((np.abs(b) > 1e-12).sum())) <= 2, k


@pytest.mark.parametrize("kind", ["binary", "wide"])
def test_record_replay_radiance_identical(scenes, kind):
    s = scenes[kind]
    direct = path_trace_samples(CFG, s, *_lanes())
    _, records = path_trace_samples(CFG, s, *_lanes(), record=True)
    replayed = path_trace_samples(CFG, s, *_lanes(), replay=records)
    assert stack(direct).tobytes() == stack(replayed).tobytes()
    # the masked records (the record build's rule) replay to the same bits
    _, masked = path_trace_samples_masked_records(CFG, s, *_lanes())
    assert stack(path_trace_samples(CFG, s, *_lanes(), replay=masked)).tobytes() == (
        stack(direct).tobytes())


@pytest.mark.parametrize("kind", ["binary", "wide"])
def test_fast_grads_match_slow(scenes, kind):
    s = scenes[kind]
    loss_slow, g_slow = render_value_and_grad(CFG, s, *_lanes())
    loss_fast, g_fast = make_fast_grad_fn(CFG)(s, *_lanes())
    _assert_grads_close(loss_slow, g_slow, loss_fast, g_fast)
    # the caller's scene is not touched
    assert all(not getattr(s, f).requires_grad for f in drender.DIFFERENTIABLE_FIELDS)


@pytest.mark.parametrize("chunk", [None, 100])
def test_frame_fast_grads_match_slow(monkeypatch, scenes, chunk):
    """Megakernel record + scan replay on the 16x9 frame at spp 2 (288
    items) against the slow path on the same (pixel, sample) items; with the
    replay chunk set to 100 lanes the replay runs in three chunks."""
    n_pixels, spp, base = SMALL.image_width * SMALL.image_height, 2, 3
    if chunk is not None:
        monkeypatch.setattr(drender, "REPLAY_CHUNK", chunk)
        assert -(-n_pixels * spp // chunk) == 3
    s = scenes["wide"]
    xs, ys, si = frame_items(SMALL, n_pixels, spp, base, "cpu")
    assert si.tolist() == [3] * n_pixels + [4] * n_pixels
    assert xs[17].item() == 1 and ys[17].item() == 1
    loss_slow, g_slow = render_value_and_grad(SMALL, s, xs, ys, si)
    loss_fast, g_fast = make_fast_grad_frame_fn(SMALL, n_pixels, spp, sample_base=base)(s)
    _assert_grads_close(loss_slow, g_slow, loss_fast, g_fast)


def test_frame_fast_grads_take_any_loss(monkeypatch, scenes):
    """A loss that is not a mean over items (a squared error against a
    target, then its square root): chunked equals unchunked."""
    n_pixels, spp = SMALL.image_width * SMALL.image_height, 1
    target = torch.linspace(0.0, 0.5, n_pixels)
    loss_fn = lambda c: torch.sqrt(torch.sum((c.x + c.y - target) ** 2))
    fields = ("sf_light", "vattr")
    whole = make_fast_grad_frame_fn(SMALL, n_pixels, spp, fields, loss_fn)(scenes["wide"])
    monkeypatch.setattr(drender, "REPLAY_CHUNK", 50)
    chunked = make_fast_grad_frame_fn(SMALL, n_pixels, spp, fields, loss_fn)(scenes["wide"])
    assert set(chunked[1]) == set(fields)
    _assert_grads_close(*whole, *chunked)


def test_frame_fast_grads_refuse_abandoned_samples(monkeypatch, scenes):
    """A record pass whose step cap abandoned samples (their records stop
    where the cap cut them) raises instead of replaying wrong paths."""
    n_pixels, spp = SMALL.image_width * SMALL.image_height, 1
    record = tmk.path_trace_megakernel

    def capped(*a, **k):
        assert k.get("return_truncated")
        acc, records, _ = record(*a, **k)
        return acc, records, torch.tensor([3], dtype=torch.int32)

    monkeypatch.setattr(tmk, "path_trace_megakernel", capped)
    with pytest.raises(RuntimeError, match="abandoned 3 samples"):
        make_fast_grad_frame_fn(SMALL, n_pixels, spp, ("sf_light",))(scenes["wide"])


def test_plain_records_equal_masked_scan_records(scenes):
    """The megakernel's plain version in record mode: its sums are the plain
    version's, and its records are the scan's, sample-major, with every row
    a path never reached zero (and every reached row the scan's own)."""
    s = scenes["wide"]
    n_pixels, spp, base = SMALL.image_width * SMALL.image_height, 2, 5
    (r, g, b), (prim, bounce) = tmk.path_trace_megakernel_plain(
        SMALL, s, n_pixels, spp, base, record=True)
    sums = tmk.path_trace_megakernel_plain(SMALL, s, n_pixels, spp, base)
    assert all(torch.equal(x, y) for x, y in zip((r, g, b), sums[:3]))
    acc, (prim2, bounce2) = tmk.path_trace_megakernel(SMALL, s, n_pixels, spp, base,
                                                      record=True, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(acc, (r, g, b)))
    assert all(torch.equal(prim[k], prim2[k]) and torch.equal(bounce[k], bounce2[k])
               for k in prim)
    xs, ys, si = frame_items(SMALL, n_pixels, spp, base, "cpu")
    B = SMALL.max_bounces
    assert bounce["hit"].shape == (B, n_pixels * spp) and prim["inst"].shape == (n_pixels * spp,)
    _, (p_scan, r_scan) = path_trace_samples(SMALL, s, xs, ys, si, record=True)
    for k in prim:
        assert torch.equal(prim[k], p_scan[k]), k
    # a row is reached where the lane was active: every earlier closest hit
    # had thit > 0 (hit), and a shadow ray was traced where occ may be set
    reached = torch.cumprod(torch.cat([p_scan["hit"][None], r_scan["hit"][:-1]]).int(), 0) > 0
    for k in bounce:
        want = torch.where(reached, r_scan[k], torch.zeros((), dtype=r_scan[k].dtype))
        assert torch.equal(bounce[k], want), k
    assert bool((bounce["inst"][~reached] == 0).all())
    assert bool((bounce["inst"][reached & ~bounce["hit"]] == -1).all())  # miss sentinel
    # paths do bounce more than once on this frame, and some miss at once
    assert int(reached[1].sum()) > 0 and int((~reached[0]).sum()) > 0


def test_unpack_records_keeps_the_miss_sentinel():
    """The record build's packed planes, pk = (inst << 2) | (back << 1) |
    hit, unpack to the scan's format; a miss's inst -1 survives the shift."""
    inst = torch.tensor([-1, 0, 3, 6, 0], dtype=torch.int32)
    hit = torch.tensor([False, True, True, True, False])
    back = torch.tensor([False, False, True, False, False])
    pk = (inst << 2) | (back.int() << 1) | hit.int()
    pk[4] = 0  # a row not reached
    prim = torch.tensor([0, 5, 7, 1, 0], dtype=torch.int32)
    planes = CM.RecordPlanes(pk[:1], prim[:1], pk[1:], prim[1:],
                             torch.tensor([1, 0, 1, 0], dtype=torch.uint8))
    p, b = tmk.unpack_records(planes, 2, 2)
    assert p["inst"].tolist() == [-1] and p["hit"].tolist() == [False]
    assert p["occ"].tolist() == [False]
    assert b["inst"].tolist() == [[0, 3], [6, 0]]
    assert b["hit"].tolist() == [[True, True], [True, False]]
    assert b["back"].tolist() == [[False, True], [False, False]]
    assert b["prim"].tolist() == [[5, 7], [1, 0]]
    assert b["occ"].tolist() == [[True, False], [True, False]]


def test_record_error_paths(scenes):
    s = scenes["wide"]
    with pytest.raises(ValueError, match="with_stats"):
        tmk.path_trace_megakernel(SMALL, s, 4, 1, record=True, with_stats=True, device="cpu")
    with pytest.raises(ValueError, match="pixel_order"):
        tmk.path_trace_megakernel(SMALL, s, 4, 1, record=True, pixel_order=[0, 1, 2, 3],
                                  device="cpu")
    with pytest.raises(ValueError, match="spp >= 1"):
        tmk.path_trace_megakernel(SMALL, s, 4, 0, record=True, device="cpu")
    lit = s._replace(lt_tris=torch.zeros((1, 9)))
    with pytest.raises(NotImplementedError, match="area-light"):
        tmk.path_trace_megakernel(SMALL, lit, 4, 1, record=True, device="cpu")
    with pytest.raises(NotImplementedError, match="area-light"):
        path_trace_samples(SMALL, lit, *_lanes(), record=True)
    with pytest.raises(ValueError, match="wide=True"):
        tmk.path_trace_megakernel(SMALL, scenes["binary"], 4, 1, record=True, device="cpu")
    # the record build's wrapper: CUDA tensors only, counted where launched
    before = (CM.launches, CM.record_launches)
    with pytest.raises(ValueError, match="CUDA"):
        CM.megakernel_record_cuda(SMALL, s, 4, 1)
    assert (CM.launches, CM.record_launches) == before


@pytest.mark.parametrize("kind", ["binary", "wide"])
def test_walks_stay_out_of_the_graph(scenes, kind):
    """With tables that require gradients, a walk's outputs do not, and a
    backward through path_trace_samples leaves no gradient on a table that
    only the walk reads (the node tables)."""
    s = scenes[kind]
    node = "wide_rows" if kind == "wide" else "nl8"
    leaves = {f: getattr(s, f).clone().requires_grad_(True)
              for f in ("inst_f", "tri_pos", node)}
    sg = s._replace(**leaves)
    xs, ys, si = _lanes()
    o = Vec3(*(torch.full((8,), v, requires_grad=True) for v in (0.0, 1.0, 5.0)))
    d = Vec3(torch.zeros(8), torch.zeros(8), -torch.ones(8))
    hit, occ = ray_query(sg, sg.sf_tlas_count[:1].expand(8), sg.sf_tlas_offset[:1].expand(8),
                         o, d, 0.0, 1e9, torch.ones(8, dtype=torch.bool))
    assert not any(t.requires_grad for t in (*hit, occ))
    c = path_trace_samples(CFG, sg, xs, ys, si)
    (c.x + c.y + c.z).sum().backward()
    assert leaves[node].grad is None
    assert leaves["tri_pos"].grad is not None and leaves["inst_f"].grad is not None
    assert bool(torch.isfinite(leaves["tri_pos"].grad).all())
