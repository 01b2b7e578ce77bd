"""Pixel / sample sharding (parallel/sharding.py) and the frame partition of
parallel/multihost.py, on the CPU: a mesh names the one ``"cpu"`` device
four times, as a machine with one card names its card.

The port's sharded sums are held to one JAX ``make_sharded_render`` on a
(2, 2) mesh of the suite's virtual CPU devices (rtol 1e-5, atol 1e-6,
tests/test_parallel.py's bar; the JAX package's walk runs on XLA:CPU,
which contracts FMAs). Against the port itself they are exact: with one
sample shard a sharded sum is the single-device sum, bit for bit, and with
several it is the shard-order sum of the single-device sums of each
shard's sample range. The scan, the wavefront's and the megakernel's plain
versions all fold a pixel's samples in sample order, so each range's sum
is rebuilt here from one set of per-sample radiances. The gradients are
held to the port's single-device gradients at rtol 2e-4 (the JAX test's
bar). One JAX call (~14 s)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu.parallel import sharding as jsharding
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.convert import grads_to_numpy
from pathtracing_tpu_torch.diff.render import (
    make_fast_grad_frame_fn,
    render_value_and_grad,
)
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.parallel.multihost import frames_for_host, local_device_mesh
from pathtracing_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    make_sharded_fast_grad_frame,
    make_sharded_render,
    make_sharded_render_grad,
    make_sharded_render_megakernel,
    render_frame_sharded,
)
from pathtracing_tpu_torch.render import render_frame
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, stack

import golden_scene as jgolden

CFG = dataclasses.replace(TESTING, max_bounces=2)
SPP = 4
IDX = np.arange(32, dtype=np.int32)
XS, YS = (IDX * 13) % CFG.image_width, (IDX * 7) % CFG.image_height
MESHES = [(4, 1), (2, 2), (1, 4)]
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return (scene_device_from_golden(g, CFG, device="cpu"),
            scene_device_from_golden(g, CFG, wide=True, device="cpu"))


@pytest.fixture(scope="module")
def jax_sums():
    """The one JAX call: make_sharded_render on a (2, 2) mesh."""
    jcfg = dataclasses.replace(JTESTING, max_bounces=2)
    jscene = jgolden.scene_device_from_golden(golden("scene.gold"))
    fn = jsharding.make_sharded_render(jcfg, jsharding.make_mesh(2, 2), SPP)
    return stack(fn(jscene, jnp.asarray(XS), jnp.asarray(YS)))


def _per_sample(scene, xs, ys):
    """(SPP, 3, n) per-sample radiance by the scan."""
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    out = []
    for k in range(SPP):
        c = path_trace_samples(CFG, scene, xs, ys, torch.full(xs.shape, k, dtype=torch.int32))
        out.append(torch.stack(list(c)))
    return torch.stack(out)


@pytest.fixture(scope="module")
def samples(scenes):
    """Per-sample radiance of the list (binary scene) and of the row-major
    pixels [0, 32) (wide scene, the megakernel's)."""
    return {"list": _per_sample(scenes[0], XS, YS),
            "rows": _per_sample(scenes[1], IDX % CFG.image_width, IDX // CFG.image_width)}


def _rebuild(per_sample, n_samples):
    """The shard-order sum of each sample shard's range sum, each range
    folded from 0 in sample order, as every renderer folds it."""
    local = SPP // n_samples
    total = None
    for s in range(n_samples):
        part = torch.zeros_like(per_sample[0])
        for k in range(s * local, (s + 1) * local):
            part += per_sample[k]
        total = part if total is None else total + part
    return total


def _sums(out):
    return torch.stack(list(out))


@pytest.mark.parametrize("tiles,n_samples", MESHES)
@pytest.mark.parametrize("kind", ["scan", "wavefront", "megakernel"])
def test_sharded_sums_rebuild_exactly(scenes, samples, kind, tiles, n_samples):
    mesh = make_mesh(tiles, n_samples, CPU4)
    if kind == "megakernel":
        got = make_sharded_render_megakernel(CFG, mesh, len(IDX), SPP)(scenes[1])
        per_sample = samples["rows"]
    else:
        fn = make_sharded_render(CFG, mesh, SPP, wavefront=kind == "wavefront")
        got = fn(scenes[0], XS, YS)
        per_sample = samples["list"]
    # with tiles only, the rebuild is the single-device sum itself
    np.testing.assert_array_equal(n(_sums(got)), n(_rebuild(per_sample, n_samples)))


@pytest.mark.parametrize("tiles,n_samples", MESHES)
def test_sharded_matches_jax(scenes, jax_sums, tiles, n_samples):
    got = stack(make_sharded_render(CFG, make_mesh(tiles, n_samples, CPU4), SPP)(
        scenes[0], XS, YS))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_sums, rtol=1e-5, atol=1e-6)


def test_render_frame_sharded_is_the_frame(scenes):
    """render_frame_sharded pads the row-major list to the tile count (3
    tiles of 16 x 9 = 144 pixels: no pad; 5 tiles: one pad pixel) and
    averages as render_frame does."""
    cfg = dataclasses.replace(CFG, image_width=16, image_height=9, samples_per_pixel=2)
    scene = scene_device_from_golden(golden("scene.gold"), cfg, device="cpu")
    ref, _ = render_frame(cfg, scene, device="cpu")
    for tiles in (3, 5):
        got = render_frame_sharded(cfg, scene, make_mesh(tiles, 1, ["cpu"] * 5))
        assert got.shape == (9, 16, 3) and got.tobytes() == ref.tobytes()


def test_sharded_fast_grad_matches_single_device(scenes):
    cfg = dataclasses.replace(CFG, image_width=16, image_height=9)
    n_pixels, spp = 32, 2
    ref_loss, ref_grads = make_fast_grad_frame_fn(cfg, n_pixels, spp)(scenes[1])
    loss, grads = make_sharded_fast_grad_frame(cfg, make_mesh(2, 2, CPU4), n_pixels, spp)(
        scenes[1])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    got, ref = grads_to_numpy(grads), grads_to_numpy(ref_grads)
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("remat", [True, False])
def test_sharded_grad_matches_single_device(scenes, remat):
    """The sharded training step against the single-device gradient of the
    mean over the same (lane, sample) set: each sample rendered by
    render_value_and_grad, its loss and gradients averaged."""
    xs, ys = XS[:16], YS[:16]
    loss, grads = make_sharded_render_grad(CFG, make_mesh(2, 2, CPU4), 2, remat=remat)(
        scenes[0], xs, ys)
    ref_loss, ref_grads = 0.0, None
    for k in range(2):
        si = torch.full((16,), k, dtype=torch.int32)
        l, g = render_value_and_grad(CFG, scenes[0], torch.from_numpy(xs),
                                     torch.from_numpy(ys), si)
        ref_loss += float(l) / 2
        g = {f: v / 2 for f, v in grads_to_numpy(g).items()}
        ref_grads = g if ref_grads is None else {f: ref_grads[f] + g[f] for f in g}
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5, atol=1e-7)
    got = grads_to_numpy(grads)
    assert set(got) == set(ref_grads)
    for f in got:
        assert np.isfinite(got[f]).all(), f
        np.testing.assert_allclose(got[f], ref_grads[f], rtol=2e-4, atol=1e-6, err_msg=f)


def test_make_mesh_and_its_refusals(scenes):
    mesh = make_mesh(2, 2, CPU4)
    assert mesh.shape == {"tiles": 2, "samples": 2}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(4, 2, CPU4)
    if not torch.cuda.is_available():
        # None means the CUDA cards, never the CPU
        with pytest.raises(ValueError, match="have 0"):
            make_mesh(1, 1)
        with pytest.raises(ValueError, match="have 0"):
            local_device_mesh()
    assert local_device_mesh(device_type="cpu").shape == {"tiles": 1, "samples": 1}
    with pytest.raises(ValueError, match="multiple of 2 sample shards"):
        make_sharded_render(CFG, mesh, 3)
    with pytest.raises(ValueError, match="multiple of 2 tiles"):
        make_sharded_render(CFG, mesh, 2)(scenes[0], XS[:7], YS[:7])
    with pytest.raises(ValueError):
        Mesh([["cpu"]], ("tiles",))


def test_frames_for_host_partition():
    frames = []
    for pid in range(4):
        frames += frames_for_host(0, 30, process_id=pid, n_hosts=4)
    assert sorted(frames) == list(range(30))
    a = frames_for_host(0, 30, process_id=1, n_hosts=4)
    b = frames_for_host(0, 30, process_id=2, n_hosts=4)
    assert a == list(range(1, 30, 4)) and not set(a) & set(b)
    # outside a process group: one host, every frame
    assert frames_for_host(3, 9) == list(range(3, 9))
