"""The port's AOV pass (aov.py) vs the JAX package's, on the CPU.

``aov_samples`` on scene.gold lanes against one JAX call: hit masks equal,
depth within the ray queries' bars (rtol 2e-5, atol 1e-5; XLA:CPU fuses
multiply-adds, the port does not), albedo and normal within 1e-5; then the
port's ``render_aovs``: the channels' semantics (tests/test_aov.py's),
tiling invariance and the binary tables equal to the wide ones, bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracing_tpu.aov import aov_samples as jax_aov_samples
from pathtracing_tpu.config import TESTING as JTESTING
from pathtracing_tpu_torch.aov import aov_samples, render_aovs
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, n, stack, t

import golden_scene as jgolden


@pytest.fixture(scope="module")
def scenes():
    g = golden("scene.gold")
    return {"binary": scene_device_from_golden(g, TESTING, device="cpu"),
            "w8": scene_device_from_golden(g, TESTING, wide=True, device="cpu")}


def _grid(w=40, h=24, stride=16):
    idx = np.arange(w * h, dtype=np.int32)
    return (idx % w) * stride, (idx // w) * (360 // h)


def test_aov_samples_match_jax(scenes):
    xs, ys = _grid()
    si = (np.arange(len(xs)) % 5).astype(np.int32)
    alb, nrm, dep, hit = aov_samples(TESTING, scenes["binary"], t(xs), t(ys), t(si))
    js = jgolden.scene_device_from_golden(golden("scene.gold"))
    jalb, jnrm, jdep, jhit = jax_aov_samples(
        JTESTING, js, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(si))
    assert (n(hit) == np.asarray(jhit)).all()
    assert 0.2 < n(hit).mean() < 0.95  # sky and geometry both in view
    np.testing.assert_allclose(n(dep), np.asarray(jdep), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(stack(alb), stack(jalb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(stack(nrm), stack(jnrm), rtol=0, atol=1e-5)


def test_aov_channels(scenes):
    xs, ys = _grid()
    a = render_aovs(TESTING, scenes["binary"], xs, ys, spp=4, tile_pixels=len(xs),
                    device="cpu")
    assert set(a) == {"albedo", "normal", "depth", "coverage"}
    for v in a.values():
        assert np.isfinite(v).all() and v.dtype == np.float32
    assert (a["coverage"] >= 0).all() and (a["coverage"] <= 1).all()
    assert 0.2 < a["coverage"].mean() < 0.95
    norm = np.linalg.norm(a["normal"], axis=-1)
    hit = a["coverage"] > 0
    assert np.allclose(norm[hit], 1.0, atol=1e-3)
    assert (norm[~hit] == 0).all() and (a["albedo"][~hit] == 0).all()
    assert (a["depth"][~hit] == 0).all() and (a["depth"][hit] > 0).all()


@pytest.mark.parametrize("case", ["tiles", "wide_tables"])
def test_aov_invariance(scenes, case):
    """Tile size and table kind change nothing: every lane's sums are the
    same operations on the same values (the walks' ids are equal)."""
    xs, ys = _grid()
    a = render_aovs(TESTING, scenes["binary"], xs, ys, spp=2, tile_pixels=len(xs),
                    device="cpu")
    other = (dict(scene=scenes["binary"], tile_pixels=256) if case == "tiles"
             else dict(scene=scenes["w8"], tile_pixels=len(xs)))
    b = render_aovs(TESTING, other.pop("scene"), xs, ys, spp=2, device="cpu", **other)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
