"""The output check: a sound run passes; the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath
fail."""

import time

import numpy as np
import pytest

from benchmark.harness import check as chk
from benchmark.harness import main as M
from benchmark.harness.system import System
from benchmark.tests.conftest import tiny_cell


class AlteredAnswers(System):
    """Every colour 0.1 % off where it is produced, and the BGRA bytes 2 off."""

    def render(self, req, tables):
        colors, image = super().render(req, tables)
        return colors * np.float32(1.001), np.minimum(image.astype(np.int16) + 2, 255).astype(np.uint8)


class HalfTheSamples(System):
    """Half of each request's samples left out, the mean taken over the rest."""

    def render(self, req, tables):
        import dataclasses

        half = dataclasses.replace(req, spp=max(1, req.spp // 2))
        cfg = self.cfg
        if self.route["entry"] == "render_frame":
            cfg = dataclasses.replace(cfg, samples_per_pixel=half.spp)
        return self.entry.render(cfg, tables, half, self.route, self.device)


class StaleFrame(System):
    """The frame loop's state left unchanged: every frame renders from the
    first frame's tables (the warm frame's)."""

    first = None

    def prepare(self, req):
        if self.first is None:
            self.first = super().prepare(req)
        return self.first


def _run(name, factory=None, seconds=0.1, spp=2):
    cell = tiny_cell(name, spp=spp)
    return M.run_cell(cell, 2**31 + 17, seconds, False, "cpu", time.perf_counter(),
                      system_factory=factory)


@pytest.mark.parametrize("name", ["lumi_animation.film64", "cornell_box.preview4"])
def test_sound_run_is_correct_and_keys(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["far_pct"]["value"] == 0.0
    assert set(out["metrics"]) >= {"setup_s", "msamples_per_s", "peak_alloc_gib"}


@pytest.mark.parametrize("fault,name", [
    (AlteredAnswers, "lumi_animation.film64"),
    (AlteredAnswers, "cornell_box.preview4"),
    (HalfTheSamples, "lumi_animation.film64"),
    (HalfTheSamples, "cornell_box.preview4"),
])
def test_a_broken_timed_path_is_not_correct(fault, name):
    out = _run(name, fault, spp=4)
    assert not out["correct"], out["checks"]


def test_a_frame_loop_that_does_not_advance_is_not_correct():
    # the window's frame renders the warm frame's tables
    out = _run("lumi_animation.film64", StaleFrame)
    assert out["attempted"] >= 1
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["lumi_animation.film64", "cornell_box.preview4"])
def test_the_control_is_not_correct(name, tmp_path):
    """The reference computed in bfloat16, in the program's place, at a
    test's size: it fails the limit of its cell."""
    import torch

    from benchmark.harness import loops

    cell = tiny_cell(name, spp=4)
    ddir = M.data_dir(cell.config)
    ref = chk.Reference(cell.config, ddir, torch.device("cpu"))
    low = chk.Reference(cell.config, ddir, torch.device("cpu"), lowp=chk.bf16)
    W, H = cell.config["render"]["image_width"], cell.config["render"]["image_height"]
    items = []
    for i in range(2):
        req = loops.request(cell.traffic, 5, i)
        px = loops.check_pixels(5, req, W * H, 12)
        items.append(loops.Done(req, 0.0, 1.0, 0, px, None, None))
    numbers = chk.control(ref, low, items)
    assert numbers["far_pct"] > cell.limits["far_pct"]["limit"], numbers
