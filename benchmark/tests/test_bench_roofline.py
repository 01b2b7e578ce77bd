"""The roofline's work: the reference's path events on a tiny frame,
checked by hand, and the flops they are charged."""

import torch

from benchmark.harness import inputs, roofline
from benchmark.reference import integrator, scene
from benchmark.reference.config import RenderConfig

CFG = dict(image_width=16, image_height=9, samples_per_pixel=8, framerate=30,
           max_bounces=5, student_id=152121358, samples_per_motion_blur_step=8,
           min_ray_dist=1e-4, max_ray_dist=1e9, path_space_regularization_gamma=0.15)


def _cornell(tmp_path):
    cfg = RenderConfig(**CFG)
    return cfg, scene.cornell_box(inputs.write_cornell(tmp_path), cfg, "cpu")


def test_counts_of_a_tiny_frame(tmp_path):
    cfg, fr = _cornell(tmp_path)
    # the middle pixel looks into the closed back of the box: every one of
    # its paths hits on all 6 closest rays (primary + 5 bounces) unless a
    # bounce leaves through the open front
    xs = torch.tensor([8, 0], dtype=torch.int32)
    ys = torch.tensor([4, 0], dtype=torch.int32)
    base = torch.zeros(2, dtype=torch.int32)
    counts = {}
    integrator.render_pixels(cfg, fr, xs, ys, base, 4, counts=counts)
    n = 8  # 2 pixels x 4 samples
    assert counts["samples"] == n
    closest = counts["shade_hits"] + counts["shade_misses"]
    # one closest ray per sample, and one per bounce a live path makes
    assert closest == n + counts["bsdf_samples"]
    assert counts["nee_evals"] == counts["bsdf_samples"] == counts["light_samples"]
    assert counts["bsdf_samples"] <= 5 * n
    # the sun is black: its NEE colour is black, so no sun shadow ray;
    # rays = closest + area-light shadow rays
    assert counts.get("nee_marches", 0) == 0
    assert closest <= counts["rays"] <= closest + counts["light_samples"]
    # every path that leaves the box misses once and then marches the sky
    assert counts["atmo_marches"] == counts["shade_misses"]


def test_flops_by_hand():
    counts = {"samples": 10, "rays": 30, "shade_hits": 20, "shade_misses": 5,
              "atmo_marches": 5, "nee_evals": 15, "nee_marches": 3,
              "bsdf_samples": 15, "light_samples": 15, "light_pdfs": 2}
    hand = (10 * 85 + 30 * (3 + 52) + 20 * 241 + 5 * 95 + 5 * 1590 + 15 * 236
            + 3 * 268 + 15 * 244 + 15 * 297 + 2 * 30)
    assert roofline.flops(counts, 1.0) == hand
    assert roofline.flops(counts, 2.5) == 2.5 * hand
    s, by = roofline.least_seconds(67e12, 1.0)
    assert (s, by) == (1.0, "operations")
    s, by = roofline.least_seconds(1.0, 3.35e12)
    assert (s, by) == (1.0, "bytes")
