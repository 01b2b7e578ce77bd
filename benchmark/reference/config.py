"""Render settings of a configuration file (reference: config.hh:9-42)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    image_width: int
    image_height: int
    samples_per_pixel: int
    framerate: int
    max_bounces: int
    student_id: int
    samples_per_motion_blur_step: int
    min_ray_dist: float
    max_ray_dist: float
    path_space_regularization_gamma: float

    @property
    def subframe_count(self) -> int:
        """Motion-blur subframes per frame (reference: scene.cc:648-650)."""
        return (self.samples_per_pixel + self.samples_per_motion_blur_step - 1
                ) // self.samples_per_motion_blur_step
