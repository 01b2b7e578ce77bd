"""Render configuration.

The reference keeps all of this as compile-time macros in
``config.hh`` (reference: config.hh:1-44). Here it is a frozen dataclass:
hashable, one value names one render set-up, and the fields equal those of
the JAX package's ``RenderConfig`` so both render from the same presets.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (reference: config.hh:9-42)."""

    image_width: int = 640
    image_height: int = 360
    samples_per_pixel: int = 256
    framerate: int = 30
    max_bounces: int = 4

    # RNG salt (reference: config.hh:5, consumed at path_tracer.hh:659).
    student_id: int = 152121358

    # "DO NOT TOUCH" common settings (reference: config.hh:28-32).
    samples_per_motion_blur_step: int = 8
    min_ray_dist: float = 1e-4
    max_ray_dist: float = 1e9
    path_space_regularization_gamma: float = 0.15

    @property
    def subframe_count(self) -> int:
        """Motion-blur subframes per frame (reference: scene.cc:648-650)."""
        return (
            self.samples_per_pixel + self.samples_per_motion_blur_step - 1
        ) // self.samples_per_motion_blur_step


# Atmosphere constants (reference: config.hh:34-42). These are never varied.
EARTH_RADIUS = 6.3781e6
ATMOSPHERE_PRIMARY_ITERATIONS = 8
ATMOSPHERE_SECONDARY_ITERATIONS = 4
ATMOSPHERE_HEIGHT = 1.0e5
ATMOSPHERE_RAYLEIGH_COEFFICIENT = (5.8e-6, 13.6e-6, 33.1e-6)
ATMOSPHERE_RAYLEIGH_SCALE_HEIGHT = 7994.0
ATMOSPHERE_MIE_COEFFICIENT = (4.0e-6, 4.0e-6, 4.0e-6)
ATMOSPHERE_MIE_ANISOTROPY = 0.80
ATMOSPHERE_MIE_SCALE_HEIGHT = 1200.0

# Testing profile (reference: config.hh:14-18).
TESTING = RenderConfig()

# Production profile (reference: config.hh:21-25).
PRODUCTION = RenderConfig(
    image_width=1920,
    image_height=1080,
    samples_per_pixel=1024,
    framerate=30,
    max_bounces=5,
)
