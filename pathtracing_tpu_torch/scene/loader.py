"""Scene assembly helpers (reference: scene.cc:51-73).

Only ``make_transform`` is here, which ``scene/builder.SceneBuilder`` needs.
The JAX package's ``load_scene`` (the reference's animated scene: 18 meshes,
terrain recolouring and the 1,024 seeded placements) and
``setup_animation_frame`` (the per-frame TLAS rebuilds) come in the next
slice of the port, with ``scene/animation.py``.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch.utils.hostmath import (
    mul_m4m4,
    rotation_euler,
    scaling,
    translation,
)

f32 = np.float32
OBJECT_COUNT = 1024  # reference: scene.cc:4


def make_transform(pos, pitch_yaw_roll=(0, 0, 0), scale=(1, 1, 1)) -> np.ndarray:
    """reference: scene.cc:62-73."""
    t = scaling(np.asarray(scale, f32))
    t = mul_m4m4(
        rotation_euler(
            (np.asarray(pitch_yaw_roll, f32) * f32(np.pi) / f32(180.0)).astype(f32)
        ),
        t,
    )
    return mul_m4m4(translation(np.asarray(pos, f32)), t)
