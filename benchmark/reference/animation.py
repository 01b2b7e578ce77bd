"""The hard-coded 60-second animation (reference: scene.cc:24-42, 271-718);
the JAX package's ``scene/animation.py``, the same table and arithmetic.

``ANIMATION_TRACK`` transcribes the reference's keyframe table
(reference: scene.cc:319-627) as data: (start, duration, from, to, target).
``play_animation_track`` replicates the evaluation quirks exactly:

  * stops are applied in array order while ``start <= t``; iteration STOPS
    at the first entry with start > t even if later entries would match
    (the table is not fully sorted — the {1104,...} entries after {1105,...}
    are therefore unreachable for t in [1104,1105), reference: scene.cc:33-42)
  * duration 0 snaps; otherwise lerp by clamped local time
  * later stops override earlier ones
"""

from __future__ import annotations

import numpy as np

f32 = np.float32

CAMERA_START_POS = (-81.4, 65.0, -113.6)
CAMERA_START_ORI = (30.6, 146.6, 0.0)

# fmt: off
ANIMATION_TRACK = [
    (0, 120, 1, 0, "logo_visible"),
    (60, 60, CAMERA_START_POS[0], -90.6, "cam_pos_x"),
    (60, 60, CAMERA_START_POS[1], 55, "cam_pos_y"),
    (60, 60, CAMERA_START_POS[2], -67.8, "cam_pos_z"),
    (60, 60, CAMERA_START_ORI[0], 42.6, "cam_ori_x"),
    (60, 60, CAMERA_START_ORI[1], 123.8, "cam_ori_y"),

    # Wild teapot zoom!
    (140, 0, 0, -11.6, "cam_pos_x"),
    (140, 0, 0, 14.3, "cam_pos_y"),
    (140, 0, 0, 60.6, "cam_pos_z"),
    (140, 0, 0, 11.4, "cam_ori_x"),
    (140, 0, 0, 133, "cam_ori_y"),
    (150, 10, 11.4, 0.6, "cam_ori_x"),
    (150, 10, 133, 50, "cam_ori_y"),
    (150, 160, 40.1, 47, "teapot_pos_x"),
    (150, 160, 13.95, 13, "teapot_pos_y"),
    (150, 160, 13.6, 29, "teapot_pos_z"),
    (150, 10, 150, 210, "teapot_ori_y"),
    (160, 10, 210, 150, "teapot_ori_y"),
    (170, 10, 150, 210, "teapot_ori_y"),
    (170, 60, 80, 10, "fov"),
    (180, 10, 210, 150, "teapot_ori_y"),
    (190, 10, 150, 210, "teapot_ori_y"),
    (200, 10, 210, 150, "teapot_ori_y"),
    (210, 10, 150, 210, "teapot_ori_y"),
    (220, 10, 210, 150, "teapot_ori_y"),
    (230, 10, 150, 210, "teapot_ori_y"),
    (240, 10, 210, 150, "teapot_ori_y"),
    (250, 10, 150, 210, "teapot_ori_y"),
    (260, 10, 210, 150, "teapot_ori_y"),
    (270, 10, 150, 210, "teapot_ori_y"),
    (280, 10, 210, 150, "teapot_ori_y"),
    (290, 10, 150, 210, "teapot_ori_y"),

    # Teapot eating!
    (300, 0, 0, 60, "fov"),
    (300, 0, 0, 8.0, "focal_distance"),
    (300, 0, 0, 0.2, "aperture_radius"),
    (300, 0, 0, 38.5, "cam_pos_x"),
    (300, 0, 0, 19.2, "cam_pos_y"),
    (300, 0, 0, 37.7, "cam_pos_z"),
    (300, 0, 0, 35.2, "cam_ori_x"),
    (300, 0, 0, 108.8, "cam_ori_y"),
    (300, 0, 0, 45.3, "teapot_pos_x"),
    (300, 0, 0, 12.4, "teapot_pos_y"),
    (300, 0, 0, 40.9, "teapot_pos_z"),
    (300, 0, 0, 120, "teapot_ori_y"),
    (300, 10, 10, 30, "teapot_ori_x"),
    (310, 10, 30, 10, "teapot_ori_x"),
    (320, 10, 10, 30, "teapot_ori_x"),
    (330, 10, 30, 10, "teapot_ori_x"),
    (340, 10, 10, 30, "teapot_ori_x"),
    (350, 10, 30, 0, "teapot_ori_x"),
    (370, 3, 120, 210, "teapot_ori_y"),

    # Predator armadillo appears!
    (370, 0, 0, 1, "armadillo_visible"),
    (370, 0, 0, 29.6, "armadillo_pos_x"),
    (370, 0, 0, 9, "armadillo_pos_y"),
    (370, 0, 0, 52.2, "armadillo_pos_z"),
    (370, 0, 0, 65, "armadillo_ori_y"),
    (375, 5, 35.2, 23.6, "cam_ori_x"),
    (375, 5, 108.8, 205.8, "cam_ori_y"),
    (375, 5, 60, 50, "fov"),
    (380, 5, 8.0, 16.0, "focal_distance"),

    (380, 30, 29.6, 34.6, "armadillo_pos_x"),
    (380, 30, 9, 11, "armadillo_pos_y"),
    (380, 30, 52.2, 55.5, "armadillo_pos_z"),
    (380, 30, 65, 30, "armadillo_ori_y"),

    (420, 10, 34.6, 40, "armadillo_pos_x"),
    (420, 10, 11, 11.9, "armadillo_pos_y"),
    (420, 10, 55.5, 48.7, "armadillo_pos_z"),
    (420, 10, 30, 10, "armadillo_ori_y"),

    # Cut to zoom from behind Buddha statue
    (430, 0, 0, -43.14, "cam_pos_x"),
    (430, 0, 0, 34.1, "cam_pos_y"),
    (430, 0, 0, 45.6, "cam_pos_z"),
    (430, 0, 0, 13, "cam_ori_x"),
    (430, 0, 0, 90, "cam_ori_y"),
    (430, 0, 0, 0, "aperture_radius"),
    (430, 0, 0, 10, "fov"),
    (450, 30, 10, 60, "fov"),

    # Rotate around statue
    (490, 20, -43.14, -39, "cam_pos_x"),
    (490, 20, 34.1, 34, "cam_pos_y"),
    (490, 20, 45.6, 46.3, "cam_pos_z"),
    (490, 20, 13, 16.6, "cam_ori_x"),
    (490, 20, 90, -4, "cam_ori_y"),

    (510, 30, -39, -35.5, "cam_pos_x"),
    (510, 30, 34, 33.7, "cam_pos_y"),
    (510, 30, 46.3, 42.8, "cam_pos_z"),
    (510, 30, 16.6, 16, "cam_ori_x"),
    (510, 30, -4, -48.4, "cam_ori_y"),

    (540, 30, -35.5, -34.8, "cam_pos_x"),
    (540, 30, 33.7, 33.7, "cam_pos_y"),
    (540, 30, 42.8, 38.8, "cam_pos_z"),
    (540, 30, 16, 13.4, "cam_ori_x"),
    (540, 30, -48.4, -109.4, "cam_ori_y"),

    (570, 30, -34.8, -36.4, "cam_pos_x"),
    (570, 30, 33.7, 33.7, "cam_pos_y"),
    (570, 30, 38.8, 36.7, "cam_pos_z"),
    (570, 30, 13.4, 14, "cam_ori_x"),
    (570, 30, -109.4, -138, "cam_ori_y"),

    (600, 30, -36.4, -40.2, "cam_pos_x"),
    (600, 30, 33.7, 29.6, "cam_pos_y"),
    (600, 30, 36.7, 35.5, "cam_pos_z"),
    (600, 30, 14, -29.8, "cam_ori_x"),
    (600, 30, -138, -185.8, "cam_ori_y"),

    (630, 30, -40.2, -43.1, "cam_pos_x"),
    (630, 30, 29.6, 32, "cam_pos_y"),
    (630, 30, 35.5, 37.4, "cam_pos_z"),
    (630, 30, -29.8, -5, "cam_ori_x"),
    (630, 30, -185.8, -230.4, "cam_ori_y"),

    # Fly to dragon
    (660, 0, 0, 1, "dragon_visible"),
    (660, 0, 0, -92.9, "dragon_pos_x"),
    (660, 0, 0, 0, "dragon_pos_y"),
    (660, 0, 0, 76.9, "dragon_pos_z"),
    (660, 0, 0, 60, "dragon_ori_y"),

    (660, 30, -43.1, -43, "cam_pos_x"),
    (660, 30, 32, 30.6, "cam_pos_y"),
    (660, 30, 37.4, 44.8, "cam_pos_z"),
    (660, 30, -5, 25.4, "cam_ori_x"),
    (660, 30, -230.4, -150.2, "cam_ori_y"),

    (690, 30, -43, -67, "cam_pos_x"),
    (690, 30, 30.6, 18, "cam_pos_y"),
    (690, 30, 44.8, 62.6, "cam_pos_z"),
    (690, 30, 25.4, 34.2, "cam_ori_x"),
    (690, 30, -150.2, -105, "cam_ori_y"),

    (720, 30, -67, -79.2, "cam_pos_x"),
    (720, 30, 18, 7.7, "cam_pos_y"),
    (720, 30, 62.6, 69.5, "cam_pos_z"),
    (720, 30, 34.2, 21.6, "cam_ori_x"),
    (720, 30, -105, -118.8, "cam_ori_y"),

    # Observe dragon climbing to solid ground
    (770, 0, 0, -78.6, "cam_pos_x"),
    (770, 0, 0, 6.8, "cam_pos_y"),
    (770, 0, 0, 83, "cam_pos_z"),
    (770, 0, 0, 17.6, "cam_ori_x"),
    (770, 0, 0, -38.2, "cam_ori_y"),
    (770, 0, 0, 0.4, "aperture_radius"),
    (770, 0, 0, 12.0, "focal_distance"),

    (780, 60, -78.6, -76.4, "cam_pos_x"),
    (780, 60, 6.8, 8.5, "cam_pos_y"),
    (780, 60, 83, 80.3, "cam_pos_z"),
    (780, 60, 17.6, 22.6, "cam_ori_x"),
    (780, 60, -38.2, -48.2, "cam_ori_y"),

    (780, 60, -92.9, -84, "dragon_pos_x"),
    (780, 60, 0, 3, "dragon_pos_y"),
    (780, 60, 76.9, 70.3, "dragon_pos_z"),
    (780, 60, 0, -38.8, "dragon_ori_x"),

    # Observe dragon walking coastline
    (860, 60, -89.6, -97.7, "cam_pos_x"),
    (860, 60, 13.3, 14.3, "cam_pos_y"),
    (860, 60, 65.4, 52.2, "cam_pos_z"),
    (860, 60, 19.6, 22, "cam_ori_x"),
    (860, 60, 69.6, 84.6, "cam_ori_y"),
    (860, 0, 0, 16.0, "focal_distance"),

    (860, 0, 0, 0, "dragon_ori_x"),
    (860, 0, 0, 0, "dragon_ori_y"),

    (860, 60, -77.3, -81.8, "dragon_pos_x"),
    (860, 60, 7.89, 7.74, "dragon_pos_y"),
    (860, 60, 60.86, 49.6, "dragon_pos_z"),

    (920, 60, -97.7, -89, "cam_pos_x"),
    (920, 60, 14.3, 14.4, "cam_pos_y"),
    (920, 60, 52.2, 49.2, "cam_pos_z"),
    (920, 60, 22, 23, "cam_ori_x"),
    (920, 60, 84.6, 52.6, "cam_ori_y"),

    (920, 60, -81.8, -81.1, "dragon_pos_x"),
    (920, 60, 7.74, 8.4, "dragon_pos_y"),
    (920, 60, 49.6, 41.6, "dragon_pos_z"),

    # Dragon sees bunny
    (980, 0, 0, 0.4, "aperture_radius"),
    (980, 0, 0, 1.0, "bunny_visible"),
    (980, 0, 0, -27.9, "dragon_pos_x"),
    (980, 0, 0, 22, "dragon_pos_y"),
    (980, 0, 0, -43.8, "dragon_pos_z"),
    (980, 0, 0, -34.5, "bunny_pos_x"),
    (980, 0, 0, -30, "dragon_ori_y"),
    (980, 0, 0, 19.1, "bunny_pos_y"),
    (980, 0, 0, -52, "bunny_pos_z"),
    (980, 0, 0, -21.3, "cam_pos_x"),
    (980, 0, 0, 29.1, "cam_pos_y"),
    (980, 0, 0, -45.2, "cam_pos_z"),
    (980, 0, 0, 31.8, "cam_ori_x"),
    (980, 0, 0, -63.6, "cam_ori_y"),
    (980, 0, 0, 40, "fov"),
    (980, 30, 5.0, 16.0, "focal_distance"),

    # Bunny sees dragon
    (1050, 0, 0, 0.0, "aperture_radius"),
    (1050, 0, 0, -36.1, "cam_pos_x"),
    (1050, 0, 0, 19.8, "cam_pos_y"),
    (1050, 0, 0, -59.1, "cam_pos_z"),
    (1050, 0, 0, -14.4, "cam_ori_x"),
    (1050, 0, 0, -198.4, "cam_ori_y"),

    (1070, 20, 0, 90, "bunny_ori_y"),
    (1090, 5, 90, 180, "bunny_ori_y"),
    (1095, 5, 19.1, 22, "bunny_pos_y"),
    (1100, 5, 22, 19.1, "bunny_pos_y"),
    (1105, 5, 180, 90, "bunny_ori_y"),

    # NOTE: out-of-order starts kept verbatim (see module docstring)
    (1104, 5, -34.5, -25.5, "bunny_pos_x"),
    (1104, 5, 0, 30, "dragon_ori_y"),
    (1110, 5, -27.9, -27.6, "dragon_pos_x"),
    (1110, 5, 22, 19.1, "dragon_pos_y"),
    (1110, 5, -43.8, -54.4, "dragon_pos_z"),

    # Bunny on the run
    (1115, 0, 0, -4.2, "cam_pos_x"),
    (1115, 0, 0, 10.6, "cam_pos_y"),
    (1115, 0, 0, -89.6, "cam_pos_z"),
    (1115, 0, 0, 1.4, "cam_ori_x"),
    (1115, 0, 0, 191.6, "cam_ori_y"),
    (1115, 0, 0, 90, "dragon_ori_y"),
    (1115, 0, 0, 0, "dragon_visible"),

    (1115, 20, -6.6, 1.8, "bunny_pos_x"),
    (1115, 20, 8.2, 7.6, "bunny_pos_y"),
    (1115, 20, -79.3, -78.6, "bunny_pos_z"),

    (1145, 0, 0, 1, "dragon_visible"),
    (1145, 20, -15.6, 4.5, "dragon_pos_x"),
    (1145, 20, 8.2, 7.6, "dragon_pos_y"),
    (1145, 20, -79.3, -78.6, "dragon_pos_z"),

    # Bunny is on coastline, surroundings seems safe
    (1165, 0, 0, 43.1, "cam_pos_x"),
    (1165, 0, 0, 10.2, "cam_pos_y"),
    (1165, 0, 0, -90.1, "cam_pos_z"),
    (1165, 0, 0, 32.0, "cam_ori_x"),
    (1165, 0, 0, 180.2, "cam_ori_y"),
    (1165, 0, 0, 0, "dragon_visible"),

    (1165, 0, 0, 42.7, "bunny_pos_x"),
    (1165, 0, 0, 4.7, "bunny_pos_y"),
    (1165, 0, 0, -83.6, "bunny_pos_z"),

    (1200, 20, 32.0, -7.8, "cam_ori_x"),
    (1200, 20, 180.2, 161.2, "cam_ori_y"),

    (1260, 20, -7.8, -5, "cam_ori_x"),
    (1260, 20, 161.2, 238.4, "cam_ori_y"),

    (1300, 20, -5, 32.0, "cam_ori_x"),
    (1300, 20, 238.5, 180.2, "cam_ori_y"),

    # Sunset overview
    (1360, 0, 0, 15.7, "cam_pos_x"),
    (1360, 0, 0, 19.1, "cam_pos_y"),
    (1360, 0, 0, 75.5, "cam_pos_z"),
    (1360, 0, 0, 8.2, "cam_ori_x"),
    (1360, 0, 0, -1.8, "cam_ori_y"),

    # Bunny views sunset, with dragon's silhouette slowly sliding in
    (1580, 0, 0, 44.9, "bunny_pos_x"),
    (1580, 0, 0, 2.6, "bunny_pos_y"),
    (1580, 0, 0, -88.9, "bunny_pos_z"),
    (1580, 0, 0, 60, "fov"),

    (1580, 0, 0, 30.0, "cam_pos_x"),
    (1580, 0, 0, 9.4, "cam_pos_y"),
    (1580, 0, 0, -78.8, "cam_pos_z"),
    (1580, 0, 0, 9.2, "cam_ori_x"),
    (1580, 0, 0, 37.0, "cam_ori_y"),
    (1580, 0, 0, 1, "dragon_visible"),

    (1690, 60, 24.5, 32.9, "dragon_pos_x"),
    (1690, 60, 4.5, 3.9, "dragon_pos_y"),
    (1690, 60, -85.9, -88.2, "dragon_pos_z"),

    # Sun sets, screen gets darker, armadillo's eyes show up as well
    (1700, 60, 55.7, 55.1, "armadillo_pos_x"),
    (1700, 60, 4.9, 4.7, "armadillo_pos_y"),
    (1700, 60, -75.9, -82.6, "armadillo_pos_z"),
    (1700, 0, 0, -90, "armadillo_ori_y"),

    # Fin.
    (1740, 0, 0, 1, "end_visible"),
    (1740, 0, 0, 33, "end_pos_x"),
    (1740, 30, 12, 7.6, "end_pos_y"),
    (1740, 0, 0, -83, "end_pos_z"),
    (1740, 0, 0, 37.0, "end_ori_y"),
]
# fmt: on


def initial_frame_state() -> dict:
    """Per-frame animated state defaults (reference: scene.cc:279-316)."""
    return {
        "cam_pos_x": f32(CAMERA_START_POS[0]),
        "cam_pos_y": f32(CAMERA_START_POS[1]),
        "cam_pos_z": f32(CAMERA_START_POS[2]),
        "cam_ori_x": f32(CAMERA_START_ORI[0]),
        "cam_ori_y": f32(CAMERA_START_ORI[1]),
        "cam_ori_z": f32(CAMERA_START_ORI[2]),
        "fov": f32(80.0),
        "focal_distance": f32(2.0),
        "aperture_radius": f32(0.0),
        "logo_visible": f32(0.0),
        "armadillo_visible": f32(0.0),
        "dragon_visible": f32(0.0),
        "bunny_visible": f32(0.0),
        "end_visible": f32(0.0),
        "teapot_pos_x": f32(40.1),
        "teapot_pos_y": f32(13.95),
        "teapot_pos_z": f32(13.611633),
        "teapot_ori_x": f32(0.0),
        "teapot_ori_y": f32(0.0),
        "teapot_ori_z": f32(0.0),
        "armadillo_pos_x": f32(0.0),
        "armadillo_pos_y": f32(0.0),
        "armadillo_pos_z": f32(0.0),
        "armadillo_ori_x": f32(0.0),
        "armadillo_ori_y": f32(0.0),
        "armadillo_ori_z": f32(0.0),
        "dragon_pos_x": f32(0.0),
        "dragon_pos_y": f32(0.0),
        "dragon_pos_z": f32(0.0),
        "dragon_ori_x": f32(0.0),
        "dragon_ori_y": f32(0.0),
        "dragon_ori_z": f32(0.0),
        "bunny_pos_x": f32(0.0),
        "bunny_pos_y": f32(0.0),
        "bunny_pos_z": f32(0.0),
        "bunny_ori_x": f32(0.0),
        "bunny_ori_y": f32(0.0),
        "bunny_ori_z": f32(0.0),
        "end_pos_x": f32(0.0),
        "end_pos_y": f32(0.0),
        "end_pos_z": f32(0.0),
        "end_ori_x": f32(0.0),
        "end_ori_y": f32(0.0),
        "end_ori_z": f32(0.0),
    }


def play_animation_track(state: dict, t: float) -> None:
    """reference: scene.cc:33-42 — break at first start > t, in order."""
    t = f32(t)
    for start, duration, v_from, v_to, target in ANIMATION_TRACK:
        if not (f32(start) <= t):
            break
        if duration == 0:
            lt = f32(1.0)
        else:
            lt = f32(
                np.clip((t - f32(start)) / f32(duration), f32(0.0), f32(1.0))
            )
        state[target] = f32(
            f32(v_from) * (f32(1.0) - lt) + f32(v_to) * lt
        )
