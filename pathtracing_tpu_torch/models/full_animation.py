"""The reference's full animated scene — the flagship model.

Thin preset wrapper over the scene pipeline: terrain recolor gradients, the
deterministic seed-{1,2,3,4} object placement, the ~240-entry animation
table, sunset sun curve, and per-frame subframe TLAS builds
(scene/loader.py; reference: scene.cc:135-718). The meshes come from
``data_dir`` (or ``$PT_DATA_DIR``): the reference's data folder, or stand-ins
written by ``scene/standins.write_standins``.
"""

from __future__ import annotations

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import TESTING, RenderConfig
from pathtracing_tpu_torch.models import _register


@_register("full_animation")
def build(
    config: RenderConfig = TESTING,
    frame: int = 0,
    data_dir: str | None = None,
    wide: bool | None = None,
    device=None,
):
    """Returns (Scene, SceneDevice) at animation frame ``frame``, on
    ``device`` (None: CUDA, raising when there is none).

    wide=True attaches the mega-table fast path (accel/wide.py) via the
    incremental DevicePacker with the chunked static region — static BLAS
    wide trees built once, only the frame's TLAS tail packed here; None
    turns it on for a CUDA device (the megakernel's tables). For a frame
    loop, keep the Scene and call scene.loader.setup_animation_frame +
    DevicePacker.pack_frame per frame (cli.py does this with host/device
    pipelining).
    """
    from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX
    from pathtracing_tpu_torch.scene.device import DevicePacker
    from pathtracing_tpu_torch.scene.loader import load_scene, setup_animation_frame

    device = resolve_device(device)
    if wide is None:
        wide = device.type == "cuda"
    s = load_scene(data_dir=data_dir, config=config, device=device)
    setup_animation_frame(s, frame, config)
    dev = DevicePacker(s, wide=wide, chunk_max=CHUNK_MAX if wide else None,
                       device=device).pack_frame(s)
    return s, dev
