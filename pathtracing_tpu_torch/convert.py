"""State carried across from the JAX package: one scene, the same bytes.

The caller hands over the JAX ``SceneDevice``'s fields as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in jax_scene._asdict().items() if v is not None}``;
this module itself imports no JAX.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.scene.device import SceneDevice, to_device

# fields of the JAX SceneDevice that this slice of the port does not read
_LATER = (
    "nl5", "wide_rows", "wide_root", "wide_root_base", "tri_shade",
    "lt_tris", "lt_rows", "lt_cdf", "lt_seg", "lt_rank",
    "hot_rows", "hot_planes",
)


def scene_from_jax(fields: dict[str, np.ndarray], device=None) -> SceneDevice:
    """The port's SceneDevice from the numpy fields of a JAX SceneDevice.

    Tables are uploaded byte for byte (the link bit patterns in ``nl8`` pass
    through no float op). Optional tables of later slices (wide BVH, packed
    shading rows, area lights, hot rows) are refused rather than dropped, so
    a scene never renders through another path than the caller packed it for.
    """
    device = resolve_device(device)
    unknown = set(fields) - set(SceneDevice._fields)
    if unknown:
        raise KeyError(f"not SceneDevice fields: {sorted(unknown)}")
    later = [k for k in _LATER if fields.get(k) is not None]
    if later:
        raise NotImplementedError(
            f"scene tables of a later slice of the port: {later}"
        )
    missing = [
        k for k in SceneDevice._fields if k not in _LATER and fields.get(k) is None
    ]
    if missing:
        raise KeyError(f"missing SceneDevice fields: {missing}")
    return SceneDevice(
        **{
            k: to_device(np.asarray(fields[k]), device)
            for k in SceneDevice._fields
            if k not in _LATER
        }
    )
