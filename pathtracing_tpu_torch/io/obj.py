"""Mesh handles (reference: mesh.hh:18-28).

Only the handle the device packer reads is here; the OBJ/MTL loader of the
JAX package (``pathtracing_tpu/io/obj.py``) is a later slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MeshHandle:
    """reference: mesh.hh:18-28."""

    vertex_count: int
    triangle_count: int
    index_offset: int
    base_vertex_offset: int
