"""ctypes bridge to the native OBJ parser (``io/native/obj_loader.cc``, a
copy of the JAX package's), built by ``utils/native_build``."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from pathtracing_tpu_torch.utils.native_build import HostLibrary

_SRC = os.path.join(os.path.dirname(__file__), "native", "obj_loader.cc")


class _PtMeshOut(ctypes.Structure):
    _fields_ = [
        ("vertex_count", ctypes.c_uint32),
        ("triangle_count", ctypes.c_uint32),
        ("indices", ctypes.POINTER(ctypes.c_uint32)),
        ("pos", ctypes.POINTER(ctypes.c_float)),
        ("normal", ctypes.POINTER(ctypes.c_float)),
        ("albedo", ctypes.POINTER(ctypes.c_float)),
        ("material", ctypes.POINTER(ctypes.c_float)),
    ]


LIBRARY = HostLibrary(_SRC, {
    "pt_load_obj": ([ctypes.c_char_p, ctypes.POINTER(_PtMeshOut)], ctypes.c_int),
    "pt_free_mesh": ([ctypes.POINTER(_PtMeshOut)], None),
})


def load_obj_native(path: str):
    """Returns (indices, pos, normal, albedo, material) numpy arrays, or None
    when the native library cannot be built."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    out = _PtMeshOut()
    rc = lib.pt_load_obj(path.encode(), ctypes.byref(out))
    if rc != 0:
        raise FileNotFoundError(f"pt_load_obj failed for {path}")
    try:
        k = out.triangle_count * 3
        v = out.vertex_count

        def arr(ptr, shape, dtype):
            n = int(np.prod(shape))
            if n == 0:
                return np.zeros(shape, dtype)
            return np.ctypeslib.as_array(ptr, (n,)).reshape(shape).astype(dtype, copy=True)

        indices = arr(out.indices, (k,), np.uint32)
        pos = arr(out.pos, (v, 3), np.float32)
        normal = arr(out.normal, (v, 3), np.float32)
        albedo = arr(out.albedo, (v, 4), np.float32)
        material = arr(out.material, (v, 4), np.float32)
    finally:
        lib.pt_free_mesh(ctypes.byref(out))
    return indices, pos, normal, albedo, material
