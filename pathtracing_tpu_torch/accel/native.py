"""ctypes loaders for the native C++ BVH builders (copies of the JAX
package's ``accel/native/bvh_builder.cc`` and ``wide_builder.cc``).

The reference keeps its builder native (bvh.cc); so does the port. The
libraries are built at first use by ``utils/native_build`` (``g++``, no pip
deps) into the port's own ``build/torch_native/``, keyed by a hash of
source and flags. Each entry point returns None when its library cannot be
built, and the caller takes the numpy builder, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from pathtracing_tpu_torch.utils.native_build import HostLibrary

_DIR = os.path.join(os.path.dirname(__file__), "native")
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U32 = ctypes.c_uint32

BVH_LIBRARY = HostLibrary(os.path.join(_DIR, "bvh_builder.cc"), {
    "pt_build_bvh": ([_F32P, _F32P, _U32P, _U32, _F32P, _U32P, _U32], ctypes.c_int64),
})

WIDE_LIBRARY = HostLibrary(os.path.join(_DIR, "wide_builder.cc"), {
    "pt_wide_tree_create": (
        [_U32P, _F32P, _U32, _F32P, _U32P, _U32, _U32, _U32, _U32, _U32],
        ctypes.c_void_p),
    "pt_wide_subtree_create": (
        [_U32P, _F32P, _U32, _F32P, _U32P, _U32, _U32, _U32, _U32, _U32, _U32,
         _U32P, _U32, _U32],
        ctypes.c_void_p),
    "pt_wide_rows_count": ([ctypes.c_void_p], ctypes.c_int64),
    "pt_wide_copy": ([ctypes.c_void_p, _F32P, _U32P], None),
    "pt_wide_destroy": ([ctypes.c_void_p], None),
})


def build_bvh_native(lmin: np.ndarray, lmax: np.ndarray, lidx: np.ndarray):
    """Build node/link arrays for the given leaves, or None if no native lib.

    Returns (nodes (N,6) f32, links (8N,2) u32) in the reference layout.
    """
    lib = BVH_LIBRARY.load()
    if lib is None:
        return None
    n = len(lidx)
    if n == 0:
        return np.zeros((0, 6), np.float32), np.zeros((0, 2), np.uint32)
    cap = 2 * n + 8
    lmin = np.ascontiguousarray(lmin, np.float32)
    lmax = np.ascontiguousarray(lmax, np.float32)
    lidx = np.ascontiguousarray(lidx, np.uint32)
    nodes = np.empty((cap, 6), np.float32)
    links = np.empty((8 * cap, 2), np.uint32)
    count = lib.pt_build_bvh(
        lmin.ctypes.data_as(_F32P), lmax.ctypes.data_as(_F32P),
        lidx.ctypes.data_as(_U32P), n,
        nodes.ctypes.data_as(_F32P), links.ctypes.data_as(_U32P), cap,
    )
    if count < 0:
        raise RuntimeError("BVH node capacity exceeded (should be impossible)")
    count = int(count)
    return nodes[:count].copy(), links[: 8 * count].copy()


def build_wide_tree_native(
    links: np.ndarray,      # (8n, 2) u32, octant-major
    nodes6: np.ndarray,     # (n, 6) f32
    tri9: np.ndarray | None,           # (T, 9) f32 (BLAS mode)
    payload_cursor: np.ndarray | None,  # (P,) u32 (TLAS mode)
    leaf_bundle: int,
    n_slots: int,
    leaf_tris: int,
    base_row: int,
    exit_sentinel: int,
    root_node: int = 0,
    exit8: np.ndarray | None = None,   # (8,) u32 per-octant exit cursors
    n_octants: int = 8,
    stub: bool = False,
):
    """8-octant wide trees (+ leaf chains) for one binary BVH (or the
    subtree rooted at ``root_node``). ``exit8`` overrides ``exit_sentinel``
    per octant so dynamic TLAS trees can chain into the static TLAS root of
    the same octant.

    Returns (rows (K, w_row) f32, root8 (8,) u32) or None when the native
    library is unavailable. Byte-identical to the Python WideBuilder.
    """
    from pathtracing_tpu_torch.accel.wide import WideLayout

    lib = WIDE_LIBRARY.load()
    if lib is None:
        return None
    n = len(nodes6)
    links = np.ascontiguousarray(links, np.uint32)
    nodes6 = np.ascontiguousarray(nodes6, np.float32)
    tri9_p = None
    if tri9 is not None:
        tri9 = np.ascontiguousarray(tri9, np.float32)
        tri9_p = tri9.ctypes.data_as(_F32P)
    pc_p = None
    if payload_cursor is not None:
        payload_cursor = np.ascontiguousarray(payload_cursor, np.uint32)
        pc_p = payload_cursor.ctypes.data_as(_U32P)
    e8_p = None
    if exit8 is not None:
        exit8 = np.ascontiguousarray(exit8, np.uint32)
        e8_p = exit8.ctypes.data_as(_U32P)
    h = lib.pt_wide_subtree_create(
        links.ctypes.data_as(_U32P), nodes6.ctypes.data_as(_F32P), n,
        tri9_p, pc_p, leaf_bundle, n_slots, leaf_tris, base_row,
        np.uint32(exit_sentinel), np.uint32(root_node), e8_p,
        np.uint32(n_octants), np.uint32(1 if stub else 0),
    )
    if not h:
        return None
    try:
        k = lib.pt_wide_rows_count(h)
        w_row = WideLayout(n_slots, leaf_tris, stub=stub).w_row
        rows = np.empty((k, w_row), np.float32)
        root8 = np.empty(8, np.uint32)
        lib.pt_wide_copy(h, rows.ctypes.data_as(_F32P), root8.ctypes.data_as(_U32P))
    finally:
        lib.pt_wide_destroy(h)
    return rows, root8
