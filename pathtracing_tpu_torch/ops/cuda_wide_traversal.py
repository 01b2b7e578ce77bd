"""The CUDA wide-BVH ray-query kernel: binding and wrapper.

``wide_ray_query_cuda`` is the counterpart of the JAX package's
``wide_ray_query`` (the JAX package's ops/wide_traversal.py, an XLA while-loop
there): same contract as ``ops/wide_traversal.wide_ray_query``, served by the
hand-written kernel in ``csrc/wide_ray_query.cu`` (one thread per ray; see the
note at the top of that file for what bounds it and what its design does
about it).

Differences from the JAX function's interface, on purpose: no
``leaf_every`` / ``compact_schedule`` arguments — both are schedules of a
SIMD loop whose results are identical by construction; a thread leaves its
own loop here. There is no second path to give way to: a build or launch
failure propagates.

Build and binding: ops/cuda_build.py. The library's hash covers
``csrc/ray_common.cuh``, which this kernel shares with ``csrc/ray_query.cu``,
and ``csrc/wide_walk.cuh``, the walk it shares with the megakernel
(``csrc/megakernel.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops.cuda_build import (
    CSRC,
    KernelLibrary,
    check_tensor as _check,
)
from pathtracing_tpu_torch.ops.traversal import RayHit
from pathtracing_tpu_torch.ops.wide_traversal import _layout_of
from pathtracing_tpu_torch.utils.vec import Vec3

SOURCE = CSRC / "wide_ray_query.cu"
HEADER = CSRC / "ray_common.cuh"
WALK_HEADER = CSRC / "wide_walk.cuh"

_p, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
LIBRARY = KernelLibrary(
    SOURCE,
    headers=(HEADER, WALK_HEADER),
    symbols={
        "pt_wide_ray_query": (
            [_p, _i] + [_p] * 16 + [_f, _f, _i] + [_p] * 7 + [_i, _p], _i,
        ),
        "pt_wide_ray_query_block_size": ([], _i),
        "pt_wide_ray_query_occupancy": ([_i], _i),
        "pt_wide_ray_query_width": ([_i, _i, _i], _i),
    },
)

# Launches of the kernel since the last reset: incremented where the kernel
# is launched and nowhere else, so a run can show that it went through it.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def table_bytes(scene) -> int:
    """Bytes of the tables the kernel reads (reporting only: nothing is gated
    on it): the mega-table and its root cursors, and for the finalize step
    (and stub leaves) ``tri_pos``, ``inst_f`` and ``inst_u``."""
    return sum(
        t.numel() * t.element_size()
        for t in (scene.wide_rows, scene.wide_root, scene.tri_pos,
                  scene.inst_f, scene.inst_u)
    )


def block_size() -> int:
    """Threads per block of the built kernel."""
    return int(LIBRARY.load().pt_wide_ray_query_block_size())


def _lane_or_scalar(name, v, R, device):
    """(per-lane f32 tensor or None, scalar float) for a tmin / tmax0 that
    may be either."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        _check(name, v, torch.float32, (R,), device)
        return v, 0.0
    return None, float(v)


def check_scene(scene, device):
    """Raise unless the scene's tables are what the kernel takes, on
    ``device``: a mega-table in a shipped layout's row width, contiguous,
    16-byte aligned (rows are read as 16-byte vectors), its root cursors, and
    the binary walk's ``tri_pos`` / ``inst_f`` / ``inst_u`` for the finalize
    step and stub leaves. Returns the layout."""
    f32, i32 = torch.float32, torch.int32
    if scene.wide_rows is None or scene.wide_root is None:
        raise ValueError("the scene carries no wide tables: pack it with wide=True")
    lay = _layout_of(scene)  # raises on a width no layout has
    rows = scene.wide_rows
    _check("scene.wide_rows", rows, f32, (rows.shape[0], lay.w_row), device)
    _check("scene.wide_root", scene.wide_root, i32, (scene.wide_root.shape[0], 8), device)
    _check("scene.tri_pos", scene.tri_pos, f32, (scene.tri_pos.shape[0], 12), device)
    _check("scene.inst_f", scene.inst_f, f32, (scene.inst_f.shape[0], 21), device)
    _check("scene.inst_u", scene.inst_u, i32, (scene.inst_u.shape[0], 6), device)
    for name, t in (("scene.wide_rows", rows), ("scene.tri_pos", scene.tri_pos)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows are read as 16-byte vectors; "
                             "the table must be 16-byte aligned")
    root_base = scene.wide_root_base
    if root_base is not None:
        _check("scene.wide_root_base", root_base, i32, None, device)
        if root_base.numel() != 1:
            raise ValueError("scene.wide_root_base: one int32 expected")
    return lay


def wide_ray_query_cuda(
    scene,
    tlas_count,
    tlas_offset,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active,
    anyhit=False,
):
    """Wide-BVH ray query on CUDA tensors by the hand-written kernel; same
    contract as ``ops/wide_traversal.wide_ray_query``. Returns (RayHit,
    occluded).

    ``anyhit``: a Python bool, or a per-lane bool tensor. ``tmin``, ``tmax0``:
    a scalar or a per-lane f32 tensor each. ``tlas_count`` is accepted for
    signature parity and not read.

    Launches on PyTorch's current stream and does not synchronise. Raises on
    a tensor of the wrong device, dtype, shape or layout, on a row width no
    shipped layout has, on a misaligned table and on a refused launch; it
    never gives way to the plain version.
    """
    global launches
    device = org.x.device
    if device.type != "cuda":
        raise ValueError(f"wide_ray_query_cuda needs CUDA tensors, got {device}")
    R = org.x.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    lay = check_scene(scene, device)
    rows, root_base = scene.wide_rows, scene.wide_root_base
    _check("tlas_offset", tlas_offset, i32, (R,), device)
    for name, t in zip(("org.x", "org.y", "org.z", "d.x", "d.y", "d.z"), (*org, *d)):
        _check(name, t, f32, (R,), device)
    _check("active", active, b8, (R,), device)

    anyhit_lane, anyhit_all = None, 0
    if isinstance(anyhit, torch.Tensor):
        _check("anyhit", anyhit, b8, (R,), device)
        anyhit_lane = anyhit
    elif isinstance(anyhit, bool):
        anyhit_all = int(anyhit)
    else:
        raise TypeError("anyhit: a Python bool or a per-lane bool tensor")
    tmin_lane, tmin_all = _lane_or_scalar("tmin", tmin, R, device)
    tmax_lane, tmax_all = _lane_or_scalar("tmax0", tmax0, R, device)

    lib = LIBRARY.load()
    built = lib.pt_wide_ray_query_width(lay.n_slots, lay.leaf_tris, int(lay.stub))
    if built != lay.w_row:
        raise RuntimeError(
            f"kernel and accel/wide.py disagree on the row width of layout "
            f"({lay.n_slots}, {lay.leaf_tris}, stub={lay.stub}): {built} vs {lay.w_row}"
        )
    thit = torch.empty(R, dtype=f32, device=device)
    bu = torch.empty(R, dtype=f32, device=device)
    bv = torch.empty(R, dtype=f32, device=device)
    inst = torch.empty(R, dtype=i32, device=device)
    prim = torch.empty(R, dtype=i32, device=device)
    back = torch.empty(R, dtype=b8, device=device)
    occ = torch.empty(R, dtype=b8, device=device)

    # The launch is asynchronous. Inputs and outputs need no reference kept
    # past this call: PyTorch's allocator hands a freed block out again only
    # in the order of the stream it was used on, and this is that stream.
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_wide_ray_query(
            ptr(rows), lay.w_row, ptr(scene.wide_root), ptr(root_base),
            ptr(scene.tri_pos), ptr(scene.inst_f), ptr(scene.inst_u),
            ptr(tlas_offset),
            ptr(org.x), ptr(org.y), ptr(org.z), ptr(d.x), ptr(d.y), ptr(d.z),
            ptr(tmin_lane), ptr(tmax_lane), ptr(active), ptr(anyhit_lane),
            tmin_all, tmax_all, anyhit_all,
            ptr(thit), ptr(bu), ptr(bv), ptr(inst), ptr(prim), ptr(back), ptr(occ),
            R, stream,
        )
    if err != 0:
        raise RuntimeError(f"wide_ray_query kernel launch refused: cudaError {err}")
    if R > 0:
        launches += 1
    hit = RayHit(
        thit=thit, bary_u=bu, bary_v=bv, bary_w=1.0 - bu - bv,
        inst=inst, prim=prim, back=back,
    )
    return hit, occ
