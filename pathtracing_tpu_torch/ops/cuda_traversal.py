"""The CUDA ray-query kernel: build, binding and wrapper.

``ray_query_cuda`` is the counterpart of the JAX package's
``ray_query_pallas`` (the JAX package's ops/pallas_traversal.py): same
contract as ``ops/traversal.ray_query``, served by the hand-written kernel
in ``csrc/ray_query.cu`` (one thread per ray; see the note at the top of
that file for what bounds it and what its design does about it).

Differences from the TPU wrapper's interface, on purpose:
  * no ``block`` / ``leaf_every`` arguments — they were schedule knobs of a
    SIMD loop whose results are identical by construction; a thread leaves
    its own loop here;
  * no ``vmem_fits`` gate and no ``ray_query_auto`` — the kernel reads the
    tables from device memory through L2 and takes any table size, and
    there is no second path to give way to: a build or launch failure
    propagates. ``table_bytes`` only reports the tables' size.

The node rows: a scene with bf16 node rows (``scene.nl5``,
scene/device.with_bf16_nodes) is walked through them by the kernel's nl5
instance, any other through ``nl8``. The source builds two libraries, one
per row format (``-DPT_NODE_ROWS=5`` for nl5), and the wrapper launches the
one of the scene's rows or raises; it never walks the other table.

The bounded query (``max_steps`` / ``return_state``, the JAX walk's
arguments) is the library's second kernel: each lane stops after
``max_steps`` steps of the one-speed loop and the kernel writes its whole
walk state (``_TravState``, one int32 plane per field) or the hit
finalized from it. The unbounded kernel is the same as before.

Build and binding: ops/cuda_build.py (``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``, built at first use under a
hash-keyed name in ``build/torch_kernels/``). The hash covers the two headers
the source includes: ``ray_common.cuh`` and ``binary_walk.cuh`` (the walk,
shared with the wavefront kernel ``wavefront.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops.cuda_build import (
    CSRC,
    KernelLibrary,
    check_tensor as _check,
)
from pathtracing_tpu_torch.ops.traversal import RayHit, _TravState
from pathtracing_tpu_torch.utils.vec import Vec3

SOURCE = CSRC / "ray_query.cu"
HEADER = CSRC / "ray_common.cuh"
WALK_HEADER = CSRC / "binary_walk.cuh"

_p, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
SYMBOLS = {
    "pt_ray_query": ([_p] * 15 + [_f, _f, _i] + [_p] * 7 + [_i, _p], _i),
    "pt_ray_query_bounded": ([_p] * 15 + [_f, _f, _i, _i, _p] + [_p] * 7 + [_i, _p], _i),
    "pt_ray_query_state_fields": ([], _i),
    "pt_ray_query_block_size": ([], _i),
    "pt_ray_query_node_words": ([], _i),
    "pt_ray_query_occupancy": ([], _i),
}
# One library per node-row format, built side by side from the one source.
LIBRARY = KernelLibrary(SOURCE, headers=(HEADER, WALK_HEADER), symbols=SYMBOLS)
NL5_LIBRARY = KernelLibrary(SOURCE, headers=(HEADER, WALK_HEADER), symbols=SYMBOLS,
                            defines=("-DPT_NODE_ROWS=5",), name="ray_query_nl5")
LIBRARY_BY_ROWS = {"nl8": LIBRARY, "nl5": NL5_LIBRARY}
# f32 words of a node row per format
NODE_WORDS = {"nl8": 8, "nl5": 5}

# Launches of the kernels since the last reset, in all and per node-row
# format, and of the bounded kernel among them: incremented where a kernel
# is launched and nowhere else, so a run can show that it went through it.
launches = 0
launches_by_rows = {"nl8": 0, "nl5": 0}
bounded_launches = 0

# The walk state's planes as the bounded kernel writes them: _TravState's
# fields in order, each an int32 plane holding the field's bits (floats) or
# 0 / 1 (bools).
STATE_DTYPES = {
    f: (torch.bool if f in ("in_blas", "done", "occluded")
        else torch.float32 if f.startswith(("b_org", "b_inv", "b_S")) or f == "tmax"
        else torch.int32)
    for f in _TravState._fields
}
# no step bound: the bounded kernel's max_steps for return_state alone
UNBOUNDED_STEPS = 2**31 - 1


def reset_launches() -> None:
    global launches, bounded_launches
    launches = bounded_launches = 0
    for k in launches_by_rows:
        launches_by_rows[k] = 0


def node_table(scene, device):
    """The binary node rows a kernel walks, checked: ("nl5", scene.nl5) when
    the scene carries bf16 rows, else ("nl8", scene.nl8). ``nl8`` is a
    contiguous (8N, 8) f32 table on ``device`` either way; walked, it must be
    16-byte aligned (its rows are read as float4 pairs). ``nl5`` must be a
    contiguous (8N, 5) f32 table on ``device``, 4-byte aligned (its rows are
    read as five words)."""
    f32 = torch.float32
    rows = scene.nl8.shape[0]
    _check("scene.nl8", scene.nl8, f32, (rows, 8), device)
    if scene.nl5 is None:
        if scene.nl8.data_ptr() % 16:
            raise ValueError("scene.nl8: rows are read as 16-byte vectors; "
                             "the table must be 16-byte aligned")
        return "nl8", scene.nl8
    _check("scene.nl5", scene.nl5, f32, (rows, 5), device)
    if scene.nl5.data_ptr() % 4:
        raise ValueError("scene.nl5: rows are read as 4-byte words; "
                         "the table must be 4-byte aligned")
    return "nl5", scene.nl5


def table_bytes(scene) -> int:
    """Bytes of the four tables the kernel reads: the node rows it walks
    (``nl5`` when the scene carries it, else ``nl8``), ``tri_pos``,
    ``inst_f``, ``inst_u`` (reporting only: nothing is gated on it)."""
    nodes = scene.nl8 if scene.nl5 is None else scene.nl5
    return sum(
        t.numel() * t.element_size()
        for t in (nodes, scene.tri_pos, scene.inst_f, scene.inst_u)
    )


def load_library(rows: str):
    """The built library of a node-row format ("nl8" or "nl5"), checked to
    walk rows of that many words."""
    lib = LIBRARY_BY_ROWS[rows].load()
    words = int(lib.pt_ray_query_node_words())
    if words != NODE_WORDS[rows]:
        raise RuntimeError(f"ray_query library for {rows} walks {words}-word rows")
    return lib


def block_size() -> int:
    """Threads per block of the built kernel."""
    return int(LIBRARY.load().pt_ray_query_block_size())


def ray_query_cuda(
    scene,
    tlas_count,
    tlas_offset,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active,
    anyhit=False,
    max_steps=None,
    return_state=False,
):
    """Ray query on CUDA tensors by the hand-written kernel; same contract
    as ``ops/traversal.ray_query``. Returns (RayHit, occluded), or with
    ``return_state`` the walk's ``_TravState``; ``max_steps`` or
    ``return_state`` launch the bounded kernel.

    ``anyhit``: a Python bool, or a per-lane bool tensor (one batch may mix
    shadow and bounce rays). ``tmax0``: a scalar or a per-lane f32 tensor.

    A scene with ``nl5`` is walked through its bf16 rows by the nl5
    instance, any other through ``nl8``. Launches on PyTorch's current
    stream and does not synchronise. Raises on a tensor of the wrong device,
    dtype, shape or layout, and on a refused launch; it never gives way to
    the plain version or to the other node table.
    """
    global launches, bounded_launches
    device = org.x.device
    if device.type != "cuda":
        raise ValueError(f"ray_query_cuda needs CUDA tensors, got {device}")
    R = org.x.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    rows, nodes = node_table(scene, device)
    _check("scene.tri_pos", scene.tri_pos, f32, (scene.tri_pos.shape[0], 12), device)
    _check("scene.inst_f", scene.inst_f, f32, (scene.inst_f.shape[0], 21), device)
    _check("scene.inst_u", scene.inst_u, i32, (scene.inst_u.shape[0], 6), device)
    if scene.tri_pos.data_ptr() % 16:
        raise ValueError("scene.tri_pos: rows are read as 16-byte vectors; "
                         "the table must be 16-byte aligned")
    _check("tlas_count", tlas_count, i32, (R,), device)
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

    tmax_lane, tmax_all = None, 0.0
    if isinstance(tmax0, torch.Tensor) and tmax0.dim() > 0:
        _check("tmax0", tmax0, f32, (R,), device)
        tmax_lane = tmax0
    else:
        tmax_all = float(tmax0)

    bounded = max_steps is not None or return_state
    if bounded:
        steps = UNBOUNDED_STEPS if max_steps is None else int(max_steps)
        if not 0 <= steps <= UNBOUNDED_STEPS:
            raise ValueError(f"max_steps {max_steps}: 0 to {UNBOUNDED_STEPS}")
    lib = load_library(rows)
    state = None
    if return_state:
        if int(lib.pt_ray_query_state_fields()) != len(_TravState._fields):
            raise RuntimeError("ray_query library writes another walk state")
        state = torch.empty((len(_TravState._fields), R), dtype=i32, device=device)
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
        inputs = (
            ptr(nodes), ptr(scene.tri_pos), ptr(scene.inst_f), ptr(scene.inst_u),
            ptr(tlas_count), ptr(tlas_offset),
            ptr(org.x), ptr(org.y), ptr(org.z), ptr(d.x), ptr(d.y), ptr(d.z),
            ptr(tmax_lane), ptr(active), ptr(anyhit_lane),
            float(tmin), tmax_all, anyhit_all,
        )
        outputs = (ptr(thit), ptr(bu), ptr(bv), ptr(inst), ptr(prim), ptr(back), ptr(occ),
                   R, stream)
        if bounded:
            err = lib.pt_ray_query_bounded(*inputs, steps, ptr(state), *outputs)
        else:
            err = lib.pt_ray_query(*inputs, *outputs)
    if err != 0:
        raise RuntimeError(f"ray_query kernel launch refused: cudaError {err}")
    if R > 0:
        launches += 1
        launches_by_rows[rows] += 1
        bounded_launches += int(bounded)
    if return_state:
        return state_from_planes(state)
    hit = RayHit(
        thit=thit, bary_u=bu, bary_v=bv, bary_w=1.0 - bu - bv,
        inst=inst, prim=prim, back=back,
    )
    return hit, occ


def state_from_planes(planes) -> _TravState:
    """The ``_TravState`` of the bounded kernel's (fields, R) int32 planes,
    each field in its dtype (floats by their bits)."""
    out = {}
    for plane, (f, dt) in zip(planes, STATE_DTYPES.items()):
        if dt == torch.float32:
            out[f] = plane.view(dt)
        else:
            out[f] = plane != 0 if dt == torch.bool else plane
    return _TravState(**out)
