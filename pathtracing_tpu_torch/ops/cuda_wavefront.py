"""The CUDA wavefront kernel (K5): binding and wrapper.

``wavefront_cuda`` renders the per-entry sums of whole paths (sun NEE, and
area-light NEE on a scene with light tables) for any
(xs, ys) pixel list with the hand-written kernel in ``csrc/wavefront.cu``
(one thread per list entry, its samples in order; see the note at the top of
that file for the design, the fold and the step cap), on the binary tables
(binary walk, unpacked shading fetch) or on the wide ones (wide walk, packed
fetch). It is the counterpart of the JAX package's ``path_trace_wavefront``
(the JAX package's ops/wavefront.py, an XLA while-loop there);
``ops/wavefront.path_trace_wavefront`` dispatches to it for CUDA tensors, and
``ops/wavefront.path_trace_wavefront_plain`` is its plain version.

Two designs of the kernel give the same bytes (csrc/wavefront.cu), one
thread per entry each: the first, 128 threads a block, and the wide block,
512 threads, one block an SM. The wrapper takes the design of
``cuda_megakernel.DESIGN_BY_WIDTH`` for the scene's tables: the first
design on the binary tables, the wide block on the mega-tables.

A binary scene with bf16 node rows (``scene.nl5``) is walked through them
by the kernel's nl5 instances: the source builds them into libraries of
their own (``-DPT_NODE_ROWS=5``, sun-only and area-light, binary walk only),
which compile beside the others. A scene with wide tables walks them and
ignores ``nl5``, as ``ops/traversal.ray_query`` does.

There is no second path to give way to: a build or launch failure, or a
tensor the kernel does not take, raises.

Build and binding: ops/cuda_build.py. The library's hash covers every header
the source includes: ``ray_common.cuh``, ``binary_walk.cuh`` (the binary walk,
shared with ``ray_query.cu``), ``wide_walk.cuh`` (shared with
``wide_ray_query.cu``), ``shading.cuh`` and ``path.cuh`` (the per-sample path
body, shared with ``megakernel.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops.cuda_build import (
    CSRC,
    KernelLibrary,
    check_tensor as _check,
)
from pathtracing_tpu_torch.ops.cuda_traversal import NODE_WORDS, node_table
from pathtracing_tpu_torch.utils.vec import c32

SOURCE = CSRC / "wavefront.cu"
WALK_HEADER = CSRC / "binary_walk.cuh"
HEADERS = (CSRC / "ray_common.cuh", WALK_HEADER, CSRC / "wide_walk.cuh",
           CSRC / "shading.cuh", CM.PATH_HEADER)

_p, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
# pt_wavefront's parameters, in order (csrc/wavefront.cu)
ARGTYPES = (
    [_p, _i, _p, _p, _p]        # rows, width, wide_root, root_base, tri_shade
    + [_p, _p, _p, _p, _i]      # nodes, tri_idx, vattr, sf_tlas_count, n_tlas_count
    + [_p, _p, _p]              # tri_pos, inst_f, inst_u
    + [_p, _i, _p, _i, _p, _i]  # sf_cam, n_cam, sf_light, n_light, sf_tlas_offset, n_tlas
    + [_p, _p] + [_i] * 8       # xs, ys; n, spp, sample_base, width, height,
                                # max_bounces, smbs, student_id
    + [_f] * 3 + [_i]           # min/max ray dist, gamma; max_steps
    + [_p] * 7                  # r, g, b, l2, n_truncated, counts, phases
    + [_i]                      # design
    + [_p] * 5 + [_i]           # lt_tris, lt_rows, lt_cdf, lt_seg, lt_rank; L
    + [_p]                      # stream
)
SYMBOLS = {
    "pt_wavefront": (ARGTYPES, _i),
    "pt_wavefront_block_size": ([_i], _i),
    "pt_wavefront_count_slots": ([], _i),
    "pt_wavefront_node_words": ([], _i),
    "pt_wavefront_phase_slots": ([], _i),
    "pt_wavefront_occupancy": ([_i, _i], _i),
}
# Four libraries from the one source, built side by side: the sun-only
# instances, and the area-light instances (csrc/path.cuh's AreaLights) that
# a scene with light tables launches; each on nl8 rows (and the wide tables)
# and on nl5 rows (the binary walk only).
_NL5 = "-DPT_NODE_ROWS=5"
_LIT = "-DPT_AREA_LIGHTS=1"
LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS)
LIT_LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS,
                            defines=(_LIT,), name="wavefront_lit")
NL5_LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS,
                            defines=(_NL5,), name="wavefront_nl5")
NL5_LIT_LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS,
                                defines=(_NL5, _LIT), name="wavefront_nl5_lit")
# (node rows, lit) -> library; the wide tables take the "nl8" libraries
LIBRARIES = {("nl8", False): LIBRARY, ("nl8", True): LIT_LIBRARY,
             ("nl5", False): NL5_LIBRARY, ("nl5", True): NL5_LIT_LIBRARY}

# Launches of the kernel since the last reset, in all and per table walked
# (binary nl8 rows, binary nl5 rows, the wide tables): incremented where the
# kernel is launched and nowhere else, so a run can show that it went
# through it.
launches = 0
launches_by_tables = {"nl8": 0, "nl5": 0, "wide": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for k in launches_by_tables:
        launches_by_tables[k] = 0


def block_size(design: str = "first") -> int:
    """Threads per block of the built kernel in ``design``."""
    return int(LIBRARY.load().pt_wavefront_block_size(CM.DESIGNS.index(design)))


def check_scene(scene, device) -> int:
    """Raise unless the scene's tables are what the kernel takes, on
    ``device``. A scene with wide tables is walked wide (as
    ``ops/traversal.ray_query`` walks it, ``nl5`` or not), and is checked as
    the megakernel checks it (the wide tables, the packed shading rows, the
    subframe tables); a binary scene needs its node rows as
    ``cuda_traversal.node_table`` checks them (``nl5`` when it carries them,
    else a 16-byte aligned ``nl8``), a 16-byte aligned ``tri_pos``,
    ``inst_f``, ``inst_u``, ``tri_idx``, ``vattr`` and the four subframe
    tables, each with a row at least; light tables as ``CM.check_lights``
    checks them. Returns the row width the kernel selects by (0: binary)."""
    CM.check_lights(scene, device)
    if scene.wide_rows is not None:
        return CM.check_scene(scene, device).w_row
    f32, i32 = torch.float32, torch.int32
    node_table(scene, device)
    _check("scene.tri_pos", scene.tri_pos, f32, (scene.tri_pos.shape[0], 12), device)
    _check("scene.inst_f", scene.inst_f, f32, (scene.inst_f.shape[0], 21), device)
    _check("scene.inst_u", scene.inst_u, i32, (scene.inst_u.shape[0], 6), device)
    _check("scene.tri_idx", scene.tri_idx, i32, (scene.tri_idx.shape[0], 4), device)
    _check("scene.vattr", scene.vattr, f32, (scene.vattr.shape[0], 12), device)
    if scene.tri_pos.data_ptr() % 16:
        raise ValueError("scene.tri_pos: rows are read as 16-byte vectors; "
                         "the table must be 16-byte aligned")
    _check("scene.sf_cam", scene.sf_cam, f32, (scene.sf_cam.shape[0], 18), device)
    _check("scene.sf_light", scene.sf_light, f32, (scene.sf_light.shape[0], 7), device)
    for name in ("sf_tlas_count", "sf_tlas_offset"):
        t = getattr(scene, name)
        _check(f"scene.{name}", t, i32, (t.shape[0],), device)
    for name in ("sf_cam", "sf_light", "sf_tlas_count", "sf_tlas_offset"):
        if getattr(scene, name).shape[0] == 0:
            raise ValueError(f"scene.{name}: no subframe rows")
    return 0


def load_library(tables: str, lit: bool):
    """The built library for the tables walked ("nl8", "nl5" or "wide") and
    the light policy, checked to walk binary rows of the table's width."""
    rows = "nl8" if tables == "wide" else tables
    lib = LIBRARIES[rows, lit].load()
    words = int(lib.pt_wavefront_node_words())
    if words != NODE_WORDS[rows]:
        raise RuntimeError(f"wavefront library for {rows} walks {words}-word rows")
    return lib


def kernel_args(config, scene, width, xs, ys, spp, sample_base, max_steps, r, g, b, l2,
                n_trunc, counts, stream, phases=None, design=0, n_lights=0):
    """pt_wavefront's arguments, in ARGTYPES' order (tensors as pointers);
    ``design``: its code (``CM.design_code``); ``n_lights``: the light
    tables' rows (``CM.check_lights``), 0 for none."""
    ptr = lambda t: None if t is None else t.data_ptr()
    wide = width != 0
    wide_only = lambda t: ptr(t) if wide else None
    binary_only = lambda t: None if wide else ptr(t)
    nodes = None if wide else node_table(scene, scene.nl8.device)[1]
    # the light instances read the emission at a light point from tri_idx /
    # vattr on either walk
    unpacked = lambda t: ptr(t) if (not wide or n_lights) else None
    i32 = CM._int32
    return (
        wide_only(scene.wide_rows), width, wide_only(scene.wide_root),
        wide_only(scene.wide_root_base), wide_only(scene.tri_shade),
        ptr(nodes), unpacked(scene.tri_idx), unpacked(scene.vattr),
        binary_only(scene.sf_tlas_count), scene.sf_tlas_count.shape[0],
        ptr(scene.tri_pos), ptr(scene.inst_f), ptr(scene.inst_u),
        ptr(scene.sf_cam), scene.sf_cam.shape[0], ptr(scene.sf_light),
        scene.sf_light.shape[0], ptr(scene.sf_tlas_offset), scene.sf_tlas_offset.shape[0],
        ptr(xs), ptr(ys), i32("n", xs.shape[0]), i32("spp", spp),
        i32("sample_base", sample_base), config.image_width, config.image_height,
        config.max_bounces, config.samples_per_motion_blur_step,
        i32("student_id", config.student_id), c32(config.min_ray_dist),
        c32(config.max_ray_dist), c32(config.path_space_regularization_gamma),
        i32("max_steps", max_steps),
        ptr(r), ptr(g), ptr(b), ptr(l2), ptr(n_trunc), ptr(counts), ptr(phases),
        design, *CM.light_args(scene, n_lights), stream,
    )


def wavefront_cuda(
    config,
    scene,
    xs,
    ys,
    spp: int,
    sample_base: int = 0,
    with_stats: bool = False,
    max_steps: int | None = None,
    counts: bool = False,
    phases: bool = False,
    _design: str | None = None,
):
    """Per-entry radiance sums over samples [sample_base, sample_base + spp)
    of pixels (xs[i], ys[i]) by the hand-written kernel. ``xs``, ``ys``:
    (n,) int32 CUDA tensors on the scene's device. ``max_steps``: row visits
    per ray before a sample is abandoned (None: ``CM.step_cap(scene)``).

    Instruments (chip_smoke.py): ``counts=True`` runs the counting build
    instead and also returns its counters (int64, ``CM.COUNT_NAMES``' order);
    ``phases=True`` the phase-cycle build (not with light tables), and
    returns its cycles per phase (int64, ``CM.PHASE_NAMES``' order) in that
    place. A scene with light tables runs the kernel's area-light
    instances, a binary scene with ``nl5`` its nl5 instances. ``_design``:
    None (the tables' design, ``CM.DESIGN_BY_WIDTH``), or "first" or "wide"
    to time one design against the other; the counting build always runs
    the first.

    Returns (r, g, b, l2, n_truncated, counts): (n,) f32 sums, the
    luminance-squared sums or None, a one-element int32 tensor of abandoned
    samples, and the counters or None. Launches on PyTorch's current stream
    and does not synchronise. Raises on a tensor of the wrong device, dtype,
    shape or layout and on a refused launch; it never gives way to the plain
    version.
    """
    global launches
    device = scene.nl8.device
    if device.type != "cuda":
        raise ValueError(f"wavefront_cuda needs CUDA tensors, got {device}")
    width = check_scene(scene, device)
    # the tables walked: the wide ones (nl5 or not), else the node rows'
    tables = "wide" if width else node_table(scene, device)[0]
    n_lights = CM.check_lights(scene, device)
    if n_lights and phases:
        raise ValueError("the phase-cycle build has no area-light instance")
    n = xs.shape[0] if isinstance(xs, torch.Tensor) else -1
    _check("xs", xs, torch.int32, (n,), device)
    _check("ys", ys, torch.int32, (n,), device)
    if spp < 0:
        raise ValueError(f"spp={spp}: must be >= 0")
    if counts and phases:
        raise ValueError("counts and phases are two builds: ask for one")
    steps = CM.step_cap(scene) if max_steps is None else int(max_steps)
    if steps <= 0:
        raise ValueError(f"max_steps={steps}: must be > 0")
    code = 0 if counts else CM.design_code(width, _design)

    out = lambda: torch.empty(n, dtype=torch.float32, device=device)
    r, g, b = out(), out(), out()
    l2 = out() if with_stats else None
    n_trunc = torch.zeros(1, dtype=torch.int32, device=device)
    lib = load_library(tables, bool(n_lights))
    cnt = ph = None
    if counts:
        cnt = torch.zeros(lib.pt_wavefront_count_slots(), dtype=torch.int64, device=device)
        if cnt.numel() != len(CM.COUNT_NAMES):
            raise RuntimeError(f"kernel counts {cnt.numel()} slots, COUNT_NAMES "
                               f"names {len(CM.COUNT_NAMES)}")
    if phases:
        ph = torch.zeros(lib.pt_wavefront_phase_slots(), dtype=torch.int64, device=device)
        if ph.numel() != len(CM.PHASE_NAMES):
            raise RuntimeError(f"kernel times {ph.numel()} phases, PHASE_NAMES "
                               f"names {len(CM.PHASE_NAMES)}")
    # The launch is asynchronous; PyTorch's allocator hands a freed block out
    # again only in the order of the stream it was used on, and this is it.
    with torch.cuda.device(device):
        err = lib.pt_wavefront(*kernel_args(
            config, scene, width, xs, ys, spp, sample_base, steps, r, g, b, l2, n_trunc,
            cnt, torch.cuda.current_stream().cuda_stream, phases=ph, design=code,
            n_lights=n_lights,
        ))
    if err != 0:
        raise RuntimeError(f"wavefront launch refused: cudaError {err}")
    if n > 0:
        launches += 1
        launches_by_tables[tables] += 1
    return r, g, b, l2, n_trunc, ph if phases else cnt
