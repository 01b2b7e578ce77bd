"""The CUDA megakernel (K2): binding and wrapper.

``megakernel_cuda`` renders the per-pixel sums of whole paths (sun NEE, and
area-light NEE on a scene with light tables) with the hand-written kernel in ``csrc/megakernel.cu`` (one thread per pixel slot,
its samples in order; see the note at the top of that file for the design,
the fold and the step cap). It is the counterpart of the JAX package's
``path_trace_megakernel`` (the JAX package's ops/megakernel.py, an XLA
while-loop there); ``ops/megakernel.path_trace_megakernel`` dispatches to it
for CUDA tensors, and ``ops/megakernel.path_trace_megakernel_plain`` is its
plain version. ``megakernel_record_cuda`` runs the kernel's record build (K6:
the same paths, plus each work item's hit topology for the fast gradients),
which ``path_trace_megakernel(record=True)`` dispatches to.

Two designs of the kernel give the same bytes (csrc/megakernel.cu), one
thread per slot each: the first, 128 threads a block, and the wide block,
512 threads, one block an SM, its 16 warps on 512 adjacent slots. The
wrapper takes the design of ``DESIGN_BY_WIDTH`` for the scene's layout (the
wide block on every mega-table, from the card's measurements), and the
record build the same.

There is no second path to give way to: a build or launch failure, or a
tensor the kernel does not take, raises.

Build and binding: ops/cuda_build.py. The library's hash covers the headers
the source includes: ``ray_common.cuh`` (shared with both ray-query kernels),
``wide_walk.cuh`` (the walk, shared with ``wide_ray_query.cu``),
``binary_walk.cuh`` (the binary walk, shared with ``ray_query.cu``),
``shading.cuh`` and ``path.cuh`` (the per-sample path body, shared with the
wavefront kernel ``wavefront.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pathtracing_tpu_torch.ops.cuda_build import (
    CSRC,
    KernelLibrary,
    check_tensor as _check,
)
from pathtracing_tpu_torch.ops.cuda_wide_traversal import check_scene as _check_wide
from pathtracing_tpu_torch.ops.wide_traversal import _layout_of
from pathtracing_tpu_torch.utils.vec import c32

SOURCE = CSRC / "megakernel.cu"
PATH_HEADER = CSRC / "path.cuh"
HEADERS = (CSRC / "ray_common.cuh", CSRC / "wide_walk.cuh", CSRC / "binary_walk.cuh",
           CSRC / "shading.cuh", PATH_HEADER)

_p, _f, _i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
SYMBOLS = {
    "pt_megakernel": (
        [_p, _i] + [_p] * 6 + [_p, _i] * 3 + [_p] + [_i] * 9 + [_f] * 3 + [_i]
        + [_p] * 7                  # r, g, b, l2, n_truncated, counts, phases
        + [_i]                      # design
        + [_p] * 5                  # the five record planes
        + [_p] * 5 + [_i]           # lt_tris, lt_rows, lt_cdf, lt_seg, lt_rank; L
        + [_p] * 3,                 # tri_idx, vattr, stream
        _i,
    ),
    "pt_megakernel_block_size": ([_i], _i),
    "pt_megakernel_count_slots": ([], _i),
    "pt_megakernel_phase_slots": ([], _i),
    "pt_megakernel_occupancy": ([_i, _i], _i),
}
# Two libraries from the one source, built side by side: the sun-only
# instances (and the record build K6), and the area-light instances
# (csrc/path.cuh's AreaLights) that a scene with light tables launches.
LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS)
LIT_LIBRARY = KernelLibrary(SOURCE, headers=HEADERS, symbols=SYMBOLS,
                            defines=("-DPT_AREA_LIGHTS=1",), name="megakernel_lit")

# What the counting builds of the path kernels (K2 here, K5 in
# ops/cuda_wavefront.py) count, in the kernels' order (csrc/path.cuh):
# samples traced, rows visited by kind (node rows: binary nodes or WIDE rows;
# leaf rows: LEAF rows or binary triangle tests; BLAS entries), the slab tests
# the node rows needed and the triangle tests the leaves made, rays walked,
# closest hits shaded as hits / misses, atmosphere marches run (scattering,
# with a draw) and NEE transmittance marches run, BSDF evaluations (one per
# NEE) and BSDF samples; with area lights, light samples (CDF search, point,
# emission, bsdf_eval) and light pdfs of closest hits on an emitter (the
# area shadow rays are counted among the rays).
COUNT_NAMES = (
    "samples", "node_rows", "leaf_rows", "inst_rows", "slab_tests", "tri_tests",
    "rays", "shade_hits", "shade_misses", "atmo_marches", "nee_evals",
    "nee_marches", "bsdf_samples", "light_samples", "light_pdfs",
)

# What the phase-cycle builds of the path kernels time, in the kernels' order
# (csrc/path.cuh, PhaseClock): camera and RNG draws, the closest walks, the
# shadow walks, the shading fetch, the atmosphere marches, nee_prepare and
# nee_finish, sample_bsdf, and the rest of the path's code.
PHASE_NAMES = (
    "camera_rng", "closest_walk", "shadow_walk", "shade_fetch", "atmosphere",
    "nee", "sample_bsdf", "other",
)

INT32_MAX = (1 << 31) - 1


def step_cap(scene) -> int:
    """Row visits one ray may make before a path kernel gives up on its
    sample: a bound, derived from the scene's tables, that no walk that ends
    can pass, so that abandoning a sample flags a broken table and nothing
    else. The wide tables when the scene carries them (the walk the kernels
    take then), else the binary ones.

    Why it bounds every walk that ends. A ray walks one TLAS and then, at
    most once each, the BLAS of every instance it enters: each instance sits
    in one TLAS leaf (one INST row of the mega-table, or one TLAS leaf node of
    nl8), and a tree walk reaches each leaf at most once (below). So it walks
    at most ``instances + 1`` trees.
      * Binary (``nl8``, csrc/binary_walk.cuh): a tree of ``count`` nodes is
        walked by its stackless accept/cancel links, which thread the nodes in
        one depth-first order per octant; a walk enters each node from its
        parent (accept) or from the subtree before it (cancel), once, so it
        reads at most ``count`` rows, and ``count`` is at most the nodes of
        all trees, ``nl8`` rows / 8 (each tree is stored once per octant).
      * Wide (``wide_rows``, accel/wide.py, csrc/wide_walk.cuh): a step reads
        the row of a cursor (row, start slot). Slots keep the octant's binary
        depth-first order and exits link to the depth-first successor, so a
        row is entered from its one parent slot (or predecessor's exit) at
        start slot 0 at most once per tree walk, and then resumed only at
        later slots (j + 1 after slot j's subtree). So a tree walk visits each
        cursor at most once: at most rows x slots steps.
    Hence (instances + 1) x nl8 nodes, or (instances + 1) x mega-table rows x
    slots, clipped to int32. A frame packer's mega-table (``wide_root_base``
    set, scene/device.DevicePacker) may be chunked (accel/chunks.py): there
    an instance has one INST row per chunk, and a ray walks a per-subframe
    TLAS, the static TLAS it exits into, and each INST row's tree at most
    once per TLAS walk; every INST row is a row, so its trees are at most
    rows + 2. tests/test_torch_wavefront.py holds the cap above the
    longest walk of the plain walks' ``lane_steps`` on the golden and the
    motion scene, both table kinds, and tests/test_torch_packer.py on the
    animated scene's chunked tables.
    """
    trees = scene.inst_u.shape[0] + 1
    if getattr(scene, "wide_rows", None) is not None:
        if getattr(scene, "wide_root_base", None) is not None:
            trees = scene.wide_rows.shape[0] + 2
        per_tree = scene.wide_rows.shape[0] * _layout_of(scene).n_slots
    else:
        per_tree = scene.nl8.shape[0] // 8
    return min(INT32_MAX, max(1, trees * per_tree))


# Launches of the kernel (timed and counting builds) and of its record build
# (K6) since the last reset: incremented where the kernel is launched and
# nowhere else, so a run can show that it went through it.
launches = 0
record_launches = 0


def reset_launches() -> None:
    global launches, record_launches
    launches = 0
    record_launches = 0


# The path kernels' designs, by their code in the kernels (csrc/path.cuh):
# the first (128 threads a block) and the wide block (512 threads, one block
# an SM).
DESIGNS = ("first", "wide")
# The design the path kernels (K2, K5, K6) take for each node table, by its
# row width (f32 per row: 0 is nl8, 48 / 88 / 40 the w8 / w16 / s8
# mega-tables). On the card (PERF.md) the wide block is faster on every
# mega-table and slower on nl8.
DESIGN_BY_WIDTH = {0: "first", 48: "wide", 88: "wide", 40: "wide"}


def design_code(width: int, design: str | None) -> int:
    """A path kernel's design code: the table's (``DESIGN_BY_WIDTH``) for
    None, else ``design``'s, "first" or "wide" (chip_smoke.py times both)."""
    name = DESIGN_BY_WIDTH[width] if design is None else design
    if name not in DESIGNS:
        raise ValueError(f"design={design!r}: None or one of {DESIGNS}")
    return DESIGNS.index(name)


def block_size(design: str = "first") -> int:
    """Threads per block of the built kernel in ``design``."""
    return int(LIBRARY.load().pt_megakernel_block_size(DESIGNS.index(design)))


def check_scene(scene, device):
    """Raise unless the scene's tables are what the kernel takes, on
    ``device``: the wide tables (as the wide ray-query kernel checks them),
    the packed shading rows, and the subframe tables with at least one row
    each. Returns the mega-table's layout."""
    f32, i32 = torch.float32, torch.int32
    lay = _check_wide(scene, device)
    if scene.tri_shade is None:
        raise ValueError("the scene carries no tri_shade rows: pack it with wide=True")
    _check("scene.tri_shade", scene.tri_shade, f32, (scene.tri_shade.shape[0], 48), device)
    _check("scene.sf_cam", scene.sf_cam, f32, (scene.sf_cam.shape[0], 18), device)
    _check("scene.sf_light", scene.sf_light, f32, (scene.sf_light.shape[0], 7), device)
    _check("scene.sf_tlas_offset", scene.sf_tlas_offset, i32,
           (scene.sf_tlas_offset.shape[0],), device)
    for name in ("sf_cam", "sf_light", "sf_tlas_offset"):
        if getattr(scene, name).shape[0] == 0:
            raise ValueError(f"scene.{name}: no subframe rows")
    return lay


def check_lights(scene, device) -> int:
    """The light tables' rows L, after checking them on ``device`` (0 for a
    scene without them; ValueError for a part of them): lt_tris (L, 9) f32,
    lt_rows and lt_cdf (L,), lt_seg and lt_rank 1-D int32, and the tri_idx /
    vattr tables the emission at a light point is read from."""
    from pathtracing_tpu_torch.ops.arealights import has_lights

    if not has_lights(scene):
        return 0
    f32, i32 = torch.float32, torch.int32
    L = scene.lt_tris.shape[0]
    if L == 0:
        raise ValueError("scene.lt_tris: no light rows")
    _check("scene.lt_tris", scene.lt_tris, f32, (L, 9), device)
    _check("scene.lt_rows", scene.lt_rows, i32, (L,), device)
    _check("scene.lt_cdf", scene.lt_cdf, f32, (L,), device)
    for name in ("lt_seg", "lt_rank"):
        t = getattr(scene, name)
        _check(f"scene.{name}", t, i32, (t.shape[0],), device)
    _check("scene.tri_idx", scene.tri_idx, i32, (scene.tri_idx.shape[0], 4), device)
    _check("scene.vattr", scene.vattr, f32, (scene.vattr.shape[0], 12), device)
    return L


def light_args(scene, n_lights: int) -> tuple:
    """The kernels' light arguments: the five lt_* pointers and L (nulls
    and 0 without light tables)."""
    ptr = lambda t: t.data_ptr() if n_lights else None
    return (ptr(scene.lt_tris), ptr(scene.lt_rows), ptr(scene.lt_cdf), ptr(scene.lt_seg),
            ptr(scene.lt_rank), n_lights)


def _int32(name, v) -> int:
    v = int(v)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"{name}={v} does not fit in int32")
    return v


class RecordPlanes(NamedTuple):
    """The record build's output: int32 planes of packed hits, pk = (inst <<
    2) | (back << 1) | hit, and prim ids: ``pk_p``, ``prim_p`` (n_items,) for
    the primary rays, ``pk_b``, ``prim_b`` (max_bounces * n_items,) for the
    bounce rays, and ``occ_b`` (max_bounces * n_items,) uint8 for the sun
    shadow rays; item k * n_pixels + slot is sample k of slot ``slot``. Rows
    a path never reached are 0 (csrc/path.cuh, ItemRecord)."""

    pk_p: torch.Tensor
    prim_p: torch.Tensor
    pk_b: torch.Tensor
    prim_b: torch.Tensor
    occ_b: torch.Tensor


def megakernel_cuda(
    config,
    scene,
    n_pixels: int,
    spp: int,
    sample_base: int = 0,
    pixel_base: int = 0,
    with_stats: bool = False,
    pixel_order=None,
    max_steps: int | None = None,
    counts: bool = False,
    phases: bool = False,
    _design: str | None = None,
):
    """Per-pixel radiance sums over samples [sample_base, sample_base + spp)
    of pixels pixel_base + [0, n_pixels) by the hand-written kernel.
    (``megakernel_record_cuda`` runs its record build.)

    ``pixel_order``: None, or an int32 CUDA tensor holding a permutation of
    [0, n_pixels): slot i then renders pixel pixel_base + pixel_order[i] (the
    output stays indexed by pixel). ``max_steps``: row visits per ray before
    a sample is abandoned (None: ``step_cap(scene)``).

    A scene with light tables runs the kernel's area-light instances.

    Instruments (chip_smoke.py): ``counts=True`` runs the counting build
    instead and also returns its counters (int64, COUNT_NAMES' order);
    ``phases=True`` the phase-cycle build (not with light tables), and
    returns its cycles per phase (int64, PHASE_NAMES' order) in that place.
    ``_design``: None (the layout's design, DESIGN_BY_WIDTH), or "first" or
    "wide" to time one design against the other; the counting build always
    runs the first.

    Returns (r, g, b, l2, n_truncated, counts): (n_pixels,) f32 sums, the
    luminance-squared sums or None, a one-element int32 tensor of abandoned
    samples, and the counters or None. Launches on PyTorch's current stream
    and does not synchronise. Raises on a tensor of the wrong device, dtype,
    shape or layout and on a refused launch; it never gives way to the plain
    version.
    """
    r, g, b, l2, n_trunc, cnt, _ = _launch(
        config, scene, n_pixels, spp, sample_base, pixel_base, with_stats, pixel_order,
        max_steps, counts, phases, _design, False)
    return r, g, b, l2, n_trunc, cnt


def megakernel_record_cuda(
    config,
    scene,
    n_pixels: int,
    spp: int,
    sample_base: int = 0,
    pixel_base: int = 0,
    max_steps: int | None = None,
    _design: str | None = None,
):
    """The record build (K6): the kernel's paths and sums, bit for bit, and
    each work item's hit topology. Slot i renders pixel pixel_base + i.
    ``_design`` as ``megakernel_cuda``'s.

    Returns (r, g, b, n_truncated, RecordPlanes). Launches on PyTorch's
    current stream and does not synchronise; raises as ``megakernel_cuda``
    does, and for more than 2**31 - 1 records."""
    r, g, b, _, n_trunc, _, planes = _launch(
        config, scene, n_pixels, spp, sample_base, pixel_base, False, None, max_steps,
        False, False, _design, True)
    return r, g, b, n_trunc, planes


def _launch(config, scene, n_pixels, spp, sample_base, pixel_base, with_stats,
            pixel_order, max_steps, counts, phases, design, record):
    global launches, record_launches
    device = scene.nl8.device
    if device.type != "cuda":
        raise ValueError(f"megakernel_cuda needs CUDA tensors, got {device}")
    lay = check_scene(scene, device)
    n_lights = check_lights(scene, device)
    if n_lights and record:
        raise NotImplementedError("the record build (K6) supports the sun-NEE path only, "
                                  "not area-light NEE (as in the JAX package)")
    if n_lights and phases:
        raise ValueError("the phase-cycle build has no area-light instance")
    if n_pixels < 0 or spp < 0:
        raise ValueError(f"n_pixels={n_pixels}, spp={spp}: both must be >= 0")
    if counts and phases:
        raise ValueError("counts and phases are two builds: ask for one")
    if pixel_order is not None:
        _check("pixel_order", pixel_order, torch.int32, (n_pixels,), device)
    steps = step_cap(scene) if max_steps is None else int(max_steps)
    if steps <= 0:
        raise ValueError(f"max_steps={steps}: must be > 0")
    code = 0 if counts else design_code(lay.w_row, design)

    f32 = torch.float32
    out = lambda: torch.empty(n_pixels, dtype=f32, device=device)
    r, g, b = out(), out(), out()
    l2 = out() if with_stats else None
    n_trunc = torch.zeros(1, dtype=torch.int32, device=device)
    lib = (LIT_LIBRARY if n_lights else LIBRARY).load()
    cnt = ph = None
    if counts:
        cnt = torch.zeros(lib.pt_megakernel_count_slots(), dtype=torch.int64, device=device)
        if cnt.numel() != len(COUNT_NAMES):
            raise RuntimeError(f"kernel counts {cnt.numel()} slots, COUNT_NAMES "
                               f"names {len(COUNT_NAMES)}")
    if phases:
        ph = torch.zeros(lib.pt_megakernel_phase_slots(), dtype=torch.int64, device=device)
        if ph.numel() != len(PHASE_NAMES):
            raise RuntimeError(f"kernel times {ph.numel()} phases, PHASE_NAMES "
                               f"names {len(PHASE_NAMES)}")
    planes = None
    if record:
        # zeroed: the kernel writes only the rows a path reaches
        n_items = n_pixels * spp
        _int32("records", max(1, config.max_bounces) * n_items)
        zeros = lambda k, dt=torch.int32: torch.zeros(k, dtype=dt, device=device)
        B = config.max_bounces
        planes = RecordPlanes(zeros(n_items), zeros(n_items), zeros(B * n_items),
                              zeros(B * n_items), zeros(B * n_items, torch.uint8))
    rec = planes if planes is not None else (None,) * 5
    # The launch is asynchronous; PyTorch's allocator hands a freed block out
    # again only in the order of the stream it was used on, and this is it.
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        err = lib.pt_megakernel(
            ptr(scene.wide_rows), scene.wide_rows.shape[1], ptr(scene.wide_root),
            ptr(scene.wide_root_base), ptr(scene.tri_pos), ptr(scene.inst_f),
            ptr(scene.inst_u), ptr(scene.tri_shade),
            ptr(scene.sf_cam), scene.sf_cam.shape[0],
            ptr(scene.sf_light), scene.sf_light.shape[0],
            ptr(scene.sf_tlas_offset), scene.sf_tlas_offset.shape[0],
            ptr(pixel_order), _int32("n_pixels", n_pixels), _int32("spp", spp),
            _int32("sample_base", sample_base), _int32("pixel_base", pixel_base),
            config.image_width, config.image_height, config.max_bounces,
            config.samples_per_motion_blur_step, _int32("student_id", config.student_id),
            c32(config.min_ray_dist), c32(config.max_ray_dist),
            c32(config.path_space_regularization_gamma), _int32("max_steps", steps),
            ptr(r), ptr(g), ptr(b), ptr(l2), ptr(n_trunc), ptr(cnt), ptr(ph), code,
            *map(ptr, rec), *light_args(scene, n_lights),
            ptr(scene.tri_idx) if n_lights else None, ptr(scene.vattr) if n_lights else None,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"megakernel launch refused: cudaError {err}")
    if n_pixels > 0:
        if record:
            record_launches += 1
        else:
            launches += 1
    return r, g, b, l2, n_trunc, ph if phases else cnt, planes
