"""Two-level BVH ray query: dispatch, shared helpers and the plain version.

Re-expresses the reference's incremental ray-query state machine
(reference: ray_query.hh:111-290). ``ray_query`` is the entry point: a scene
that carries the wide-BVH mega-table goes to ops/wide_traversal.py; otherwise
CUDA tensors go to the hand-written kernel (ops/cuda_traversal.py,
csrc/ray_query.cu), CPU tensors to ``ray_query_plain`` below.

``ray_query_plain`` is the plain PyTorch version of that kernel: every lane
carries one ray's traversal state (current node, BLAS context, shrinking
tmax, closest hit) and each pass of a Python ``while`` performs one node
visit per lane — slab test, stackless link follow, TLAS→BLAS descent, or
watertight triangle test — with finished lanes masked until all are done.
It runs on any device, serves the CPU tests and the on-card comparison, and
nothing on the render path uses it when a card is present. It asks the
device "all done?" once per step, which is fine for a plain version.

Semantics (confirm-all closest-hit, first-candidate any-hit, octant link
selection, tmax shrinking) are those of the JAX package's one-speed
``_full_step`` loop; that package's schedule knobs (two-speed loop,
compaction) change no result and are not carried here. A scene with bf16
node rows (``scene.nl5``, scene/device.with_bf16_nodes) is walked through
them, as the JAX walk reads them: the boxes are rounded outward, so a walk
visits a superset of the nodes, every closest hit stays bit-equal, and an
any-hit ray's ``occluded`` stays equal (its first passing triangle may be
another one).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.utils.vec import Vec3, cross, dot3, fabs3, where3

Array = Any

_LEAF_MASK = 0x7FFFFFFF
_BIG = float("inf")  # C writes 1e40 into a float => +inf


class RayHit(NamedTuple):
    """Closest-hit record (reference: ray_query.hh:24-35)."""

    thit: Array       # < 0 => miss
    bary_u: Array
    bary_v: Array
    bary_w: Array
    inst: Array       # int32; -1 (0xFFFFFFFF) => none
    prim: Array
    back: Array       # bool


def _safe_inv(d: Vec3) -> Vec3:
    """1/dir with zero components replaced (reference: ray_query.hh:130-133)."""
    return Vec3(
        torch.where(d.x == 0, _BIG, 1.0 / d.x),
        torch.where(d.y == 0, _BIG, 1.0 / d.y),
        torch.where(d.z == 0, _BIG, 1.0 / d.z),
    )


def _octant(d: Vec3) -> Array:
    """Link-table selector from direction signs (reference: ray_query.hh:135-138)."""
    return (
        (d.x > 0).to(torch.int32)
        + (d.y > 0).to(torch.int32) * 2
        + (d.z > 0).to(torch.int32) * 4
    )


def _tri_preprocess(d: Vec3):
    """Woop max-axis permutation + shear constants
    (reference: math.hh:340-356). Returns (axis int32, S Vec3)."""
    a = fabs3(d)
    is0 = torch.logical_and(a.x > a.y, a.x > a.z)
    is1 = torch.logical_and(torch.logical_not(is0), a.y > a.z)
    two = torch.full_like(d.x, 2, dtype=torch.int32)
    axis = torch.where(is0, 0, torch.where(is1, 1, two))
    rdir = Vec3(
        torch.where(is0, d.z, d.x),
        torch.where(is1, d.z, d.y),
        torch.where(is0, d.x, torch.where(is1, d.y, d.z)),
    )
    inv_z = 1.0 / rdir.z
    return axis, Vec3(rdir.x * inv_z, rdir.y * inv_z, torch.ones_like(inv_z) * inv_z)


def _tri_intersect(origin: Vec3, axis, S: Vec3, p0: Vec3, p1: Vec3, p2: Vec3):
    """Watertight ray-triangle test (reference: math.hh:358-401).

    Returns (hit bool, u, v, t, back_face bool).
    """
    A = p0 - origin
    B = p1 - origin
    C = p2 - origin
    x = Vec3(A.x, B.x, C.x)
    y = Vec3(A.y, B.y, C.y)
    z = Vec3(A.z, B.z, C.z)
    is0 = axis == 0
    is1 = axis == 1
    x2 = where3(is0, z, x)
    y2 = where3(is1, z, y)
    z2 = where3(is0, x, where3(is1, y, z))
    x3 = x2 - z2 * S.x
    y3 = y2 - z2 * S.y
    uvw = cross(y3, x3)
    det = uvw.x + uvw.y + uvw.z
    # guarded reciprocal: det==0 lanes are rejected by `hit` anyway
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    u = uvw.x * inv_det
    v = uvw.y * inv_det
    t = dot3(uvw, z2 * S.z) * inv_det
    back = det < 0
    back = torch.logical_xor(back, S.z < 0)
    back = torch.logical_xor(back, axis != 2)
    all_pos = (uvw.x >= 0) & (uvw.y >= 0) & (uvw.z >= 0)
    all_neg = (uvw.x <= 0) & (uvw.y <= 0) & (uvw.z <= 0)
    hit = (det != 0) & (t >= 0) & (all_pos | all_neg)
    return hit, u, v, t, back


class _TravState(NamedTuple):
    # TLAS context (origin/dir/inv are loop-invariant, kept outside)
    t_node: Array
    # BLAS context
    in_blas: Array
    b_node: Array
    b_count: Array
    b_link_offset: Array
    b_org_x: Array
    b_org_y: Array
    b_org_z: Array
    b_inv_x: Array
    b_inv_y: Array
    b_inv_z: Array
    b_S_x: Array
    b_S_y: Array
    b_S_z: Array
    b_axis: Array
    m_tri_offset: Array
    cand_inst: Array
    # query state
    done: Array
    tmax: Array
    occluded: Array
    # closest hit: ids only. thit needs no slot of its own — every closest
    # confirm writes the same value into tmax (reference:
    # ray_query.hh:289), so final thit == tmax bit-exactly; (u, v, back)
    # are re-derived from the ids by one post-loop triangle test
    # (_finalize_hit).
    c_inst: Array
    c_prim: Array


def _slab_hit(nmin: Vec3, nmax: Vec3, org: Vec3, inv: Vec3, tmin, tmax):
    """AABB slab test with C fmin/fmax NaN semantics
    (reference: ray_query.hh:197-207). NaNs do occur (0 * inf from
    _safe_inv), so this is torch.fmin/fmax, never minimum/maximum."""
    t0x = (nmin.x - org.x) * inv.x
    t0y = (nmin.y - org.y) * inv.y
    t0z = (nmin.z - org.z) * inv.z
    t1x = (nmax.x - org.x) * inv.x
    t1y = (nmax.y - org.y) * inv.y
    t1z = (nmax.z - org.z) * inv.z
    near = torch.fmax(
        torch.fmin(t0x, t1x), torch.fmax(torch.fmin(t0y, t1y), torch.fmin(t0z, t1z))
    )
    far = torch.fmin(
        torch.fmax(t0x, t1x), torch.fmin(torch.fmax(t0y, t1y), torch.fmax(t0z, t1z))
    )
    return (near <= far) & (far > tmin) & (near < tmax)


def _read_node(scene, lidx):
    """One fused row gather for a node visit: AABB + accept/cancel links.

    Reads the bf16 rows (``scene.nl5``, 20 B; scene/device.pack_nl5) when
    the scene carries them, else the f32 ``nl8`` (32 B). A bf16 half is the
    high 16 bits of an f32, so it unpacks by a mask (the high half) or a
    shift (the low one) of the word's bits. The links are int32 bit patterns
    stored in float columns; they are bit-viewed from a contiguous copy,
    never converted."""
    if scene.nl5 is not None:
        words = scene.nl5[lidx].contiguous().view(torch.int32)  # (R, 5)
        hi = (words[:, 0:3] & -65536).view(torch.float32)
        lo = (words[:, 0:3] << 16).view(torch.float32)
        nmin = Vec3(hi[:, 0], lo[:, 0], hi[:, 1])
        nmax = Vec3(lo[:, 1], hi[:, 2], lo[:, 2])
        return nmin, nmax, words[:, 3], words[:, 4]
    row = scene.nl8[lidx]  # (R, 8)
    nmin = Vec3(row[:, 0], row[:, 1], row[:, 2])
    nmax = Vec3(row[:, 3], row[:, 4], row[:, 5])
    links = row[:, 6:8].contiguous().view(torch.int32)
    return nmin, nmax, links[:, 0], links[:, 1]


def _node_sectors(scene, lidx):
    """The first and last 32 B sector of the node table that row ``lidx``
    spans, by its offset in the table: an nl8 row is one sector, an nl5 row
    of 20 B straddles two when it crosses a 32 B boundary (4 rows in 8)."""
    if scene.nl5 is None:
        return lidx, lidx
    b = lidx.to(torch.int64) * 20
    return b // 32, (b + 19) // 32


class _TravConsts(NamedTuple):
    """Per-ray loop-invariant inputs."""

    tlas_count: Array
    tlas_offset: Array
    t_link_offset: Array
    org: Vec3
    d: Vec3
    t_inv: Vec3


class RayQueryCounts(NamedTuple):
    """Table rows one query read, summed over its rays (one node row, nl8
    or nl5, per node visit, one inst_f + inst_u row per BLAS entry and per
    finalized hit, one tri_pos row per triangle test and per finalized hit);
    the distinct rows of each table the batch read (what the card has to
    move at the least); the 32 B sectors of the node table the visits span
    (``node_sectors``: one a visit on nl8, one or two on nl5) and the
    distinct sectors the batch touched; and the node visits of each lane
    (``lane_steps``, int32 (R,), 0 for an inactive lane: what
    ``simd_efficiency`` reads)."""

    node_rows: int
    inst_rows: int
    tri_rows: int
    node_rows_touched: int
    inst_rows_touched: int
    tri_rows_touched: int
    node_sectors: int
    node_sectors_touched: int
    lane_steps: Array


class _Counters(NamedTuple):
    totals: Array        # int64 (4,): node visits, BLAS entries, triangle
                         # tests, node sectors visited
    lane_steps: Array    # int32 (R,): node visits per lane
    node_touched: Array  # bool per nl8 row
    inst_touched: Array  # bool per instance
    tri_touched: Array   # bool per tri_pos row


def simd_efficiency(lane_steps, width: int = 32) -> tuple[float, float]:
    """Share of a SIMD group's lane-steps that do work when each group of
    ``width`` lanes runs as long as its longest lane: sum of steps / (width x
    sum over groups of the group's most steps). Returns (groups in launch
    order, groups with the lanes that walked packed first, in order). An
    inactive lane walks no step, so the second is the share a launch that
    packed the active rays could reach without reordering them."""
    steps = torch.as_tensor(lane_steps).to(torch.int64).flatten()

    def eff(x):
        if int(x.sum()) == 0:
            return 0.0
        pad = (-x.numel()) % width
        x = torch.cat([x, x.new_zeros(pad)]).view(-1, width)
        return float(x.sum()) / (width * float(x.amax(dim=1).sum()))

    return eff(steps), eff(steps[steps > 0])


def _instance_ray(fi, org: Vec3, d: Vec3):
    """Ray into instance space by the inverse transform's columns
    (reference: ray_query.hh:159-165)."""
    bo = Vec3(
        fi[:, 0] * org.x + fi[:, 3] * org.y + fi[:, 6] * org.z + fi[:, 9],
        fi[:, 1] * org.x + fi[:, 4] * org.y + fi[:, 7] * org.z + fi[:, 10],
        fi[:, 2] * org.x + fi[:, 5] * org.y + fi[:, 8] * org.z + fi[:, 11],
    )
    bd = Vec3(
        fi[:, 0] * d.x + fi[:, 3] * d.y + fi[:, 6] * d.z,
        fi[:, 1] * d.x + fi[:, 4] * d.y + fi[:, 7] * d.z,
        fi[:, 2] * d.x + fi[:, 5] * d.y + fi[:, 8] * d.z,
    )
    return bo, bd


def _tri_vertices(tp):
    return (
        Vec3(tp[:, 0], tp[:, 1], tp[:, 2]),
        Vec3(tp[:, 3], tp[:, 4], tp[:, 5]),
        Vec3(tp[:, 6], tp[:, 7], tp[:, 8]),
    )


# The walk is discrete: it runs outside the autograd graph, with no
# gradient into or out of it (the JAX package's stop_gradient on
# traversal). shade_hit re-derives (u, v, t) differentiably.
@torch.no_grad()
def ray_query(
    scene,
    tlas_count: Array,
    tlas_offset: Array,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active: Array,
    anyhit: bool | Array = False,
    max_steps: int | None = None,
    return_state: bool = False,
):
    """Trace a batch of rays to completion.

    scene: SceneDevice (scene/device.py). tlas_count/offset: per-ray TLAS
    handles (int32). active: lanes that should trace at all.
    Closest-hit mode confirms every candidate (reference:
    path_tracer.hh:346-349); anyhit stops a lane at its first passing
    candidate (reference: path_tracer.hh:415-427). anyhit may be a per-lane
    bool tensor so one batch can mix shadow and closest-hit rays.
    Returns (RayHit, occluded).

    A scene packed with ``wide=True`` (``scene.wide_rows`` set) is walked
    through its mega-table (ops/wide_traversal.wide_ray_query), any other
    through the binary tables. Tensors on a CUDA device launch the kernel
    (or raise — there is no way from here to the plain version for them);
    tensors on the CPU take the plain version.

    The bounded walk (the JAX package's ``max_steps`` / ``return_state``):
    either argument takes the binary walk, on a wide scene too. A lane stops
    after ``max_steps`` steps of the one-speed loop, a step being one pass
    of ``_full_step``: a node visit, a pop from an exhausted BLAS back to
    the TLAS, or the end of an exhausted TLAS. ``return_state=True``
    returns the walk's ``_TravState`` in place of (RayHit, occluded);
    without it a bounded run returns the hit finalized from the bounded
    state. These are the states of JAX's one-speed run (``leaf_every=None,
    compact_after=None``, the setting of its tools); JAX's default
    two-speed loop also parks a pending triangle candidate in its bounded
    state (``p_prim``), which the port, having no two-speed loop, does not
    have.
    """
    bounded = max_steps is not None or return_state
    if scene.wide_rows is not None and not bounded:
        from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query

        return wide_ray_query(
            scene, tlas_count, tlas_offset, org, d, tmin, tmax0, active, anyhit
        )
    if org.x.is_cuda:
        from pathtracing_tpu_torch.ops.cuda_traversal import ray_query_cuda

        return ray_query_cuda(
            scene, tlas_count, tlas_offset, org, d, tmin, tmax0, active, anyhit,
            max_steps=max_steps, return_state=return_state,
        )
    return ray_query_plain(
        scene, tlas_count, tlas_offset, org, d, tmin, tmax0, active, anyhit,
        max_steps=max_steps, return_state=return_state,
    )


@torch.no_grad()
def ray_query_plain(
    scene,
    tlas_count: Array,
    tlas_offset: Array,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active: Array,
    anyhit: bool | Array = False,
    return_counts: bool = False,
    max_steps: int | None = None,
    return_state: bool = False,
):
    """The plain PyTorch version of the ray-query kernel; same contract as
    ``ray_query``, on whatever device the tensors lie (``max_steps`` /
    ``return_state`` as there). ``return_counts`` additionally returns the
    RayQueryCounts of this batch (not with ``return_state``)."""
    if return_counts and return_state:
        raise ValueError("return_counts with return_state: take one")
    R = org.x.shape
    dev = org.x.device
    tmin = float(tmin)
    tmax0 = torch.broadcast_to(
        torch.as_tensor(tmax0, dtype=torch.float32, device=dev), R
    )
    if isinstance(anyhit, torch.Tensor):
        anyhit = anyhit.to(torch.bool)

    consts = make_consts(tlas_count, tlas_offset, org, d)
    state = init_state(R, active, tmax0, dev)
    if scene.nl8.shape[0] == 0:
        # no node rows (a geometry shard without instances: a 0-node TLAS
        # in every subframe): every lane exhausts at its first step, as in
        # the kernel's walk, and there is no row to read
        state = state._replace(done=torch.ones_like(state.done))
    counts = None
    if return_counts:
        flags = lambda t: torch.zeros(t.shape[0], dtype=torch.bool, device=dev)
        counts = _Counters(
            torch.zeros(4, dtype=torch.int64, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
            flags(scene.nl8), flags(scene.inst_f), flags(scene.tri_pos),
        )
    steps = 0
    while not bool(state.done.all()) and (max_steps is None or steps < max_steps):
        state = _full_step(scene, state, consts, tmin, anyhit, counts)
        steps += 1
    if return_state:
        return state
    hit = _finalize_hit(scene, consts, state)
    if return_counts:
        # the finalize step reads the hit's instance and triangle rows
        h = state.c_inst >= 0
        inst = state.c_inst[h].long()
        counts.inst_touched[inst] = True
        counts.tri_touched[scene.inst_u[inst, 4].long() + state.c_prim[h].long()] = True
        n_hit = int(h.sum())
        c = counts.totals.tolist()
        first, last = _node_sectors(scene, counts.node_touched.nonzero()[:, 0])
        return hit, state.occluded, RayQueryCounts(
            c[0], c[1] + n_hit, c[2] + n_hit,
            int(counts.node_touched.sum()), int(counts.inst_touched.sum()),
            int(counts.tri_touched.sum()), c[3],
            int(torch.cat([first, last]).unique().numel()), counts.lane_steps,
        )
    return hit, state.occluded


def _finalize_hit(scene, consts, s: "_TravState") -> RayHit:
    """Materialize the RayHit from the slim carry (ids + tmax).

    thit is exactly tmax for hit lanes (every closest confirm wrote the
    same tt into both, reference: ray_query.hh:289). (u, v, back) are
    re-derived by one triangle test from the hit ids — the same
    fixed-topology recomputation the integrator's shade_hit performs.
    """
    hitm = s.c_inst >= 0
    iidx = torch.where(hitm, s.c_inst, 0)
    fi = scene.inst_f[iidx]
    ui = scene.inst_u[iidx]
    bo, bd = _instance_ray(fi, consts.org, consts.d)
    baxis, bS = _tri_preprocess(bd)
    tri_row = torch.where(hitm, ui[:, 4] + s.c_prim, 0)
    tp = scene.tri_pos[tri_row]
    _, tu, tv, _, tback = _tri_intersect(bo, baxis, bS, *_tri_vertices(tp))
    zero = torch.zeros_like(s.tmax)
    tu = torch.where(hitm, tu, zero)
    tv = torch.where(hitm, tv, zero)
    return RayHit(
        thit=torch.where(hitm, s.tmax, -1.0),
        bary_u=tu,
        bary_v=tv,
        bary_w=1.0 - tu - tv,
        inst=s.c_inst,
        prim=torch.where(hitm, s.c_prim, 0),
        back=hitm & tback,
    )


def init_state(R, active, tmax0, device) -> _TravState:
    """Fresh traversal state (reference: ray_query.hh:121-150)."""
    i32 = lambda v: torch.full(R, v, dtype=torch.int32, device=device)
    f32 = lambda v: torch.full(R, v, dtype=torch.float32, device=device)
    return _TravState(
        t_node=i32(0),
        in_blas=torch.zeros(R, dtype=torch.bool, device=device),
        b_node=i32(0),
        b_count=i32(0),
        b_link_offset=i32(0),
        b_org_x=f32(0), b_org_y=f32(0), b_org_z=f32(0),
        b_inv_x=f32(0), b_inv_y=f32(0), b_inv_z=f32(0),
        b_S_x=f32(0), b_S_y=f32(0), b_S_z=f32(0),
        b_axis=i32(2),
        m_tri_offset=i32(0),
        cand_inst=i32(-1),
        done=torch.logical_not(active),
        tmax=tmax0,
        occluded=torch.zeros(R, dtype=torch.bool, device=device),
        c_inst=i32(-1),
        c_prim=i32(0),
    )


def make_consts(tlas_count, tlas_offset, org, d) -> "_TravConsts":
    t_inv = _safe_inv(d)
    return _TravConsts(
        tlas_count=tlas_count,
        tlas_offset=tlas_offset,
        t_link_offset=tlas_offset * 8 + _octant(d) * tlas_count,
        org=org,
        d=d,
        t_inv=t_inv,
    )


def _full_step(scene, s, consts, tmin, anyhit, counts=None):
    """One node visit per lane. Every gather index is guarded with
    ``where(valid, idx, 0)``: an out-of-range index raises in PyTorch."""
    tlas_count = consts.tlas_count
    t_link_offset = consts.t_link_offset
    org = consts.org
    d = consts.d
    t_inv = consts.t_inv

    count = torch.where(s.in_blas, s.b_count, tlas_count)
    node_idx = torch.where(s.in_blas, s.b_node, s.t_node)
    link_off = torch.where(s.in_blas, s.b_link_offset, t_link_offset)

    not_done = torch.logical_not(s.done)
    in_range = (node_idx >= 0) & (node_idx < count)
    valid = in_range & not_done
    exhausted = torch.logical_not(in_range) & not_done
    # TLAS exhausted => done; BLAS exhausted => pop to TLAS
    # (reference: ray_query.hh:271-275).
    done = s.done | (exhausted & torch.logical_not(s.in_blas))
    in_blas = s.in_blas & torch.logical_not(exhausted)

    lidx = torch.where(valid, link_off + node_idx, 0)
    nmin, nmax, accept, cancel = _read_node(scene, lidx)

    o = where3(in_blas, Vec3(s.b_org_x, s.b_org_y, s.b_org_z), org)
    inv = where3(in_blas, Vec3(s.b_inv_x, s.b_inv_y, s.b_inv_z), t_inv)

    hit = _slab_hit(nmin, nmax, o, inv, tmin, s.tmax)
    is_leaf = accept < 0  # top bit set (reference: bvh.hh:57-63)
    payload = accept & _LEAF_MASK
    next_idx = torch.where(hit & torch.logical_not(is_leaf), accept, cancel)

    t_node = torch.where(valid & torch.logical_not(in_blas), next_idx, s.t_node)
    b_node = torch.where(valid & in_blas, next_idx, s.b_node)

    leaf_hit = valid & hit & is_leaf
    enter = leaf_hit & torch.logical_not(in_blas)
    test = leaf_hit & in_blas

    # ---- enter BLAS (reference: ray_query.hh:153-182) ----
    iidx = torch.where(enter, payload, 0)
    fi = scene.inst_f[iidx]  # (R, 21): inv cols (12) + rot (9)
    ui = scene.inst_u[iidx]  # (R, 6)
    bo, bd = _instance_ray(fi, org, d)
    binv = _safe_inv(bd)
    boct = _octant(bd)
    baxis, bS = _tri_preprocess(bd)
    blink = ui[:, 1] * 8 + boct * ui[:, 0]

    def upd(old, new):
        return torch.where(enter, new, old)

    b_count = upd(s.b_count, ui[:, 0])
    m_tri_offset = upd(s.m_tri_offset, ui[:, 4])
    b_link_offset = upd(s.b_link_offset, blink)
    b_org = where3(enter, bo, Vec3(s.b_org_x, s.b_org_y, s.b_org_z))
    b_inv = where3(enter, binv, Vec3(s.b_inv_x, s.b_inv_y, s.b_inv_z))
    b_S = where3(enter, bS, Vec3(s.b_S_x, s.b_S_y, s.b_S_z))
    b_axis = upd(s.b_axis, baxis)
    b_node = torch.where(enter, 0, b_node)
    cand_inst = upd(s.cand_inst, payload)
    in_blas = in_blas | enter

    # ---- triangle test (reference: ray_query.hh:225-246) ----
    tri_row = torch.where(test, m_tri_offset + payload, 0)
    tp = scene.tri_pos[tri_row]  # (R, 12)
    thit_ok, _, _, tt, _ = _tri_intersect(b_org, b_axis, b_S, *_tri_vertices(tp))
    confirmed = test & thit_ok & (tt < s.tmax) & (tt > tmin)

    if anyhit is True:
        occluded = s.occluded | confirmed
        done = done | confirmed
        c_inst, c_prim = s.c_inst, s.c_prim
        tmax = s.tmax
    else:
        # confirm every candidate (reference: path_tracer.hh:346-349,
        # ray_query.hh:280-290); a per-lane anyhit mask splits the confirm
        # set into occlusion lanes and closest-hit lanes
        if anyhit is False:
            cfm_any = torch.zeros_like(confirmed)
            cfm_cl = confirmed
        else:
            cfm_any = confirmed & anyhit
            cfm_cl = confirmed & torch.logical_not(anyhit)
        occluded = s.occluded | cfm_any
        done = done | cfm_any
        c_inst = torch.where(cfm_cl, cand_inst, s.c_inst)
        c_prim = torch.where(cfm_cl, payload, s.c_prim)
        tmax = torch.where(cfm_cl, tt, s.tmax)

    if counts is not None:
        # in place: small running totals, no new tensor per step
        first, last = _node_sectors(scene, lidx)
        counts.totals.add_(torch.stack([
            valid.sum(), enter.sum(), test.sum(),
            valid.sum() + (valid & (first != last)).sum()]))
        counts.lane_steps.add_(valid)
        counts.node_touched[lidx[valid].long()] = True
        counts.inst_touched[payload[enter].long()] = True
        counts.tri_touched[tri_row[test].long()] = True

    return _TravState(
        t_node=t_node,
        in_blas=in_blas,
        b_node=b_node,
        b_count=b_count,
        b_link_offset=b_link_offset,
        b_org_x=b_org.x, b_org_y=b_org.y, b_org_z=b_org.z,
        b_inv_x=b_inv.x, b_inv_y=b_inv.y, b_inv_z=b_inv.z,
        b_S_x=b_S.x, b_S_y=b_S.y, b_S_z=b_S.z,
        b_axis=b_axis,
        m_tri_offset=m_tri_offset,
        cand_inst=cand_inst,
        done=done,
        tmax=tmax,
        occluded=occluded,
        c_inst=c_inst,
        c_prim=c_prim,
    )
