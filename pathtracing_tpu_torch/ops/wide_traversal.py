"""Mega-table wide-BVH ray query: dispatch and the plain version.

Counterpart of the JAX package's ``ops/wide_traversal.py`` (accel/wide.py has
the layout and the bit-exactness argument). ``wide_ray_query`` is the entry
point for scenes packed with ``wide=True``: CUDA tensors go to the
hand-written kernel (ops/cuda_wide_traversal.py, csrc/wide_ray_query.cu),
CPU tensors to ``wide_ray_query_plain`` below.

Every step reads exactly ONE row of the unified (M, w_row) table and
branches on the cursor's kind tag:

  WIDE: slab-test S bf16-conservative child slots at once (reference
        semantics per slot: ray_query.hh:193-207), descend to the first
        accepted slot at or after the cursor's start slot, else follow the
        row's static exit link (the octant-DFS successor);
  LEAF: run the exact watertight test on L inlined triangles (reference:
        math.hh:358-401, confirm rules ray_query.hh:280-290) and fold the
        batch winner into the closest hit / occlusion flag;
  INST: TLAS->BLAS descent (reference: ray_query.hh:153-182): transform the
        ray by the inlined inverse transform, pick the per-octant BLAS
        entry link.

``wide_ray_query_plain`` is the plain PyTorch version of the kernel: every
lane carries one ray's state and each pass of a Python ``while`` performs one
row visit per lane, finished lanes masked, until no lane is alive. It is the
JAX package's one-speed walk (``leaf_every=None``, no compaction). That
package's two-speed parking and staged lane compaction are schedules of a
SIMD loop that its own tests prove result-invariant; a thread leaves its own
loop on the card, so ``wide_ray_query`` takes neither knob. The JAX walk's
hot advances (``_wide_cheap_step(hot=True)``, its rows fetched by the
bit-exact one-hot matmul ``_onehot_row``) read rows [0, H) of a
hot-permuted table (scene/device.DevicePacker(hot_rows=)) from a copy of
them; here every row, hot or not, is the plain row gather from
``wide_rows``, which holds the same bits, so a hot-permuted scene walks
unchanged.

Cursors, links, prim ids and the instance id are uint32/int32 bit patterns
stored in float columns. Here they are **int32** tensors holding the same
bits (ops/rng.py's convention): kind 2 and the sentinels are negative, so a
link is selected with ``take_along_dim`` (never a max over a masked row),
right shifts are masked, and sentinels are compared as int32 bit patterns.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.accel.wide import (
    END_BLAS,
    END_TLAS,
    LAYOUTS_BY_WIDTH,
    RETURN_SENTINEL,
)
from pathtracing_tpu_torch.ops.traversal import (
    _finalize_hit,
    _instance_ray,
    _octant,
    _safe_inv,
    _tri_intersect,
    _tri_preprocess,
    _tri_vertices,
    make_consts,
)
from pathtracing_tpu_torch.utils.vec import Vec3, where3

Array = Any


def _i32(u) -> int:
    """A uint32 bit pattern as the int32 value with the same bits."""
    u = int(u)
    return u - (1 << 32) if u >= (1 << 31) else u


_END_TLAS = _i32(END_TLAS)
_END_BLAS = _i32(END_BLAS)
_RETURN = _i32(RETURN_SENTINEL)
_INVALID = -1            # 0xFFFFFFFF: an empty slot's link
_HI16 = _i32(0xFFFF0000)


def _layout_of(scene):
    """Recover the WideLayout from the mega table's row width."""
    width = scene.wide_rows.shape[1]
    if width not in LAYOUTS_BY_WIDTH:
        raise ValueError(
            f"wide_rows has {width} columns; the shipped layouts have "
            f"{sorted(LAYOUTS_BY_WIDTH)}"
        )
    return LAYOUTS_BY_WIDTH[width]


def root_cursor(scene, tlas_offset, oct_):
    """Per-lane TLAS root cursor (int32 bits): wide_root is indexed by
    tlas_offset - wide_root_base (no base for one-shot packs; a frame packer
    ships a tail-only table)."""
    idx = tlas_offset
    if scene.wide_root_base is not None:
        idx = idx - scene.wide_root_base
    return scene.wide_root[idx.long(), oct_.long()]


class _WideTravState(NamedTuple):
    cursor: Array        # int32 bits of the uint32 mega-table cursor
    inst_resume: Array   # TLAS continuation while inside a BLAS
    leaf_resume: Array   # wide continuation while in a leaf chain
    in_blas: Array       # bool
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
    cand_inst: Array
    done: Array
    tmax: Array
    occluded: Array
    c_inst: Array
    c_prim: Array


class WideQueryCounts(NamedTuple):
    """Table rows one query read, summed over its rays: mega-table rows by
    kind, slab tests the WIDE visits needed (slots at or after the cursor's
    start slot whose link is not the empty one), triangle tests made in LEAF
    rows (non-empty candidates), ``tri_pos`` rows read for them (stub layouts
    only: one per test), finalized hits (each reads one ``inst_f``, one
    ``inst_u`` and one ``tri_pos`` row), the distinct mega-table rows the
    batch visited; then the visits of each mega-table row (``row_visits``,
    int64 (M,)) and the row visits of each lane (``lane_steps``, int32 (R,),
    0 for an inactive lane: what ``ops/traversal.simd_efficiency`` reads)."""

    wide_rows: int
    leaf_rows: int
    inst_rows: int
    tri_tests: int
    stub_tri_rows: int
    hits: int
    slab_tests: int
    rows_touched: int
    row_visits: Array
    lane_steps: Array


def _f32_bits(bits):
    return bits.view(torch.float32)


def _unpack_bf16_hi(bits):
    return _f32_bits(bits & _HI16)


def _unpack_bf16_lo(bits):
    # the low half moved up; the int32 shift wraps to the uint32 bits
    return _f32_bits((bits & 0xFFFF) << 16)


class _Counters(NamedTuple):
    totals: Array      # int64 (5,): WIDE, LEAF, INST rows, triangle tests, slab tests
    row_visits: Array  # int64 (M,): visits per mega-table row so far
    lane_steps: Array  # int32 (R,): row visits per lane so far


def _leaf_block(scene, lay, row, rbits, s, tmin, mask, counts):
    """The L-triangle exact-test block of a LEAF row. Reproduces the
    sequential confirm semantics: each passing candidate shrinks tmax before
    the next is judged, winner = min-t with first-index tie-break
    (reference: ray_query.hh:280-290, path_tracer.hh:346-349).

    Stub layouts store prim ids only; vertices come from scene.tri_pos via
    the per-instance triangle base (inst_u col 4)."""
    prims = rbits[:, lay.prims_col : lay.prims_col + lay.leaf_tris]
    if lay.stub:
        tri_base = scene.inst_u[torch.clamp(s.cand_inst, min=0).long(), 4]
    b_org = Vec3(s.b_org_x, s.b_org_y, s.b_org_z)
    b_S = Vec3(s.b_S_x, s.b_S_y, s.b_S_z)
    best_t = torch.full_like(s.tmax, float("inf"))
    best_prim = torch.zeros_like(s.c_prim)
    any_ok = torch.zeros_like(mask)
    new_tmax = s.tmax
    for k in range(lay.leaf_tris):
        pk = prims[:, k]
        fetch = mask & (pk >= 0)
        if counts is not None:
            counts.totals[3] += fetch.sum()
        if lay.stub:
            v = scene.tri_pos[torch.where(fetch, tri_base + pk, 0).long()]
        else:
            v = row[:, 9 * k : 9 * k + 9]
        ok, _, _, tt, _ = _tri_intersect(b_org, s.b_axis, b_S, *_tri_vertices(v))
        ok = ok & (tt < new_tmax) & (tt > tmin) & (pk >= 0) & mask
        take = ok & (tt < best_t)
        best_t = torch.where(take, tt, best_t)
        best_prim = torch.where(take, pk, best_prim)
        new_tmax = torch.where(ok, tt, new_tmax)
        any_ok = any_ok | ok
    return any_ok, best_prim, new_tmax


def _wide_step(scene, lay, s: _WideTravState, consts, tmin, anyhit, counts=None):
    """One row visit per lane. Gather indices are guarded with
    ``where(valid, idx, 0)``: an out-of-range index raises in PyTorch."""
    S = lay.n_slots
    i32 = torch.int32

    # ---- sentinel resolution (before the row read) ----
    cur = s.cursor
    done = s.done | (cur == _END_TLAS)
    popped = torch.logical_not(s.done) & (cur == _END_BLAS)
    cur = torch.where(popped, s.inst_resume, cur)
    in_blas = s.in_blas & torch.logical_not(popped)

    kind = (cur >> 30) & 3
    valid = torch.logical_not(done)
    row_id = (cur >> lay.slot_bits) & int(lay.row_mask)
    row = scene.wide_rows[torch.where(valid, row_id, 0).long()]  # (R, W)
    rbits = row.view(i32)

    is_wide = valid & (kind == 0)
    is_leaf = valid & (kind == 1)
    is_inst = valid & (kind == 2)

    org = where3(in_blas, Vec3(s.b_org_x, s.b_org_y, s.b_org_z), consts.org)
    inv = where3(in_blas, Vec3(s.b_inv_x, s.b_inv_y, s.b_inv_z), consts.t_inv)

    # =============== WIDE: S-slot slab test =========================
    start = cur & (S - 1)
    c0 = rbits[:, 0 : 3 * S : 3]   # (R, S): [minx|miny]
    c1 = rbits[:, 1 : 3 * S : 3]   # [minz|maxx]
    c2 = rbits[:, 2 : 3 * S : 3]   # [maxy|maxz]
    ox, oy, oz = org.x[:, None], org.y[:, None], org.z[:, None]
    ix, iy, iz = inv.x[:, None], inv.y[:, None], inv.z[:, None]
    t0x = (_unpack_bf16_hi(c0) - ox) * ix
    t0y = (_unpack_bf16_lo(c0) - oy) * iy
    t0z = (_unpack_bf16_hi(c1) - oz) * iz
    t1x = (_unpack_bf16_lo(c1) - ox) * ix
    t1y = (_unpack_bf16_hi(c2) - oy) * iy
    t1z = (_unpack_bf16_lo(c2) - oz) * iz
    # C fmin/fmax NaN semantics: an empty slot is (+inf, -inf) and 0 * inf
    # occurs
    near = torch.fmax(
        torch.fmin(t0x, t1x), torch.fmax(torch.fmin(t0y, t1y), torch.fmin(t0z, t1z))
    )
    far = torch.fmin(
        torch.fmax(t0x, t1x), torch.fmin(torch.fmax(t0y, t1y), torch.fmax(t0z, t1z))
    )
    tmin_b = tmin[:, None] if isinstance(tmin, torch.Tensor) else tmin
    slot_hit = (near <= far) & (far > tmin_b) & (near < s.tmax[:, None])

    links = rbits[:, lay.links_col : lay.links_col + S]      # (R, S)
    iota = torch.arange(S, dtype=i32, device=cur.device)[None, :]
    slot_ok = slot_hit & (iota >= start[:, None]) & (links != _INVALID)
    j = torch.where(slot_ok, iota, S).amin(dim=1)            # (R,) int32
    found = is_wide & (j < S)
    target = torch.take_along_dim(
        links, torch.clamp(j, max=S - 1).long()[:, None], dim=1
    )[:, 0]
    tkind = (target >> 30) & 3
    exit_link = rbits[:, lay.exit_col]
    # resume cursor for leaf/inst descents: this row at slot j+1, or the
    # row's exit when j was the last slot
    resume = torch.where(j < S - 1, (cur & ~(S - 1)) + (j + 1), exit_link)
    wide_next = torch.where(found, target, exit_link)

    # =============== INST: enter BLAS ================================
    bo, bd = _instance_ray(row, consts.org, consts.d)
    binv = _safe_inv(bd)
    boct = _octant(bd)
    baxis, bS = _tri_preprocess(bd)
    blas_entry = torch.take_along_dim(
        rbits[:, 12:20], boct.long()[:, None], dim=1
    )[:, 0]
    inst_id = rbits[:, 20]

    # =============== LEAF: L exact triangle tests ====================
    any_ok, best_prim, new_tmax_leaf = _leaf_block(
        scene, lay, row, rbits, s, tmin, is_leaf, counts
    )
    nxt = rbits[:, lay.next_col]
    leaf_next = torch.where(nxt == _RETURN, s.leaf_resume, nxt)

    # =============== merge ===========================================
    if anyhit is True:
        cfm_any, cfm_cl = any_ok, torch.zeros_like(any_ok)
    elif anyhit is False:
        cfm_any, cfm_cl = torch.zeros_like(any_ok), any_ok
    else:
        cfm_any = any_ok & anyhit
        cfm_cl = any_ok & torch.logical_not(anyhit)

    cursor = torch.where(
        is_wide,
        wide_next,
        torch.where(is_inst, blas_entry, torch.where(is_leaf, leaf_next, cur)),
    )
    descend_leaf = found & (tkind == 1)
    descend_inst = found & (tkind == 2)
    # done lanes keep their cursor frozen
    cursor = torch.where(done | cfm_any, s.cursor, cursor)

    if counts is not None:
        # in place: small running totals, no new tensor per step
        needed = is_wide[:, None] & (iota >= start[:, None]) & (links != _INVALID)
        counts.totals[:3] += torch.stack([is_wide.sum(), is_leaf.sum(), is_inst.sum()])
        counts.totals[4] += needed.sum()
        rows = row_id[valid].long()
        counts.row_visits.index_add_(0, rows, torch.ones_like(rows))
        counts.lane_steps.add_(valid)

    upd = lambda old, new, m: torch.where(m, new, old)
    return _WideTravState(
        cursor=cursor,
        inst_resume=upd(s.inst_resume, resume, descend_inst),
        leaf_resume=upd(s.leaf_resume, resume, descend_leaf),
        in_blas=(in_blas | is_inst) & torch.logical_not(cfm_any),
        b_org_x=upd(s.b_org_x, bo.x, is_inst),
        b_org_y=upd(s.b_org_y, bo.y, is_inst),
        b_org_z=upd(s.b_org_z, bo.z, is_inst),
        b_inv_x=upd(s.b_inv_x, binv.x, is_inst),
        b_inv_y=upd(s.b_inv_y, binv.y, is_inst),
        b_inv_z=upd(s.b_inv_z, binv.z, is_inst),
        b_S_x=upd(s.b_S_x, bS.x, is_inst),
        b_S_y=upd(s.b_S_y, bS.y, is_inst),
        b_S_z=upd(s.b_S_z, bS.z, is_inst),
        b_axis=upd(s.b_axis, baxis, is_inst),
        cand_inst=upd(s.cand_inst, inst_id, is_inst),
        done=done | cfm_any,
        tmax=torch.where(cfm_cl, new_tmax_leaf, s.tmax),
        occluded=s.occluded | cfm_any,
        c_inst=upd(s.c_inst, s.cand_inst, cfm_cl),
        c_prim=upd(s.c_prim, best_prim, cfm_cl),
    )


def _wide_init(R, active, tmax0, root, device) -> _WideTravState:
    i32 = lambda v: torch.full(R, v, dtype=torch.int32, device=device)
    f32 = lambda v: torch.full(R, v, dtype=torch.float32, device=device)
    return _WideTravState(
        cursor=torch.where(active, root, _END_TLAS),
        inst_resume=i32(_END_TLAS),
        leaf_resume=i32(_END_TLAS),
        in_blas=torch.zeros(R, dtype=torch.bool, device=device),
        b_org_x=f32(0), b_org_y=f32(0), b_org_z=f32(0),
        b_inv_x=f32(0), b_inv_y=f32(0), b_inv_z=f32(0),
        b_S_x=f32(0), b_S_y=f32(0), b_S_z=f32(0),
        b_axis=i32(2),
        cand_inst=i32(-1),
        done=torch.logical_not(active),
        tmax=tmax0,
        occluded=torch.zeros(R, dtype=torch.bool, device=device),
        c_inst=i32(-1),
        c_prim=i32(0),
    )


# The walk is discrete: it runs outside the autograd graph, with no
# gradient into or out of it (the JAX package's stop_gradient on
# traversal). shade_hit re-derives (u, v, t) differentiably.
@torch.no_grad()
def wide_ray_query(
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
    """Drop-in for ops/traversal.ray_query on scenes with wide tables.

    Per-lane TLAS roots come from scene.wide_root[tlas_offset, octant];
    tlas_count is accepted for signature parity but unused (the mega table
    encodes tree extents in its links). ``tmin`` and ``tmax0`` may be scalars
    or per-lane f32 tensors, ``anyhit`` a bool or a per-lane bool tensor.
    Returns (RayHit, occluded).

    Tensors on a CUDA device launch the kernel (or raise — there is no way
    from here to the plain version for them); tensors on the CPU take the
    plain version.
    """
    if org.x.is_cuda:
        from pathtracing_tpu_torch.ops.cuda_wide_traversal import wide_ray_query_cuda

        return wide_ray_query_cuda(
            scene, tlas_count, tlas_offset, org, d, tmin, tmax0, active, anyhit
        )
    return wide_ray_query_plain(
        scene, tlas_count, tlas_offset, org, d, tmin, tmax0, active, anyhit
    )


@torch.no_grad()
def wide_ray_query_plain(
    scene,
    tlas_count,
    tlas_offset,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active,
    anyhit=False,
    return_counts: bool = False,
):
    """The plain PyTorch version of the wide ray-query kernel; same contract
    as ``wide_ray_query``, on whatever device the tensors lie.
    ``return_counts`` additionally returns the WideQueryCounts of this batch."""
    lay = _layout_of(scene)
    R = org.x.shape
    dev = org.x.device
    if isinstance(tmin, torch.Tensor) and tmin.dim() > 0:
        tmin = tmin.to(torch.float32)
    else:
        tmin = float(tmin)
    tmax0 = torch.broadcast_to(
        torch.as_tensor(tmax0, dtype=torch.float32, device=dev), R
    )
    if isinstance(anyhit, torch.Tensor):
        anyhit = anyhit.to(torch.bool)

    root = root_cursor(scene, tlas_offset, _octant(d))
    consts = make_consts(tlas_count, tlas_offset, org, d)
    state = _wide_init(R, active, tmax0, root, dev)
    counts = None
    if return_counts:
        counts = _Counters(
            torch.zeros(5, dtype=torch.int64, device=dev),
            torch.zeros(scene.wide_rows.shape[0], dtype=torch.int64, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
        )
    while not bool(state.done.all()):
        state = _wide_step(scene, lay, state, consts, tmin, anyhit, counts)
    hit = _finalize_hit(scene, consts, state)
    if return_counts:
        c = counts.totals.tolist()
        n_hit = int((state.c_inst >= 0).sum())
        return hit, state.occluded, WideQueryCounts(
            c[0], c[1], c[2], c[3], c[3] if lay.stub else 0, n_hit,
            c[4], int((counts.row_visits > 0).sum()), counts.row_visits,
            counts.lane_steps,
        )
    return hit, state.occluded
