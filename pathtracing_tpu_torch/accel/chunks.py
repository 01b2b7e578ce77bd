"""Chunked static region: instance-split wide tables + a load-time TLAS.

Why (the JAX package's reasoning, from its TPU measurements: BENCH_NOTES
round-4 full-scene row histogram, tools/mk_rowhist.py; none of these
figures is the port's): on the animated forest at frame 900 the JAX
megakernel gathered ~334 rows per sample. The three dominant costs are all *structural*, not geometric:

  * terrain (30%): ONE instance whose AABB spans the whole world — every
    ray descends it before tree hits can shrink tmax;
  * tropical_tree (38%): 279 instances with heavily overlapping canopy
    AABBs — rays enter several BLASes and repeat their top descents;
  * per-subframe TLAS + INST entries (20%): a fresh TLAS over all ~1000
    instances is walked per ray AND rebuilt 32x per frame (~6 s/frame of
    host packing).

The fix: split every mesh's binary BVH into subtree CHUNKS of <= CHUNK_MAX
triangles and re-express each *static* instance as per-chunk entries with
TIGHT world AABBs. A single high-quality TLAS over all static chunk
entries is built ONCE at load time into the static region. Per frame only
the handful of dynamic instances (teapot/armadillo/dragon/bunny/end +
frame-statics logo/buddha — reference: scene.cc:634-676) get chunk INST
rows and one tiny TLAS per subframe whose per-octant EXIT LINKS chain into
the static TLAS root: a lane walks [dynamic tree -> static tree] as one
seamless cursor stream, sharing tmax. No traversal-code changes at all.

Semantics: the confirmed-candidate SET is unchanged (chunks partition the
same triangles, transforms and leaf tests are identical); only the
traversal ORDER differs, so closest hits are identical except exact-t ties
between distinct triangles (the documented chaotic-lane class,
docs/PARITY.md) and any-hit occlusion is boolean-identical. The scan/
binary path (ops/traversal.py) keeps the reference TLAS bit-exactly.

Reference analogue: none — the reference walks one TLAS over whole
instances (scene.cc:698-717, ray_query.hh:153-182). This layout is the
JAX package's answer to its per-frame OpenMP TLAS rebuild; the port keeps
it byte for byte (``accel/chunks.py`` there), and its wide walks (the
``wide_ray_query`` kernel, the path kernels and their plain versions)
follow an exit cursor into the static tree as into any other row.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch.accel.builder_py import build_from_leaves
from pathtracing_tpu_torch.accel.wide import (
    END_BLAS,
    END_TLAS,
    KIND_INST,
    KIND_LEAF,
    KIND_WIDE,
    LAYOUT_W8,
    WideBuilder,
    WideLayout,
    _use_native,
)

f32 = np.float32
u32 = np.uint32

# triangles a chunk may hold at most (the JAX CLI's chunk_max)
CHUNK_MAX = 1024


def _children_arrays(links0: np.ndarray, n: int):
    """Per-node first-child + next-sibling arrays from the octant-0 link
    table (reference layout: bvh.cc:170-193). Returns (first, sibling,
    is_leaf); node ids are BFS order so children always have higher ids."""
    accept = links0[:, 0].astype(np.int64)
    cancel = links0[:, 1].astype(np.int64)
    is_leaf = (accept & 0x80000000) != 0
    first = np.where(is_leaf, -1, accept)
    return first, cancel, is_leaf


def chunk_nodes(
    links0: np.ndarray, n: int, chunk_max: int
) -> list[int]:
    """Binary node ids whose subtrees partition all triangles, each with
    <= chunk_max triangles (iterative; no recursion on deep trees)."""
    if n == 0:
        return []
    first, cancel, is_leaf = _children_arrays(links0, n)

    # triangle counts per node: BFS ids guarantee children > parent, so a
    # reverse sweep accumulates counts bottom-up
    counts = np.zeros(n, np.int64)
    counts[is_leaf] = 1
    for v in range(n - 1, -1, -1):
        if is_leaf[v]:
            continue
        c = first[v]
        total = 0
        while True:
            total += counts[c]
            nxt = cancel[c]
            if nxt == cancel[v]:
                break
            c = nxt
        counts[v] = total

    out: list[int] = []
    stack = [0]
    while stack:
        v = stack.pop()
        if is_leaf[v] or counts[v] <= chunk_max:
            out.append(v)
            continue
        c = first[v]
        while True:
            stack.append(int(c))
            nxt = cancel[c]
            if nxt == cancel[v]:
                break
            c = nxt
    return out


def _world_aabbs(transforms: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """World AABBs of the 8 transformed corners per (instance-chunk), f32
    math matching the reference TLAS build (bvh.cc:252-284).

    transforms: (M, 4, 4); bmin/bmax: (M, 3). Returns (lmin, lmax)."""
    M = len(bmin)
    lmin = np.full((M, 3), np.inf, f32)
    lmax = np.full((M, 3), -np.inf, f32)
    for a in range(8):
        corner = np.stack(
            [
                np.where(a & 1, bmax[:, 0], bmin[:, 0]),
                np.where(a & 2, bmin[:, 1], bmax[:, 1]),
                np.where(a & 4, bmin[:, 2], bmax[:, 2]),
                np.ones(M, f32),
            ],
            axis=1,
        ).astype(f32)
        # mul_m4v4 is the TRANSPOSE form (m.T @ v; reference math.hh:228),
        # hence "mji" not "mij"
        v = np.einsum("mji,mj->mi", transforms.astype(f32), corner)[:, :3]
        v = v.astype(f32)
        lmin = np.minimum(lmin, v)
        lmax = np.maximum(lmax, v)
    return lmin, lmax


def _chunk_prim_lists(links0: np.ndarray, chunk_roots) -> list[np.ndarray]:
    """Per-chunk primitive id lists by iterative DFS over the octant-0
    binary links (chunks partition the tree, so total work is O(nodes))."""
    first, sibling, is_leaf = _children_arrays(links0, len(links0))
    accept = links0[:, 0].astype(np.int64)
    out = []
    for root in chunk_roots:
        prims = []
        stack = [int(root)]
        while stack:
            v = stack.pop()
            if is_leaf[v]:
                prims.append(accept[v] & 0x7FFFFFFF)
                continue
            c = first[v]
            while True:
                stack.append(int(c))
                nxt = sibling[c]
                if nxt == sibling[v]:
                    break
                c = nxt
        out.append(np.asarray(prims, np.int64))
    return out


def _inst_chunk_rows(
    lay: WideLayout, inv12: np.ndarray, inst_ids: np.ndarray,
    root8s: np.ndarray, base: int,
):
    """INST row block for chunk entries: same byte layout as
    WideBuilder.build_inst_row but with caller-chosen instance ids (the
    ORIGINAL instance index, so shading is untouched) and per-chunk entry
    links. inv12: (M, 12); inst_ids: (M,); root8s: (M, 8) u32."""
    M = len(inst_ids)
    rows = np.zeros((M, lay.w_row), f32)
    if M:
        rows[:, 0:12] = inv12.astype(f32)
        rows[:, 12:20] = root8s.astype(u32).view(f32)
        rows[:, 20] = inst_ids.astype(np.int32).view(f32)
    cursors = (
        (u32(KIND_INST) << 30)
        | ((base + np.arange(M, dtype=np.int64)).astype(u32) << lay.slot_bits)
    )
    return rows, cursors.astype(u32)


class ChunkedStaticRegion:
    """Static mega-table prefix for chunked traversal.

    Layout: [per-mesh chunk wide trees] [static chunk INST rows]
    [static TLAS wide tree]. Exposes:

      rows          (S, w_row) f32 static region
      static_root8  (8,) u32 static TLAS root cursors per octant
      chunks_of     mesh key (node_offset, node_count) ->
                    (node_ids (C,), aabb6 (C, 6) f32 local AABBs,
                     root8 (C, 8) u32 chunk entry cursors)
      layout, leaf_bundle, chunk_max, octants, bake_static

    Options (the JAX package's, the same bytes for each): ``chunk_max``
    triangles a chunk holds at most; ``octants`` 8 (a tree per direction
    octant) or 1 (octant 0's tree only, every entry cursor aliased to it);
    ``bake_static`` re-emits every static instance's chunks in world space
    under identity INST rows (needs the native wide builder, else
    RuntimeError).
    """

    def __init__(
        self,
        mesh_arrays,
        bvh_nodes: np.ndarray,
        bvh_links: np.ndarray,
        mesh_blas_pairs,
        static_instances,
        leaf_bundle: int | None = 8,
        layout: WideLayout = LAYOUT_W8,
        chunk_max: int = CHUNK_MAX,
        octants: int = 8,
        bake_static: bool = False,
    ):
        import sys

        if sys.getrecursionlimit() < 100000:
            sys.setrecursionlimit(100000)
        assert octants in (1, 8), octants
        self.layout = layout
        self.leaf_bundle = leaf_bundle
        self.chunk_max = chunk_max
        self.bake_static = bake_static
        # octants=1 emits only octant 0's tree per chunk/TLAS and aliases
        # the 8 entry cursors to it: ~8x fewer interior rows, trading
        # near-to-far order for a far smaller table (the JAX package chose
        # it for its TPU gather, whose cost rose with table footprint)
        self.octants = octants
        lay = layout
        nodes = np.asarray(bvh_nodes, f32)
        links_all = np.ascontiguousarray(bvh_links, u32)
        indices, pos = mesh_arrays[0], mesh_arrays[1]

        native = _use_native()
        if native:
            from pathtracing_tpu_torch.accel.native import build_wide_tree_native
        elif bake_static:
            # the JAX package raises this after building the chunk trees
            raise RuntimeError("bake_static needs the native wide builder")

        bundle = 2 * lay.leaf_tris if leaf_bundle is None else leaf_bundle
        self.chunks_of: dict = {}
        parts: list[np.ndarray] = []
        row_cursor = 0
        builder = None if native else WideBuilder(
            leaf_bundle=leaf_bundle, layout=lay
        )
        mesh_cache: dict = {}  # bake_static: key -> (links8, n6, tri9, roots)

        for mesh, blas in mesh_blas_pairs:
            key = (blas.node_offset, blas.node_count)
            if key in self.chunks_of or blas.node_count == 0:
                continue
            off, cnt = key
            links8 = links_all[8 * off : 8 * off + 8 * cnt]
            n6 = nodes[off : off + cnt]
            roots = chunk_nodes(links8[:cnt], cnt, chunk_max)
            tri = indices[
                mesh.index_offset : mesh.index_offset + 3 * mesh.triangle_count
            ].reshape(-1, 3).astype(np.int64) + mesh.base_vertex_offset
            tri9 = pos[tri].reshape(-1, 9).astype(f32)

            node_ids = np.asarray(roots, np.int64)
            aabb6 = n6[node_ids].copy()
            if bake_static:
                mesh_cache[key] = (links8, n6, tri9, node_ids)
            root8s = np.zeros((len(roots), 8), u32)
            for k, v in enumerate(roots):
                if native:
                    res = build_wide_tree_native(
                        links8, n6, tri9, None, bundle, lay.n_slots,
                        lay.leaf_tris, row_cursor, int(END_BLAS),
                        root_node=int(v), n_octants=octants,
                        stub=lay.stub,
                    )
                    if res is None:
                        raise RuntimeError(
                            "native wide chunk build failed (corrupt links?)"
                        )
                    rows, root8 = res
                    parts.append(rows)
                    root8s[k] = root8
                    row_cursor += len(rows)
                else:
                    leaf_cache: dict = {}

                    def leaf_target(prims, group, mesh=mesh):
                        pk = tuple(sorted(prims))
                        if pk not in leaf_cache:
                            def t9(p):
                                t = indices[
                                    mesh.index_offset + 3 * p
                                    : mesh.index_offset + 3 * p + 3
                                ].astype(np.int64) + mesh.base_vertex_offset
                                return pos[t].reshape(9)
                            leaf_cache[pk] = builder.build_leaf_chain(
                                list(pk), t9
                            )
                        return lay.make_cursor(KIND_LEAF, leaf_cache[pk])

                    for o in range(octants):
                        links_o = links8[o * cnt : (o + 1) * cnt]
                        rid = builder.build_wide_tree(
                            links_o, n6, int(v), leaf_target, END_BLAS
                        )
                        root8s[k, o] = lay.make_cursor(KIND_WIDE, rid)
                    root8s[k, octants:] = root8s[k, 0]
            self.chunks_of[key] = (node_ids, aabb6, root8s)

        if not native:
            chunk_rows = builder.finalize()
            parts = [chunk_rows] if len(chunk_rows) else []
            row_cursor = len(chunk_rows)

        # ---- static chunk INST rows -------------------------------------
        # bake_static: every STATIC instance's chunk trees are
        # re-emitted with WORLD-SPACE triangle vertices and node AABBs and
        # an IDENTITY-transform INST row (original instance id, so shading
        # and hit records are untouched). The static TLAS then covers
        # EXACT per-chunk world boxes (reduced over the chunk's world
        # triangles) instead of corner-transformed mesh boxes — the loose
        # boxes + per-instance re-descents made tropical_tree 38% of the
        # rows the JAX package's TPU walk gathered. Costs: the static
        # table grows with total INSTANCED triangles (~79x the unique-mesh
        # count on the reference's full scene), and the leaf test runs on
        # world-space vertices, which shifts exact-t ties into the
        # documented chaotic-lane class (docs/PARITY.md) — the candidate
        # SET is unchanged (conservative boxes, same triangles), so hits
        # differ only on ulp-level t ties; validation is the PSNR gate,
        # not bit-equality.
        inv12, ids, root8s, bmin, bmax, tmats = [], [], [], [], [], []
        ident12 = np.eye(4, dtype=f32)[:, 0:3].reshape(12)
        ident4 = np.eye(4, dtype=f32)
        chunk_prims: dict = {}
        if bake_static:
            for key, (links8, n6, tri9, node_ids) in mesh_cache.items():
                cnt = key[1]
                chunk_prims[key] = _chunk_prim_lists(
                    links8[:cnt], node_ids
                )
        for abs_id, inst in enumerate(static_instances):
            key = (inst.blas.node_offset, inst.blas.node_count)
            node_ids, aabb6, r8 = self.chunks_of[key]
            C = len(node_ids)
            if C == 0:
                continue
            if bake_static:
                # per-chunk WORLD SAH rebuild: exact world boxes AND
                # world-axis octant orderings. (A cheaper variant reusing
                # the mesh-space topology with corner-transformed node
                # boxes gathered 2.2x the base pack's rows a sample on the
                # JAX package's TPU walk: rotation-degraded ordering and
                # loose interior boxes more than cancel the TLAS win.)
                links8, n6, tri9, _nids = mesh_cache[key]
                t = np.asarray(inst.transform, f32)
                rot, trans = t[:3, :3], t[3, :3]
                v = tri9.reshape(-1, 3, 3)
                tri9w = np.ascontiguousarray(
                    (v @ rot + trans).reshape(-1, 9), f32
                )
                vw = tri9w.reshape(-1, 3, 3)
                tmin_all = vw.min(axis=1)
                tmax_all = vw.max(axis=1)
                r8w = np.zeros((C, 8), u32)
                emin = np.empty((C, 3), f32)
                emax = np.empty((C, 3), f32)
                for k in range(C):
                    prims = chunk_prims[key][k]
                    t_nodes, t_links = build_from_leaves(
                        tmin_all[prims], tmax_all[prims],
                        prims.astype(u32),
                    )
                    res = build_wide_tree_native(
                        np.ascontiguousarray(t_links, u32),
                        np.asarray(t_nodes, f32), tri9w, None, bundle,
                        lay.n_slots, lay.leaf_tris, row_cursor,
                        int(END_BLAS), root_node=0, n_octants=octants,
                        stub=lay.stub,
                    )
                    if res is None:
                        raise RuntimeError(
                            "native wide chunk build failed (corrupt links?)"
                        )
                    rows, root8 = res
                    parts.append(rows)
                    r8w[k] = root8
                    row_cursor += len(rows)
                    emin[k] = t_nodes[0, 0:3]
                    emax[k] = t_nodes[0, 3:6]
                inv12.append(np.tile(ident12, (C, 1)))
                ids.append(np.full(C, abs_id, np.int64))
                root8s.append(r8w)
                bmin.append(emin)
                bmax.append(emax)
                tmats.append(np.tile(ident4[None], (C, 1, 1)))
                continue
            inv = np.asarray(inst.inv_transform, f32)[:, 0:3].reshape(12)
            inv12.append(np.tile(inv, (C, 1)))
            ids.append(np.full(C, abs_id, np.int64))
            root8s.append(r8)
            bmin.append(aabb6[:, 0:3])
            bmax.append(aabb6[:, 3:6])
            tmats.append(
                np.tile(np.asarray(inst.transform, f32)[None], (C, 1, 1))
            )
        M = sum(len(i) for i in ids) if ids else 0
        inst_base = row_cursor
        if M:
            inst_rows, inst_cursors = _inst_chunk_rows(
                lay,
                np.concatenate(inv12),
                np.concatenate(ids),
                np.concatenate(root8s),
                inst_base,
            )
            parts.append(inst_rows)
            row_cursor += M

            # ---- static TLAS over chunk world AABBs ---------------------
            lmin, lmax = _world_aabbs(
                np.concatenate(tmats),
                np.concatenate(bmin).astype(f32),
                np.concatenate(bmax).astype(f32),
            )
            t_nodes, t_links = build_from_leaves(
                lmin, lmax, np.arange(M, dtype=u32)
            )
            rows, self.static_root8 = _emit_tlas_rows(
                lay, t_nodes, t_links, inst_cursors, row_cursor,
                np.full(8, END_TLAS, u32), bundle, octants,
            )
            parts.append(rows)
            row_cursor += len(rows)
        else:
            self.static_root8 = np.full(8, END_TLAS, u32)

        self.rows = (
            np.concatenate(parts)
            if parts else np.zeros((1, lay.w_row), f32)
        )


def _emit_tlas_rows(
    lay: WideLayout, t_nodes, t_links, payload_cursors: np.ndarray,
    base_row: int, exit8: np.ndarray, bundle: int, octants: int = 8,
):
    """Wide rows for a TLAS whose leaves are payload_cursors[payload],
    with per-octant exit cursors. Returns (rows, root8)."""
    n = len(t_nodes)
    if n == 0:
        return np.zeros((0, lay.w_row), f32), exit8.astype(u32).copy()
    if _use_native():
        from pathtracing_tpu_torch.accel.native import build_wide_tree_native

        res = build_wide_tree_native(
            np.ascontiguousarray(t_links, u32), np.asarray(t_nodes, f32),
            None, np.ascontiguousarray(payload_cursors, u32),
            bundle, lay.n_slots, lay.leaf_tris, base_row, int(END_TLAS),
            exit8=np.ascontiguousarray(exit8, u32), n_octants=octants,
            stub=lay.stub,
        )
        if res is not None:
            return res
    b = WideBuilder(leaf_bundle=0, base=base_row, layout=lay)
    root8 = np.zeros(8, u32)
    for o in range(octants):
        links_o = np.asarray(t_links, u32)[o * n : (o + 1) * n]

        def leaf_target(prims, group):
            assert len(prims) == 1
            return u32(payload_cursors[prims[0]])

        rid = b.build_wide_tree(
            links_o, np.asarray(t_nodes, f32), 0, leaf_target,
            u32(exit8[o]),
        )
        root8[o] = lay.make_cursor(KIND_WIDE, rid)
    root8[octants:] = root8[0]
    rows = b.finalize() if b.rows else np.zeros((0, lay.w_row), f32)
    return rows, root8


def build_frame_tail_chunked(
    static: ChunkedStaticRegion,
    instances,
    subframes,
    subframe_entries,
    frame_static_range,
    static_instance_count: int,
    root_base: int,
):
    """Per-frame tail: chunk INST rows for dynamic instances + one small
    TLAS per subframe chained into the static TLAS.

    subframe_entries[i] = (dynamic_begin, dynamic_end) absolute instance
    ranges per subframe (loader mirrors reference scene.cc:663-676);
    frame_static_range = (static_instance_count, static_end) covers the
    frame-static logo/buddha instances included in EVERY subframe.
    Returns (tail (K, w_row) f32, root_by_off (R, 8) int32) exactly like
    accel.wide.build_frame_tail.
    """
    lay = static.layout
    base = len(static.rows)
    bundle = (
        2 * lay.leaf_tris if static.leaf_bundle is None
        else static.leaf_bundle
    )

    fs_lo, fs_hi = frame_static_range
    dyn_ids = list(range(static_instance_count, len(instances)))

    # ---- chunk INST rows for every dynamic-side instance ----
    inv12, ids, root8s, bmin, bmax, tmats = [], [], [], [], [], []
    slice_of: dict = {}  # abs instance id -> (start, count) into the block
    m = 0
    for abs_id in dyn_ids:
        inst = instances[abs_id]
        key = (inst.blas.node_offset, inst.blas.node_count)
        if key not in static.chunks_of:
            raise KeyError(
                f"instance {abs_id} uses BLAS {key} absent from the "
                "chunked static region (mesh added after load?)"
            )
        node_ids, aabb6, r8 = static.chunks_of[key]
        C = len(node_ids)
        if C == 0:
            continue
        inv = np.asarray(inst.inv_transform, f32)[:, 0:3].reshape(12)
        inv12.append(np.tile(inv, (C, 1)))
        ids.append(np.full(C, abs_id, np.int64))
        root8s.append(r8)
        bmin.append(aabb6[:, 0:3])
        bmax.append(aabb6[:, 3:6])
        tmats.append(
            np.tile(np.asarray(inst.transform, f32)[None], (C, 1, 1))
        )
        slice_of[abs_id] = (m, C)
        m += C

    parts = []
    if m:
        rows, cursors = _inst_chunk_rows(
            lay, np.concatenate(inv12), np.concatenate(ids),
            np.concatenate(root8s), base,
        )
        parts.append(rows)
        lmin_all, lmax_all = _world_aabbs(
            np.concatenate(tmats),
            np.concatenate(bmin).astype(f32),
            np.concatenate(bmax).astype(f32),
        )
    else:
        cursors = np.zeros(0, u32)
        lmin_all = lmax_all = np.zeros((0, 3), f32)
    row_cursor = base + m

    # ---- per-subframe dynamic TLAS, exit-chained to the static root ----
    max_off = root_base
    for sf in subframes:
        max_off = max(max_off, sf.tlas.node_offset)
    root_by_off = np.full((max_off - root_base + 1, 8), END_TLAS, u32)

    seen: dict = {}
    for i, sf in enumerate(subframes):
        entry = (
            subframe_entries[i] if i < len(subframe_entries) else (0, 0)
        )
        members = [
            a for a in list(range(fs_lo, fs_hi)) + list(range(*entry))
            if a in slice_of
        ]
        mkey = tuple(members)
        if mkey in seen:
            root_by_off[sf.tlas.node_offset - root_base] = seen[mkey]
            continue
        if not members:
            root8 = static.static_root8
        else:
            sel = np.concatenate(
                [np.arange(*(lambda s: (s[0], s[0] + s[1]))(slice_of[a]))
                 for a in members]
            )
            t_nodes, t_links = build_from_leaves(
                lmin_all[sel], lmax_all[sel],
                np.arange(len(sel), dtype=u32),
            )
            rows, root8 = _emit_tlas_rows(
                lay, t_nodes, t_links, cursors[sel], row_cursor,
                static.static_root8, bundle,
                static.octants,
            )
            parts.append(rows)
            row_cursor += len(rows)
        seen[mkey] = root8
        root_by_off[sf.tlas.node_offset - root_base] = root8

    tail = (
        np.concatenate(parts) if parts
        else np.zeros((0, lay.w_row), f32)
    )
    return tail, root_by_off.view(np.int32)
