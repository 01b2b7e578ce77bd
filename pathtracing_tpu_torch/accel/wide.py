"""Wide-BVH "mega-table" builder: one row read per traversal step.

The binary octant-link walk (ops/traversal.py) reads one 32 B node row per
node visit and one 48 B row per triangle test. This layout trades rows per
ray for row width:

  * WIDE rows: S slots, each a whole binary subtree root -- one row
    slab-tests S children (three binary levels for S = 8) at once;
  * LEAF rows: L triangles inline (vertices + prim ids) -- one row per
    L triangle tests, chained for bigger bundles;
  * INST rows: instance transform + per-octant BLAS entry links -- one
    row per TLAS->BLAS descent.

All three row kinds live in ONE (M, w_row) f32 table so every traversal step
reads exactly one row; the row kind is carried in the cursor's tag bits.

Bit-exactness: wide nodes are built by collapsing the *reference* binary
tree (reconstructed per octant from the golden-tested stackless link
tables, reference: bvh.cc:170-226), with slots kept in that octant's binary
DFS order and static exit links to the DFS successor. Skipping the interior
binary AABB tests only ever *adds* encountered candidates: a subtree the
binary walk culls is culled either because the ray misses its AABB (then
every triangle inside misses too) or because near > tmax (then every hit
inside fails the strict t < tmax confirm). Slot AABBs are bf16
outward-rounded, which also only widens the encounter set. Hence the
*confirmed-candidate sequence* is identical to the reference walk and
closest/any-hit results are bit-identical. Sole caveat: triangles inside
one LEAF bundle are tested in canonical (forward) order rather than the
octant's flipped order, so two candidates with *exactly* equal t could
tie-break differently -- golden-tested to not occur.

Cursor / link encoding (uint32; B = layout.slot_bits):
  bits 30..31  kind: 0=WIDE 1=LEAF 2=INST 3=sentinel
  bits  B..29  row index into the mega table
  bits  0..B-1 start slot (WIDE re-entry; zero otherwise)
  sentinels: END_TLAS (lane done), END_BLAS (pop to the TLAS resume cursor)

Three layouts ship, keyed by row width: w8 (8 slots + 4-tri leaves, 192 B
rows), w16 (16 slots + 8-tri leaves, 352 B rows) and s8 (8 slots + 8-id stub
leaves, 160 B rows, vertices read from scene.tri_pos at test time).

This is the port's own copy of the JAX package's module and produces the
same bytes (tests/test_torch_wide_tables.py). As there, the BLAS region and
the frame tail are built by the C++ builder of accel/native when it can be
built and ``PT_NATIVE_WIDE`` is "1" (the default), and by the numpy
WideBuilder otherwise, with the same bytes (tests/test_torch_host.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from pathtracing_tpu_torch.accel.native import build_wide_tree_native
from pathtracing_tpu_torch.utils import native_build

f32 = np.float32
u32 = np.uint32

KIND_WIDE = 0
KIND_LEAF = 1
KIND_INST = 2
KIND_SENTINEL = 3
END_TLAS = u32((3 << 30) | 0)
END_BLAS = u32((3 << 30) | 1)
_INVALID = u32(0xFFFFFFFF)

# wide-row column layout (S = layout.n_slots, L = layout.leaf_tris)
#   0..3S-1     S slots x 3 f32 of packed bf16 AABB halves
#   3S..4S-1    S slot links (u32 bit patterns)
#   4S          exit link (u32)
# leaf-row column layout
#   0..9L-1     L triangles x 9 f32 mesh-space vertices
#   9L..10L-1   L prim ids (int32 bits; -1 = empty)
#   10L         next link (u32): next chained leaf row or RETURN sentinel
# inst-row column layout (layout-independent; W_ROW >= 21 always)
#   0..11   inverse transform columns (as scene/device.py inst_f[:, :12])
#   12..19  8 per-octant BLAS entry links (u32)
#   20      instance id (int32 bits)

RETURN_SENTINEL = u32((3 << 30) | 2)   # leaf chain end -> leaf_resume


class WideLayout:
    """Row geometry of the mega table. Cursor bits: kind in 30..31, start
    slot in the low ``slot_bits``, row index in between. Fatter rows cut
    the rows read per ray at the price of more arithmetic per row."""

    def __init__(self, n_slots: int, leaf_tris: int, stub: bool = False):
        self.n_slots = n_slots
        self.leaf_tris = leaf_tris
        # stub leaves: the row stores ONLY leaf_tris prim ids + the next
        # link; vertices are read from scene.tri_pos at test time. Shrinks
        # the mega table at the price of leaf_tris extra row reads from the
        # tri_pos table per leaf row.
        self.stub = stub
        self.slot_bits = max(3, (n_slots - 1).bit_length())
        self.row_mask = u32((1 << (30 - self.slot_bits)) - 1)
        # pad width to a multiple of 8 f32 (32 B): every row is then a
        # whole number of 16-byte vectors; keeps w8 at 48-col rows
        leaf_need = (leaf_tris + 2) if stub else (10 * leaf_tris + 1)
        need = max(4 * n_slots + 1, leaf_need, 21)
        self.w_row = -(-(need + 1) // 8) * 8
        # column offsets
        self.links_col = 3 * n_slots         # wide rows
        self.exit_col = 4 * n_slots
        self.prims_col = 0 if stub else 9 * leaf_tris   # leaf rows
        self.next_col = leaf_tris if stub else 10 * leaf_tris

    def make_cursor(self, kind: int, row: int, slot: int = 0) -> u32:
        assert 0 <= row < (1 << (30 - self.slot_bits)), row
        assert 0 <= slot < self.n_slots
        return u32((kind << 30) | (row << self.slot_bits) | slot)


# The shipped layouts, keyed by row width (ops/wide_traversal.py recovers
# the layout from scene.wide_rows.shape[1]):
#   w8  : 8 slots / 4-tri leaves, 48-col (192 B) rows
#   w16 : 16 slots / 8-tri leaves, 88-col (352 B) rows — fewer rows per ray
LAYOUT_W8 = WideLayout(8, 4)
LAYOUT_W16 = WideLayout(16, 8)
#   s8 : 8 slots + 8-id STUB leaves in 40-col (160 B) rows — verts
#        read from tri_pos at test time; the smallest table
LAYOUT_S8 = WideLayout(8, 8, stub=True)
LAYOUTS_BY_WIDTH = {
    LAYOUT_W8.w_row: LAYOUT_W8,
    LAYOUT_W16.w_row: LAYOUT_W16,
    LAYOUT_S8.w_row: LAYOUT_S8,
}

@dataclass
class _Group:
    """A slot candidate: one binary node, or a contiguous run of siblings
    (virtual node used when a multi-leaf node has > N_SLOTS children)."""

    nodes: list                    # binary node indices (len 1 normally)
    bmin: np.ndarray
    bmax: np.ndarray
    children: list = field(default_factory=list)   # child _Groups, DFS order
    payload: int = -1              # binary leaf payload (tri/instance id)
    tri_count: int = 0             # total leaves under this group

    @property
    def is_leaf(self) -> bool:
        return self.payload >= 0 and not self.children


def _binary_children(links, v, nodes6):
    """Recover node v's children (that octant's DFS order) from the
    stackless link table: accept(v) = first child, then each child's
    cancel link chains to the next sibling until it equals cancel(v)
    (reference: bvh.cc:170-193 save_traversal_links)."""
    accept, cancel = int(links[v, 0]), int(links[v, 1])
    if accept & 0x80000000:
        return None  # leaf
    out = []
    c = accept
    while True:
        out.append(c)
        nxt = int(links[c, 1])
        if nxt == cancel:
            break
        c = nxt
        if len(out) > len(links):
            raise RuntimeError("cyclic link chain")
    return out


def _group_of(links, nodes6, v) -> _Group:
    n6 = nodes6[v]
    kids = _binary_children(links, v, nodes6)
    g = _Group([v], n6[0:3].copy(), n6[3:6].copy())
    if kids is None:
        g.payload = int(links[v, 0] & 0x7FFFFFFF)
        g.tri_count = 1
        return g
    g.children = [_group_of(links, nodes6, c) for c in kids]
    g.tri_count = sum(c.tri_count for c in g.children)
    return g


def _split_group(children, lo, hi) -> _Group:
    """Virtual node over children[lo:hi] (contiguous DFS run)."""
    sub = children[lo:hi]
    if len(sub) == 1:
        return sub[0]
    g = _Group(
        nodes=sum((c.nodes for c in sub), []),
        bmin=np.min([c.bmin for c in sub], axis=0),
        bmax=np.max([c.bmax for c in sub], axis=0),
    )
    g.children = sub
    g.tri_count = sum(c.tri_count for c in sub)
    return g


def _expand_slots(root: _Group, max_slots: int) -> list:
    """Slot list for a wide node rooted at ``root``: expand groups
    breadth-first (shallowest first) while the slot count stays within
    max_slots; DFS order is preserved because every expansion replaces a
    slot by its children in place."""
    kids = root.children
    if not kids:
        return [root]          # degenerate: root itself is a leaf
    if len(kids) > max_slots:
        # split the DFS chain into max_slots contiguous runs
        bounds = np.linspace(0, len(kids), max_slots + 1).astype(int)
        slots = [
            _split_group(kids, bounds[i], bounds[i + 1])
            for i in range(max_slots)
            if bounds[i] < bounds[i + 1]
        ]
    else:
        slots = list(kids)
    depth = {id(s): 1 for s in slots}
    while True:
        best = None
        for i, s in enumerate(slots):
            if s.is_leaf or not s.children:
                continue
            k = len(s.children)
            if k <= max_slots - len(slots) + 1:
                d = depth[id(s)]
                if best is None or d < best[1] or (d == best[1] and i < best[0]):
                    best = (i, d)
        if best is None:
            return slots
        i, d = best
        s = slots[i]
        slots[i : i + 1] = s.children
        for c in s.children:
            depth[id(c)] = d + 1


def _round_bf16(x, up: bool) -> u32:
    bits = np.asarray(x, f32).view(u32) if isinstance(x, np.ndarray) else (
        np.array([x], f32).view(u32)
    )
    bits = np.atleast_1d(bits)
    inexact = (bits & u32(0xFFFF)) != 0
    trunc = bits >> 16
    neg = (bits >> 31).astype(bool)
    grow = inexact & (neg != up)
    return (trunc + grow.astype(u32))[0]


def _pack_slot_aabb(bmin, bmax):
    """3 packed f32: [minx|miny],[minz|maxx],[maxy|maxz], min rounded down,
    max rounded up (value-preserving bf16 halves)."""
    lo = [_round_bf16(bmin[i], up=False) for i in range(3)]
    hi = [_round_bf16(bmax[i], up=True) for i in range(3)]
    six = [lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]]
    packed = np.array(
        [(six[0] << 16) | six[1], (six[2] << 16) | six[3],
         (six[4] << 16) | six[5]],
        u32,
    )
    return packed.view(f32)


_EMPTY_SLOT_AABB = None


def _empty_slot_aabb():
    global _EMPTY_SLOT_AABB
    if _EMPTY_SLOT_AABB is None:
        inf = np.array([np.inf, np.inf, np.inf], f32)
        _EMPTY_SLOT_AABB = _pack_slot_aabb(inf, -inf)
    return _EMPTY_SLOT_AABB


class WideBuilder:
    """Accumulates mega-table rows for one scene (or one frame tail).

    ``base`` offsets every emitted row id/cursor: a per-frame tail builder
    allocates rows [base, base+K) so its cursors address the concatenation
    [static_rows; tail_rows] directly (a frame packer).
    """

    def __init__(self, leaf_bundle: int | None = 8, base: int = 0,
                 layout: WideLayout = LAYOUT_W8):
        self.rows: list = []          # list of np (layout.w_row,) f32
        self.fixups: list = []        # (row, col, cursor-lambda) deferred links
        self.layout = layout
        if leaf_bundle is None:
            leaf_bundle = 2 * layout.leaf_tris
        self.leaf_bundle = leaf_bundle
        self.base = base

    def _alloc(self) -> int:
        self.rows.append(np.zeros(self.layout.w_row, f32))
        return self.base + len(self.rows) - 1

    def _row(self, rid: int) -> np.ndarray:
        return self.rows[rid - self.base]

    # -- leaf rows (canonical order, shared across octants) ----------------

    def build_leaf_chain(self, prims, tri_pos_lookup) -> int:
        """Rows for a bundle of triangles; returns the first row id.
        prims: list of mesh-local prim ids in canonical DFS order.
        tri_pos_lookup(prim) -> (9,) mesh-space vertices."""
        lay = self.layout
        first = None
        prev = None
        for lo in range(0, len(prims), lay.leaf_tris):
            rid = self._alloc()
            row = self._row(rid)
            batch = prims[lo : lo + lay.leaf_tris]
            if not lay.stub:
                for k, p in enumerate(batch):
                    row[9 * k : 9 * k + 9] = tri_pos_lookup(p)
            ids = np.full(lay.leaf_tris, -1, np.int32)
            ids[: len(batch)] = batch
            row[lay.prims_col : lay.prims_col + lay.leaf_tris] = ids.view(f32)
            row[lay.next_col] = np.array([RETURN_SENTINEL], u32).view(f32)[0]
            if first is None:
                first = rid
            if prev is not None:
                self._row(prev)[lay.next_col] = np.array(
                    [lay.make_cursor(KIND_LEAF, rid)], u32
                ).view(f32)[0]
            prev = rid
        return first

    # -- instance rows -----------------------------------------------------

    def build_inst_row(self, inv_transform_cols12, inst_id: int,
                       blas_entry_by_oct) -> int:
        """blas_entry_by_oct: list of 8 cursors (filled later via fixup if
        the BLAS trees are built after; pass callables for deferral)."""
        rid = self._alloc()
        row = self._row(rid)
        row[0:12] = np.asarray(inv_transform_cols12, f32)
        for o in range(8):
            e = blas_entry_by_oct[o]
            if callable(e):
                self.fixups.append((rid, 12 + o, e))
            else:
                row[12 + o] = np.array([u32(e)], u32).view(f32)[0]
        row[20] = np.array([np.int32(inst_id)], np.int32).view(f32)[0]
        return rid

    # -- wide trees --------------------------------------------------------

    def build_wide_tree(
        self, links, nodes6, root: int, leaf_target, exit_cursor,
    ) -> int:
        """Wide rows for one octant of one binary tree.

        links: (n, 2) u32 octant link table; nodes6: (n, 6) AABBs;
        leaf_target(payload, tri_count_group) -> cursor for a leaf slot
        (either a LEAF-chain cursor for triangles or an INST cursor);
        exit_cursor: where the walk goes when the whole tree is exhausted
        (END_BLAS for a BLAS, END_TLAS for a TLAS).
        Returns the root row id.
        """
        root_group = _group_of(links, nodes6, root)
        return self._emit_wide(root_group, leaf_target, exit_cursor)

    def _emit_wide(self, group: _Group, leaf_target, exit_cursor) -> int:
        lay = self.layout
        rid = self._alloc()
        row = self._row(rid)
        slots = _expand_slots(group, lay.n_slots)
        assert len(slots) <= lay.n_slots
        u = np.zeros(lay.n_slots, u32)   # slot links
        for j in range(lay.n_slots):
            if j < len(slots):
                s = slots[j]
                row[3 * j : 3 * j + 3] = _pack_slot_aabb(s.bmin, s.bmax)
            else:
                row[3 * j : 3 * j + 3] = _empty_slot_aabb()
                u[j] = _INVALID
        for j, s in enumerate(slots):
            if s.is_leaf or (0 < s.tri_count <= self.leaf_bundle):
                u[j] = leaf_target(self._collect_prims(s), s)
            else:
                child = self._emit_wide(s, leaf_target, exit_cursor)
                u[j] = lay.make_cursor(KIND_WIDE, child)
                # child's exit: resume this row at slot j+1 (overwrites the
                # exit_cursor the recursive emit stored); when j was the
                # last populated slot a re-entry would find nothing, so
                # forward directly to this row's own exit (fixup: our exit
                # may itself be patched by OUR parent after we return)
                if j + 1 < len(slots):
                    self._row(child)[lay.exit_col] = np.array(
                        [lay.make_cursor(KIND_WIDE, rid, j + 1)], u32
                    ).view(f32)[0]
                else:
                    self.fixups.append((child, lay.exit_col, ("copy_exit", rid)))
        row[lay.links_col : lay.links_col + lay.n_slots] = u.view(f32)
        row[lay.exit_col] = np.array([u32(exit_cursor)], u32).view(f32)[0]
        return rid

    def _collect_prims(self, g: _Group) -> list:
        if g.is_leaf:
            return [g.payload]
        out = []
        for c in g.children:
            out.extend(self._collect_prims(c))
        return out

    def finalize(self) -> np.ndarray:
        # reverse order: copy_exit fixups for ancestors are inserted after
        # their descendants', and a descendant must copy the ancestor's
        # exit only after the ancestor's own exit has been patched
        for rid, col, spec in reversed(self.fixups):
            if callable(spec):
                val = u32(spec())
            elif isinstance(spec, tuple) and spec[0] == "copy_exit":
                val = np.asarray(
                    self._row(spec[1])[self.layout.exit_col], f32
                ).view(u32)[()]
            else:
                raise ValueError(spec)
            self._row(rid)[col] = np.array([val], u32).view(f32)[0]
        self.fixups = []
        if not self.rows:
            return np.zeros((1, self.layout.w_row), f32)
        return np.stack(self.rows)


class WideStaticRegion:
    """The immutable prefix of the mega table: BLAS wide trees + shared
    leaf chains for every (mesh, blas) pair that can ever be instanced.

    Built ONCE after load_scene; per-frame packing appends only instance
    rows + subframe-TLAS wide trees (build_frame_tail) whose cursors point
    back into this region. Mirrors the reference's split between the static
    BLAS buffers and the per-frame TLAS rebuild (reference: scene.cc:271-718,
    bvh.hh:82-87).
    """

    def __init__(
        self,
        mesh_arrays,
        bvh_nodes: np.ndarray,
        bvh_links: np.ndarray,
        mesh_blas_pairs,
        leaf_bundle: int | None = 8,
        layout: WideLayout = LAYOUT_W8,
    ):
        import sys

        if sys.getrecursionlimit() < 100000:
            sys.setrecursionlimit(100000)
        self.layout = layout
        self.leaf_bundle = leaf_bundle
        nodes = np.asarray(bvh_nodes, f32)
        links_all = np.ascontiguousarray(bvh_links, u32)
        indices, pos = mesh_arrays[0], mesh_arrays[1]

        # (node_offset, node_count) -> (8,) per-octant root cursors
        self.blas_roots: dict = {}

        if _use_native():
            bundle = (
                2 * layout.leaf_tris if leaf_bundle is None else leaf_bundle
            )
            parts = []
            row_cursor = 0
            ok = True
            for mesh, blas in mesh_blas_pairs:
                key = (blas.node_offset, blas.node_count)
                if key in self.blas_roots or blas.node_count == 0:
                    continue
                tri = indices[
                    mesh.index_offset : mesh.index_offset
                    + 3 * mesh.triangle_count
                ].reshape(-1, 3).astype(np.int64) + mesh.base_vertex_offset
                tri9 = pos[tri].reshape(-1, 9).astype(f32)
                res = build_wide_tree_native(
                    links_all[8 * blas.node_offset :
                              8 * blas.node_offset + 8 * blas.node_count],
                    nodes[blas.node_offset :
                          blas.node_offset + blas.node_count],
                    tri9, None, bundle, layout.n_slots, layout.leaf_tris,
                    row_cursor, int(END_BLAS), stub=layout.stub,
                )
                if res is None:
                    ok = False
                    break
                rows, root8 = res
                parts.append(rows)
                self.blas_roots[key] = root8
                row_cursor += len(rows)
            if ok:
                self.rows = (
                    np.concatenate(parts)
                    if parts else np.zeros((1, layout.w_row), f32)
                )
                native_build.builds["wide_native"] += 1
                return
            self.blas_roots = {}

        native_build.builds["wide_python"] += 1
        b = WideBuilder(leaf_bundle=leaf_bundle, layout=layout)
        leaf_cache: dict = {}

        def mesh_leaf_chain(mesh, blas_key, prims):
            # canonical (sorted) order so all 8 octants share one chain;
            # within a bundle only exact-t ties could observe the order
            # (see module docstring). Scoped per (mesh, BLAS) pair, as the
            # JAX package scopes it — keeps the byte-identity
            # contract even if one mesh ever backed two distinct BLAS
            # entries.
            prims = sorted(prims)
            key = (mesh.index_offset, blas_key, tuple(prims))
            if key not in leaf_cache:
                def tri9(p):
                    tri = indices[
                        mesh.index_offset + 3 * p : mesh.index_offset + 3 * p + 3
                    ].astype(np.int64) + mesh.base_vertex_offset
                    return pos[tri].reshape(9)
                leaf_cache[key] = b.build_leaf_chain(list(prims), tri9)
            return layout.make_cursor(KIND_LEAF, leaf_cache[key])

        for mesh, blas in mesh_blas_pairs:
            key = (blas.node_offset, blas.node_count)
            if key in self.blas_roots or blas.node_count == 0:
                continue
            cursors = np.zeros(8, u32)
            for o in range(8):
                lo = 8 * blas.node_offset + o * blas.node_count
                links = links_all[lo : lo + blas.node_count]
                n6 = nodes[
                    blas.node_offset : blas.node_offset + blas.node_count
                ]

                def leaf_target(prims, group, mesh=mesh, blas_key=key):
                    return mesh_leaf_chain(mesh, blas_key, prims)

                rid = b.build_wide_tree(links, n6, 0, leaf_target, END_BLAS)
                cursors[o] = layout.make_cursor(KIND_WIDE, rid)
            self.blas_roots[key] = cursors

        self.rows = b.finalize()     # (S, 48) f32


def _use_native() -> bool:
    """The C++ builder unless ``PT_NATIVE_WIDE`` is set to anything but
    "1" (the JAX package's switch, the same default)."""
    return os.environ.get("PT_NATIVE_WIDE", "1") == "1"


def _inst_rows_np(lay: WideLayout, instances, blas_roots, base: int):
    """Vectorized instance-row block (rows [base, base+I)) + their
    KIND_INST cursors; byte-identical to WideBuilder.build_inst_row."""
    I = len(instances)
    rows = np.zeros((I, lay.w_row), f32)
    if I:
        inv = np.stack([np.asarray(i.inv_transform, f32) for i in instances])
        rows[:, 0:12] = inv[:, :, 0:3].reshape(I, 12)
        roots = np.stack(
            [blas_roots[(i.blas.node_offset, i.blas.node_count)]
             for i in instances]
        ).astype(u32)
        rows[:, 12:20] = roots.view(f32)
        rows[:, 20] = np.arange(I, dtype=np.int32).view(f32)
    cursors = (
        (u32(KIND_INST) << 30)
        | ((base + np.arange(I, dtype=np.int64)).astype(u32) << lay.slot_bits)
    ).astype(u32)
    return rows, cursors


def build_frame_tail(
    static: WideStaticRegion,
    bvh_nodes: np.ndarray,
    bvh_links: np.ndarray,
    instances,
    subframes,
    root_base: int = 0,
):
    """Per-frame mega-table tail: instance rows + subframe TLAS wide trees.

    Tail cursors are absolute into [static.rows; tail], so the device-side
    table is their plain concatenation. Returns (tail (K, w_row) f32 —
    possibly K=0 — and root_by_off ((max_tlas_offset - root_base + 1), 8)
    int32, indexed by ``tlas_offset - root_base``; a frame packer passes the
    static node count so the table covers only the frame's TLAS tail).
    """
    lay = static.layout
    nodes = np.asarray(bvh_nodes, f32)
    links_all = np.ascontiguousarray(bvh_links, u32)
    base = len(static.rows)

    tlas_keys = []
    max_off = root_base
    seen = set()
    for sf in subframes:
        tl = sf.tlas
        max_off = max(max_off, tl.node_offset)
        key = (tl.node_offset, tl.node_count)
        if key not in seen and tl.node_count > 0:
            seen.add(key)
            tlas_keys.append(key)

    # tail indexing is root_by_off[off - root_base]: an offset below
    # root_base (a subframe TLAS sitting inside the static node region)
    # would wrap to a wrong row silently — fail loudly instead
    for off, _ in tlas_keys:
        if off < root_base:
            raise ValueError(
                f"subframe TLAS node_offset {off} < static root_base "
                f"{root_base}; frame-tail invariant violated"
            )

    root_by_off = np.full((max_off - root_base + 1, 8), END_TLAS, u32)

    if _use_native():
        inst_block, inst_cursors = _inst_rows_np(
            lay, instances, static.blas_roots, base
        )
        parts = [inst_block]
        row_cursor = base + len(instances)
        ok = True
        for off, cnt in tlas_keys:
            res = build_wide_tree_native(
                links_all[8 * off : 8 * off + 8 * cnt],
                nodes[off : off + cnt],
                None, inst_cursors, 0, lay.n_slots, lay.leaf_tris,
                row_cursor, int(END_TLAS), stub=lay.stub,
            )
            if res is None:
                ok = False
                break
            rows, root8 = res
            parts.append(rows)
            root_by_off[off - root_base] = root8
            row_cursor += len(rows)
        if ok:
            tail = (
                np.concatenate(parts)
                if parts else np.zeros((0, lay.w_row), f32)
            )
            native_build.builds["wide_native"] += 1
            return tail, root_by_off.view(np.int32)
        root_by_off[:] = END_TLAS

    native_build.builds["wide_python"] += 1
    b = WideBuilder(leaf_bundle=static.leaf_bundle, base=base, layout=lay)

    inst_rows = []
    for inst_id, inst in enumerate(instances):
        key = (inst.blas.node_offset, inst.blas.node_count)
        roots = static.blas_roots[key]
        inv12 = np.asarray(inst.inv_transform, f32)[:, 0:3].reshape(-1)
        inst_rows.append(b.build_inst_row(inv12, inst_id, list(roots)))

    for off, cnt in tlas_keys:
        cursors = np.zeros(8, u32)
        for o in range(8):
            lo = 8 * off + o * cnt
            links = links_all[lo : lo + cnt]
            n6 = nodes[off : off + cnt]

            def leaf_target(prims, group):
                assert len(prims) == 1, "instance slots are not bundled"
                return lay.make_cursor(KIND_INST, inst_rows[prims[0]])

            # instance leaves must never bundle: disable via leaf_bundle=0
            saved = b.leaf_bundle
            b.leaf_bundle = 0
            rid = b.build_wide_tree(links, n6, 0, leaf_target, END_TLAS)
            b.leaf_bundle = saved
            cursors[o] = lay.make_cursor(KIND_WIDE, rid)
        root_by_off[off - root_base] = cursors

    tail = b.finalize() if b.rows else np.zeros((0, lay.w_row), f32)
    return tail, root_by_off.view(np.int32)


def build_wide_tables(
    mesh_arrays,
    bvh_nodes: np.ndarray,
    bvh_links: np.ndarray,
    instances,
    subframes,
    leaf_bundle: int | None = 8,
    layout: WideLayout = LAYOUT_W8,
):
    """Mega-table for a packed scene (same inputs as scene/device.pack_scene).

    Returns (mega (M, 48) f32, root_by_off (max_tlas_offset+1, 8) int32 —
    per-octant TLAS root cursors indexed by tlas node_offset, the handle the
    traversal already carries per lane). One-shot composition of the
    static-region + frame-tail builders used by the animated frame loop.
    """
    static = WideStaticRegion(
        mesh_arrays, bvh_nodes, bvh_links,
        [(i.mesh, i.blas) for i in instances], leaf_bundle=leaf_bundle,
        layout=layout,
    )
    tail, root_by_off = build_frame_tail(
        static, bvh_nodes, bvh_links, instances, subframes
    )
    mega = np.concatenate([static.rows, tail]) if len(tail) else static.rows
    return mega, root_by_off
