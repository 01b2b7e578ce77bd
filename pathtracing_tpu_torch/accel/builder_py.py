"""Host-side sweep-SAH BVH builder (numpy reference implementation).

Reproduces the reference builder's output byte-for-byte
(reference: bvh.cc:43-229): full-sweep SAH with deterministic centroid
sorting (tie-break by leaf index, bvh.cc:28-41), multi-leaf termination when
``leaf_count <= min_cost/root_area + 2``, breadth-first node flattening, and
eight per-octant stackless link tables.

A faster C++ builder with identical output lives in accel/native.py; this
module is the semantic ground truth and the fallback when no compiler is
available. The JAX package's ``accel/builder_py.py``, the same bytes.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch.accel.native import build_bvh_native
from pathtracing_tpu_torch.accel.types import BvhBuffers, BvhHandle
from pathtracing_tpu_torch.utils import native_build
from pathtracing_tpu_torch.utils.hostmath import mul_m4v4

f32 = np.float32


class _BuildNode:
    __slots__ = ("bmin", "bmax", "leaf_count", "axis", "index", "children")

    def __init__(self, bmin, bmax, leaf_count=0, axis=-1):
        self.bmin = bmin
        self.bmax = bmax
        self.leaf_count = leaf_count  # repurposed: primitive index for leaves
        self.axis = axis
        self.index = 0
        self.children: list = []


def _sort_order(lmin, lmax, lidx, axis):
    """std::sort by centroid then index (reference: bvh.cc:28-41)."""
    centroid = (lmax[:, axis] + lmin[:, axis]).astype(f32)
    return np.lexsort((lidx, centroid))


def _areas(smin, smax):
    s = (smax - smin).astype(f32)
    # s.x*s.y + s.z*s.x + s.y*s.z, left-to-right f32 (reference: bvh.cc:93)
    return ((s[:, 0] * s[:, 1] + s[:, 2] * s[:, 0]) + s[:, 1] * s[:, 2]).astype(
        f32
    )


def _build_recursive_sah(lmin, lmax, lidx, self_node: _BuildNode) -> None:
    """reference: bvh.cc:43-143."""
    n = len(lidx)
    self_node.axis = -1
    self_node.leaf_count = n

    if n == 1:
        self_node.leaf_count = int(lidx[0])
        return

    # Sweep all three axes; track the global best split with strict '<' in
    # (axis-major, split-minor) iteration order (reference: bvh.cc:65-106).
    best = None  # (cost, axis, split, b0min, b0max, b1min, b1max, order)
    last_order = None
    for axis in range(3):
        order = _sort_order(lmin, lmax, lidx, axis)
        smin, smax = lmin[order], lmax[order]
        first_min = np.minimum.accumulate(smin[: n - 1], axis=0)
        first_max = np.maximum.accumulate(smax[: n - 1], axis=0)
        rev_min = np.minimum.accumulate(smin[:0:-1], axis=0)[::-1]
        rev_max = np.maximum.accumulate(smax[:0:-1], axis=0)[::-1]
        area0 = _areas(first_min, first_max)
        area1 = _areas(rev_min, rev_max)
        counts0 = np.arange(1, n, dtype=np.uint32).astype(f32)
        counts1 = np.arange(n - 1, 0, -1, dtype=np.uint32).astype(f32)
        cost = (counts0 * area0 + counts1 * area1).astype(f32)
        i = int(np.argmin(cost))
        c = cost[i]
        if best is None or c < best[0]:
            best = (
                c,
                axis,
                i + 1,
                first_min[i].copy(),
                first_max[i].copy(),
                rev_min[i].copy(),
                rev_max[i].copy(),
            )
        last_order = order
        lmin, lmax, lidx = smin, smax, lidx[order]  # leaves stay sorted

    min_cost, best_axis, min_split, b0min, b0max, b1min, b1max = best
    self_node.axis = best_axis

    size = (self_node.bmax - self_node.bmin).astype(f32)
    root_area = f32((size[0] * size[1] + size[2] * size[0]) + size[1] * size[2])
    min_cost = f32(min_cost / root_area)
    # Traversal constant 2.0 (reference: bvh.cc:110-112).
    min_cost = f32(min_cost + f32(2.0))

    make_leaves = f32(n) <= min_cost
    if make_leaves:
        # Multi-leaf node sorted along the longest axis
        # (reference: bvh.cc:113-130).
        self_node.axis = 2
        if size[0] > size[1] and size[0] > size[2]:
            self_node.axis = 0
        elif size[1] > size[2]:
            self_node.axis = 1

    order = _sort_order(lmin, lmax, lidx, self_node.axis)
    lmin, lmax, lidx = lmin[order], lmax[order], lidx[order]

    if make_leaves:
        for i in range(n):
            self_node.children.append(
                _BuildNode(lmin[i], lmax[i], int(lidx[i]), -1)
            )
    else:
        c0 = _BuildNode(b0min, b0max)
        c1 = _BuildNode(b1min, b1max)
        self_node.children = [c0, c1]
        _build_recursive_sah(
            lmin[:min_split], lmax[:min_split], lidx[:min_split], c0
        )
        _build_recursive_sah(
            lmin[min_split:], lmax[min_split:], lidx[min_split:], c1
        )


def _flatten_bfs(root: _BuildNode):
    """BFS node order; assigns .index (reference: bvh.cc:145-168)."""
    nodes = []
    layer = [root]
    while layer:
        next_layer = []
        for node in layer:
            node.index = len(nodes)
            nodes.append(
                (
                    node.bmin[0],
                    node.bmin[1],
                    node.bmin[2],
                    node.bmax[0],
                    node.bmax[1],
                    node.bmax[2],
                )
            )
            next_layer.extend(node.children)
        layer = next_layer
    return np.array(nodes, f32).reshape(-1, 6)


def _save_links(signs, branch: _BuildNode, cancel: int, links: np.ndarray):
    """One octant's link table (reference: bvh.cc:170-193)."""
    if not branch.children:
        links[branch.index, 0] = np.uint32(0x80000000) | np.uint32(
            branch.leaf_count
        )
        links[branch.index, 1] = cancel
        return
    reverse = not signs[branch.axis]
    k = len(branch.children)
    for i in range(k):
        child = branch.children[k - 1 - i] if reverse else branch.children[i]
        if i == 0:
            links[branch.index, 0] = child.index
            links[branch.index, 1] = cancel
        if i < k - 1:
            nxt = branch.children[k - 2 - i] if reverse else branch.children[i + 1]
            next_index = nxt.index
        else:
            next_index = cancel
        _save_links(signs, child, next_index, links)


def build_from_leaves_py(lmin, lmax, lidx):
    """Pure-numpy build: leaves -> (nodes (N,6) f32, links (8N,2) u32)."""
    import sys

    if sys.getrecursionlimit() < 100000:
        sys.setrecursionlimit(100000)
    root = _BuildNode(
        lmin.min(axis=0).astype(f32), lmax.max(axis=0).astype(f32)
    )
    _build_recursive_sah(
        lmin.astype(f32), lmax.astype(f32), lidx.astype(np.uint32), root
    )

    nodes = _flatten_bfs(root)
    n = len(nodes)
    links = np.zeros((8 * n, 2), np.uint32)
    for octant in range(8):
        signs = (bool(octant & 1), bool(octant & 2), bool(octant & 4))
        _save_links(
            signs, root, np.uint32(0xFFFFFFFF), links[octant * n : (octant + 1) * n]
        )
    return nodes, links


def build_from_leaves(lmin, lmax, lidx):
    """Native C++ builder when available, numpy otherwise (same output)."""
    result = build_bvh_native(lmin, lmax, lidx)
    if result is not None:
        native_build.builds["bvh_native"] += 1
        return result
    native_build.builds["bvh_python"] += 1
    return build_from_leaves_py(lmin, lmax, lidx)


def _build_generic(lmin, lmax, lidx, bc: BvhBuffers) -> BvhHandle:
    """reference: bvh.cc:195-229."""
    nodes, links = build_from_leaves(lmin, lmax, lidx)
    return bc.append(nodes, links)


def compute_blas_leaves(mesh, mesh_bufs):
    """Triangle AABB leaves for a mesh (reference: bvh.cc:233-248)."""
    indices, pos = mesh_bufs[0], mesh_bufs[1]
    tri = indices[
        mesh.index_offset : mesh.index_offset + mesh.triangle_count * 3
    ].reshape(-1, 3)
    p = pos[mesh.base_vertex_offset :][tri]  # (T, 3, 3)
    lmin = p.min(axis=1).astype(f32)
    lmax = p.max(axis=1).astype(f32)
    lidx = np.arange(mesh.triangle_count, dtype=np.uint32)
    return lmin, lmax, lidx


def build_blas(mesh, mesh_bufs, bc: BvhBuffers) -> BvhHandle:
    """One leaf per triangle AABB (reference: bvh.cc:231-250).

    ``mesh_bufs`` is (indices, pos, ...) flat arrays from MeshBuffers.arrays().
    """
    lmin, lmax, lidx = compute_blas_leaves(mesh, mesh_bufs)
    return _build_generic(lmin, lmax, lidx, bc)


def build_tlas(instances, indices, bc_nodes: np.ndarray, bc: BvhBuffers) -> BvhHandle:
    """One leaf per instance: world AABB of the 8 transformed corners of the
    BLAS root AABB (reference: bvh.cc:252-284).

    instances: list of TlasInstance (scene.types); indices: per-instance user
    index stored in the leaf; bc_nodes: node array holding the BLAS roots.
    """
    lmin = np.empty((len(instances), 3), f32)
    lmax = np.empty((len(instances), 3), f32)
    for i, inst in enumerate(instances):
        node = bc_nodes[inst.blas.node_offset]
        bounds = np.array([node[:3], node[3:6]], f32)  # [min, max]
        cmin = None
        cmax = None
        for a in range(8):
            corner = np.array(
                [
                    bounds[a & 1, 0],
                    bounds[0 if a & 2 else 1, 1],
                    bounds[0 if a & 4 else 1, 2],
                    1.0,
                ],
                f32,
            )
            v = mul_m4v4(inst.transform, corner)[:3]
            cmin = v if cmin is None else np.minimum(cmin, v)
            cmax = v if cmax is None else np.maximum(cmax, v)
        lmin[i] = cmin
        lmax[i] = cmax
    lidx = np.asarray(indices, np.uint32)
    return _build_generic(lmin, lmax, lidx, bc)
