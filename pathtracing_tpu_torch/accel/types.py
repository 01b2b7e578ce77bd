"""Flat BVH buffer types (reference: bvh.hh:32-92).

Layout contract consumed by the traversal kernel (and kept identical to the
reference so golden tests can compare byte-for-byte):

  nodes:  (N, 6) float32 — min_x,min_y,min_z,max_x,max_y,max_z per node,
          BFS order within each BVH (reference: bvh.cc:145-168)
  links:  (8N, 2) uint32 — {accept, cancel}; for BVH b the block starts at
          8*b.node_offset, octant o at + o*b.node_count
          (reference: bvh.cc:217-226; consumed at ray_query.hh:139-140)

``accept`` top bit set ⇒ leaf, low 31 bits = primitive/instance index
(reference: bvh.hh:57-67).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BvhHandle:
    """reference: bvh.hh:35-39."""

    node_count: int
    node_offset: int


@dataclasses.dataclass
class BvhBuffers:
    """Append-only shared node/link storage (reference: bvh.hh:88-92)."""

    nodes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 6), np.float32)
    )
    links: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.uint32)
    )

    def append(self, nodes: np.ndarray, links: np.ndarray) -> BvhHandle:
        handle = BvhHandle(node_count=len(nodes), node_offset=len(self.nodes))
        self.nodes = np.concatenate([self.nodes, nodes.astype(np.float32)])
        self.links = np.concatenate([self.links, links.astype(np.uint32)])
        assert len(self.links) == 8 * len(self.nodes)
        return handle

    def pop(self, handle: BvhHandle) -> None:
        """reference: bvh.cc:286-292 — free the *last* BVH only."""
        if handle.node_count == 0:
            return
        self.nodes = self.nodes[: handle.node_offset]
        self.links = self.links[: handle.node_offset * 8]
        handle.node_count = 0


LEAF_BIT = np.uint32(0x80000000)
SENTINEL = np.uint32(0xFFFFFFFF)
