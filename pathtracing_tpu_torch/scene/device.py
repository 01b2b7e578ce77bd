"""Device-resident scene: row-gatherable tables as a NamedTuple of tensors.

The reference passes raw pointers to flattened buffers into the kernel
(reference: main.cc:26-38, path_tracer.hh:306-319). Here every hot lookup is
packed into one row, so a ray-query step or a shading fetch reads whole rows
(the CUDA ray query reads them as 16-byte vectors):

  nl8     (8N, 8)  node AABB + {accept, cancel} fused per (octant, node),
                   indexed by the link index (reference layout bvh.cc:217-226)
  nl5     (8N, 5)  optional (``with_bf16_nodes``): the same rows in 20 B,
                   the AABB as bf16 halves rounded outward + the two links
  tri_pos (T, 12)  triangle vertex positions by global triangle id
  inst_f  (I, 21)  inv_transform columns (12) + rotation rows (9)
  inst_u  (I, 6)   blas count/offset, index_offset, base_vertex, tri_offset
  vattr   (V, 12)  normal(3) + albedo(4) + material(4) + pad
  sf_*    (S, _)   per-subframe TLAS handle, camera, light rows
and, for a scene packed with ``wide=True``:
  wide_rows (M, w_row)  the wide-BVH mega-table (accel/wide.py)
  wide_root (K, 8)      per-octant TLAS root cursors by tlas node_offset
  tri_shade (T, 48)     per triangle: 3 x 11 vertex attributes + 9 positions

The packers are numpy on the host and produce the same bytes as the JAX
package's; only the upload differs. ``DevicePacker`` is the animated frame
loop's packer: the static tables go to the device once, and each frame
uploads only its tail (instance rows, subframe rows, the TLAS tail of
``nl8`` and of the mega-table), concatenated to the static part on the
device. ``nl8[:, 6:8]`` hold int32 link bit
patterns (small ids are subnormals, some patterns are NaNs), and so do the
link, prim-id and instance-id columns of ``wide_rows``: they are copied and
bit-viewed, never sent through a float op.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.accel.wide import (
    END_TLAS,
    LAYOUT_S8,
    LAYOUT_W8,
    LAYOUT_W16,
    WideStaticRegion,
    build_frame_tail,
    build_wide_tables,
)

Array = Any
f32 = np.float32


class SceneDevice(NamedTuple):
    nl8: Array        # (8N, 8) f32; cols 6,7 are int32 bit patterns
    tri_pos: Array    # (T, 12) f32
    tri_idx: Array    # (T, 4) int32 — absolute vertex ids [i0,i1,i2,pad]
    inst_f: Array     # (I, 21) f32
    inst_u: Array     # (I, 6) int32
    vattr: Array      # (V, 12) f32
    sf_tlas_count: Array  # (S,) int32
    sf_tlas_offset: Array
    sf_cam: Array     # (S, 18) f32
    sf_light: Array   # (S, 7) f32
    # Optional tables, in the JAX package's field order. nl5: the bf16 node
    # rows of with_bf16_nodes (every binary walk then reads them in place of
    # nl8; a scene with wide tables walks those and ignores nl5). The
    # emissive-light tables (lt_*) come from pack_scene(emissive_nee=True)
    # (ops/arealights.py). hot_rows / hot_planes: DevicePacker(hot_rows=)'s
    # copy of the permuted mega-table's prefix [0, H) (accel/hotperm.py),
    # and the same words as four int8 byte planes, packed as the JAX
    # package packs them for its one-hot fetch; the port's walks read those
    # rows from wide_rows itself.
    nl5: Array | None = None      # (8N, 5) f32; cols 0-2 bf16 pairs, 3-4 bits
    # Wide-BVH tables (pack_scene(wide=True)); wide_root_base stays None for
    # a one-shot pack (wide_root is indexed by the tlas offset itself).
    wide_rows: Array | None = None   # (M, w_row) f32; link columns are bits
    wide_root: Array | None = None   # (K, 8) int32 cursor bits
    wide_root_base: Array | None = None
    tri_shade: Array | None = None   # (T, 48) f32
    lt_tris: Array | None = None
    lt_rows: Array | None = None
    lt_cdf: Array | None = None
    lt_seg: Array | None = None
    lt_rank: Array | None = None
    hot_rows: Array | None = None
    hot_planes: Array | None = None


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Upload a host table bit-exactly (a byte copy, no float op). Always a
    copy: the tensor never aliases the caller's (maybe read-only) array."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _concat_rows_bitsafe(static_dev: torch.Tensor, tail_host: np.ndarray) -> torch.Tensor:
    """A device-resident f32 table with a host tail appended below it,
    concatenated as int32: the tables carry uint32 link and cursor bit
    patterns viewed as f32 (small row ids are subnormal patterns, some are
    NaNs), and an int32 copy keeps every bit whatever the device does with
    subnormal floats (the JAX package's rule: its TPU's f32 concatenate
    flushed them). The tail is uploaded to ``static_dev``'s device."""
    tail = to_device(np.ascontiguousarray(tail_host, f32).view(np.int32),
                     static_dev.device)
    return torch.cat([static_dev.view(torch.int32), tail]).view(torch.float32)


def _hot_byte_planes(rows_f32: np.ndarray) -> np.ndarray:
    """(H, W) f32 rows -> (H, 4W) int8: the rows' u32 words split into four
    byte planes, each biased by -128 so it fits int8 (the JAX package's
    operand of its one-hot hot-row fetch)."""
    u = np.ascontiguousarray(rows_f32, f32).view(np.uint32)
    planes = [
        (((u >> (8 * b)) & 0xFF).astype(np.int32) - 128).astype(np.int8)
        for b in range(4)
    ]
    return np.concatenate(planes, axis=1)


def _round_bf16_down(x: np.ndarray) -> np.ndarray:
    """Largest bf16 <= x, as f32 bit patterns >> 16 (uint32)."""
    bits = np.ascontiguousarray(x, f32).view(np.uint32)
    inexact = (bits & np.uint32(0xFFFF)) != 0
    trunc = bits >> 16
    neg = (bits >> 31).astype(bool)
    # toward zero == down for x>0; for x<0 grow the magnitude when inexact
    return trunc + (inexact & neg).astype(np.uint32)


def _round_bf16_up(x: np.ndarray) -> np.ndarray:
    """Smallest bf16 >= x, as f32 bit patterns >> 16 (uint32)."""
    bits = np.ascontiguousarray(x, f32).view(np.uint32)
    inexact = (bits & np.uint32(0xFFFF)) != 0
    trunc = bits >> 16
    neg = (bits >> 31).astype(bool)
    return trunc + (inexact & ~neg).astype(np.uint32)


def pack_nl5(nl8: np.ndarray) -> np.ndarray:
    """Compress an nl8 table to (8N, 5): bf16 AABB pairs + the two links.

    Columns 0-2 each hold two bf16 halves (value-preserving in the high 16
    bits of an f32): [min.x|min.y, min.z|max.x, max.y|max.z]. min is rounded
    toward -inf, max toward +inf, so every bf16 box contains its f32 box.
    Columns 3-4 are the accept/cancel bit patterns unchanged.
    """
    nl8 = np.asarray(nl8, f32)
    lo = _round_bf16_down(nl8[:, 0:3])   # min.xyz
    hi = _round_bf16_up(nl8[:, 3:6])     # max.xyz
    six = np.concatenate([lo, hi], axis=1)  # minx miny minz maxx maxy maxz
    out = np.zeros((len(nl8), 5), f32)
    packed = (six[:, 0::2] << 16) | six[:, 1::2]
    out[:, 0:3] = packed.view(f32)
    out[:, 3:5] = nl8[:, 6:8]
    return out


def _pack_nl5_tensor(nl8: torch.Tensor) -> torch.Tensor:
    """``pack_nl5`` on the table's own device, in exact integer arithmetic:
    each f32 is taken as its uint32 bit pattern in an int64, rounded to a
    bf16 half as ``_round_bf16_down`` / ``_round_bf16_up`` round it (the
    rounding may carry into bit 16, as the numpy version's does), the pairs
    joined modulo 2^32 and stored back as int32 bits. No value passes through
    a float op, so NaN-pattern links and NaN bounds keep every bit."""
    words = nl8.contiguous().view(torch.int32)
    bits = words[:, 0:6].to(torch.int64) & 0xFFFFFFFF  # minxyz maxxyz
    inexact = (bits & 0xFFFF) != 0
    neg = (bits >> 31) != 0
    up = torch.arange(6, device=nl8.device) >= 3  # max.xyz round up, min.xyz down
    half = (bits >> 16) + (inexact & (neg != up)).to(torch.int64)
    packed = ((half[:, 0::2] << 16) | half[:, 1::2]) & 0xFFFFFFFF
    packed = (packed - ((packed >> 31) << 32)).to(torch.int32)
    return torch.cat([packed, words[:, 6:8]], dim=1).view(torch.float32)


def with_bf16_nodes(scene: SceneDevice) -> SceneDevice:
    """A copy of the scene with the compressed node table attached (``nl5``).

    The JAX package packs on the host (``pack_nl5`` of the fetched ``nl8``)
    and uploads; here the rows are packed where ``nl8`` lies, in exact
    integer ops, byte for byte ``pack_nl5``'s. It takes a one-shot pack and
    a ``DevicePacker`` frame scene alike (its ``nl8`` is the static rows and
    the frame's tail, concatenated)."""
    return scene._replace(nl5=_pack_nl5_tensor(scene.nl8))


def _instance_rows(instances, pad_to: int = 1):
    I = max(len(instances), pad_to, 1)
    inst_f = np.zeros((I, 21), f32)
    inst_u = np.zeros((I, 6), np.int32)
    for i, inst in enumerate(instances):
        inv = inst.inv_transform.astype(f32)
        # columns 0..2 of all 4 rows (used by mul_m4v4/mul_m3v3 forms,
        # reference: ray_query.hh:159-165)
        inst_f[i, 0:12] = inv[:, 0:3].reshape(-1)
        inst_f[i, 12:21] = inst.transform[:3, :3].astype(f32).reshape(-1)
        inst_u[i, 0:5] = (
            inst.blas.node_count,
            inst.blas.node_offset,
            inst.mesh.index_offset,
            inst.mesh.base_vertex_offset,
            inst.mesh.index_offset // 3,
        )
    return inst_f, inst_u


def pack_nl8(bvh_nodes, bvh_links, segments) -> np.ndarray:
    """Fused node+link rows for every traversable BVH segment.

    segments: iterable of (node_offset, node_count). Rows of BVHs that are
    never traversed are left zero (never read).
    """
    nodes = bvh_nodes.astype(f32)
    links_bits = np.ascontiguousarray(bvh_links, np.uint32).view(f32)
    out = np.zeros((8 * len(nodes), 8), f32)
    seen = set()
    for offset, count in segments:
        if count == 0 or (offset, count) in seen:
            continue
        seen.add((offset, count))
        block = slice(8 * offset, 8 * offset + 8 * count)
        out[block, 0:6] = np.tile(nodes[offset : offset + count], (8, 1))
        out[block, 6:8] = links_bits[block]
    return out


def pack_tri_tables(indices, pos, meshes):
    """(T, 12) packed triangle vertices + (T, 4) absolute vertex ids,
    both in global triangle order (index_offset/3 + prim).

    meshes: iterable of MeshHandle covering the triangles that can be hit.
    """
    t_total = max(len(indices) // 3, 1)
    out_pos = np.zeros((t_total, 12), f32)
    out_idx = np.zeros((t_total, 4), np.int32)
    seen = set()
    for m in meshes:
        key = (m.index_offset, m.triangle_count)
        if m.triangle_count == 0 or key in seen:
            continue
        seen.add(key)
        tri = indices[
            m.index_offset : m.index_offset + 3 * m.triangle_count
        ].reshape(-1, 3).astype(np.int64) + m.base_vertex_offset
        p = pos[tri]  # (t, 3, 3)
        t0 = m.index_offset // 3
        out_pos[t0 : t0 + m.triangle_count, 0:9] = p.reshape(-1, 9)
        out_idx[t0 : t0 + m.triangle_count, 0:3] = tri
    return out_pos, out_idx


def pack_tri_shade(indices, pos, normal, albedo, material, meshes):
    """(T, 48) packed shading rows in global triangle order: per vertex
    [normal(3), albedo(4), material(4)] (33 f32) then the 9 vertex
    positions; one row read serves a whole hit's shading fetch."""
    t_total = max(len(indices) // 3, 1)
    out = np.zeros((t_total, 48), f32)
    seen = set()
    for m in meshes:
        key = (m.index_offset, m.triangle_count)
        if m.triangle_count == 0 or key in seen:
            continue
        seen.add(key)
        tri = indices[
            m.index_offset : m.index_offset + 3 * m.triangle_count
        ].reshape(-1, 3).astype(np.int64) + m.base_vertex_offset
        t0 = m.index_offset // 3
        sl = slice(t0, t0 + m.triangle_count)
        for v in range(3):
            base = 11 * v
            out[sl, base : base + 3] = normal[tri[:, v]]
            out[sl, base + 3 : base + 7] = albedo[tri[:, v]]
            out[sl, base + 7 : base + 11] = material[tri[:, v]]
        out[sl, 33:42] = pos[tri].reshape(-1, 9)
    return out


def pack_vattr(normal, albedo, material) -> np.ndarray:
    v = max(len(normal), 1)
    out = np.zeros((v, 12), f32)
    if len(normal):
        out[:, 0:3] = normal
        out[:, 3:7] = albedo
        out[:, 7:11] = material
    return out


def _wide_layout(name):
    if not isinstance(name, str):
        return name
    return {"w8": LAYOUT_W8, "w16": LAYOUT_W16, "s8": LAYOUT_S8}[name]


def attach_wide(
    scene: SceneDevice,
    mesh_arrays,
    bvh_nodes,
    bvh_links,
    instances,
    subframes,
    leaf_bundle: int | None = 8,
    layout="w8",
) -> SceneDevice:
    """Attach the wide-BVH mega-table (accel/wide.py) and the packed shading
    rows to a packed scene, on the scene's device."""
    mega, root_by_off = build_wide_tables(
        mesh_arrays, bvh_nodes, bvh_links, instances, subframes,
        leaf_bundle=leaf_bundle, layout=_wide_layout(layout),
    )
    device = scene.nl8.device
    tri_shade = pack_tri_shade(*mesh_arrays, [i.mesh for i in instances])
    return scene._replace(
        wide_rows=to_device(mega, device), wide_root=to_device(root_by_off, device),
        tri_shade=to_device(tri_shade, device),
    )


def binary_tables(scene: SceneDevice) -> SceneDevice:
    """A scene packed with both table kinds, as the binary walks see it: the
    same tensors without the wide ones."""
    return scene._replace(wide_rows=None, wide_root=None, tri_shade=None)


def pack_scene(
    mesh_arrays,
    bvh_nodes: np.ndarray,
    bvh_links: np.ndarray,
    instances,
    subframes,
    emissive_nee: bool = False,
    wide: bool = False,
    leaf_bundle: int | None = 8,
    wide_layout="w8",
    device=None,
) -> SceneDevice:
    """Pack host scene state into device tensors.

    mesh_arrays: (indices, pos, normal, albedo, material) flat numpy arrays.
    subframes: list of scene.types.Subframe. ``device=None`` means CUDA and
    raises when there is none. ``wide=True`` also builds the wide-BVH
    mega-table in ``wide_layout`` ("w8", "w16", "s8" or a WideLayout) and the
    packed shading rows; ``ray_query`` then walks the mega-table.
    ``emissive_nee=True`` also builds the area-light NEE tables
    (ops/arealights.build_light_table; none for a scene without emissive
    triangles): every path renderer then samples the emitters (opt-in: it
    changes the RNG stream).
    """
    device = resolve_device(device)
    indices, pos, normal, albedo, material = mesh_arrays
    inst_f, inst_u = _instance_rows(instances)

    lt = {}
    if emissive_nee:
        from pathtracing_tpu_torch.ops.arealights import build_light_table

        table = build_light_table(mesh_arrays, instances)
        if table is not None:
            lt = {k: to_device(v, device) for k, v in table.items()}

    segments = [(i.blas.node_offset, i.blas.node_count) for i in instances]
    segments += [(sf.tlas.node_offset, sf.tlas.node_count) for sf in subframes]

    sf_tlas, sf_cam, sf_light = _subframe_rows(subframes)

    tri_pos, tri_idx = pack_tri_tables(
        indices, pos, [i.mesh for i in instances]
    )
    dev = lambda a: to_device(a, device)
    scene = SceneDevice(
        nl8=dev(pack_nl8(bvh_nodes, bvh_links, segments)),
        tri_pos=dev(tri_pos),
        tri_idx=dev(tri_idx),
        inst_f=dev(inst_f),
        inst_u=dev(inst_u),
        vattr=dev(pack_vattr(normal, albedo, material)),
        sf_tlas_count=dev(sf_tlas[:, 0]),
        sf_tlas_offset=dev(sf_tlas[:, 1]),
        sf_cam=dev(sf_cam),
        sf_light=dev(sf_light),
        **lt,
    )
    if wide:
        scene = attach_wide(
            scene, mesh_arrays, bvh_nodes, bvh_links, instances, subframes,
            leaf_bundle=leaf_bundle, layout=wide_layout,
        )
    return scene


def _subframe_rows(subframes):
    S = max(len(subframes), 1)
    sf_tlas = np.zeros((S, 2), np.int32)
    sf_cam = np.zeros((S, 18), f32)
    sf_light = np.zeros((S, 7), f32)
    for i, sf in enumerate(subframes):
        sf_tlas[i] = (sf.tlas.node_count, sf.tlas.node_offset)
        c = sf.cam
        sf_cam[i, 0:9] = np.asarray(c.orientation, f32).reshape(-1)
        sf_cam[i, 9:12] = np.asarray(c.position, f32)
        sf_cam[i, 12] = c.aspect_ratio
        sf_cam[i, 13] = c.inv_focal_length
        sf_cam[i, 14] = c.focal_distance
        sf_cam[i, 15] = c.aperture_angle
        sf_cam[i, 16] = float(c.aperture_polygon)
        sf_cam[i, 17] = c.aperture_radius
        sf_light[i, 0:3] = np.asarray(sf.light.direction, f32)
        sf_light[i, 3:6] = np.asarray(sf.light.color, f32)
        sf_light[i, 6] = sf.light.cos_solid_angle
    return sf_tlas, sf_cam, sf_light


class DevicePacker:
    """Incremental frame packing for the animated scene (the JAX package's
    ``DevicePacker``, the same tables byte for byte).

    The mesh/BLAS region of the buffers is immutable after load_scene; only
    the per-frame TLAS tail, the instance list, and the subframe rows
    change (reference: scene.cc:271-718). The static tables are uploaded
    once to ``device`` (None: CUDA, raising when there is none); per frame
    only the small tail is packed on the host, uploaded, and concatenated
    on the device.

    wide=True adds the mega-table (accel/wide.WideStaticRegion +
    build_frame_tail); with ``chunk_max`` set the chunked static region
    (accel/chunks.py: meshes split into subtrees of at most ``chunk_max``
    triangles, ``chunks.CHUNK_MAX`` = 1024 for the CLI, an instance-split
    static TLAS built here once, per-frame tails carrying only the dynamic
    instances), with its options ``octants`` (8, or 1: octant 0's trees
    only) and ``bake_static`` (the static instances' chunks in world
    space; needs the native wide builder). ``hot_rows=H`` (chunked regions
    only, else ValueError) permutes the static rows so the H hottest sit at
    [0, H) (accel/hotperm.py; by ``hot_score`` when given, else the
    structural order) and fills ``hot_rows`` / ``hot_planes`` of every
    frame scene; the walks are unchanged and their results bit-identical
    to the unpermuted pack.
    """

    # shape-stability buckets, kept from the JAX package (where every
    # animation frame reuses one compiled kernel) so the tables stay byte
    # for byte its tables: per-frame tails/tables are padded up to these
    # multiples.
    _NODE_BUCKET = 256     # binary-node tail granularity (nl8 rows = 8x)
    _WIDE_BUCKET = 256     # mega-table tail rows
    _ROOT_BUCKET = 64      # wide_root rows (indexed by tlas node_offset)
    _INST_BUCKET = 8       # instance rows

    def __init__(self, scene, wide: bool = False, leaf_bundle: int | None = 8,
                 wide_layout="w8", chunk_max: int | None = None,
                 octants: int = 8, hot_rows: int = 0, hot_score=None,
                 bake_static: bool = False, device=None):
        if hot_rows and not (wide and chunk_max):
            # the plain WideStaticRegion predates the chunk TLAS and has no
            # root map to rewrite
            raise ValueError("hot_rows needs chunk_max (the chunked static "
                             "region, wide=True)")
        self.device = device = resolve_device(device)
        mesh_arrays = scene.mesh_buf.arrays()
        indices, pos, normal, albedo, material = mesh_arrays
        blas_segments = [
            (blas.node_offset, blas.node_count)
            for (_, blas) in scene.meshes.values()
        ]
        # static region = the BLAS span; any subframe TLAS tail present at
        # construction time is excluded (it is re-packed per frame)
        self._static_node_count = max(
            (off + cnt for off, cnt in blas_segments), default=0
        )
        n = self._static_node_count
        dev = lambda a: to_device(a, device)
        self._static_nl8 = dev(
            pack_nl8(
                scene.bvh_buf.nodes[:n],
                scene.bvh_buf.links[: 8 * n],
                blas_segments,
            )
        )
        meshes = [m for (m, _) in scene.meshes.values()]
        tri_pos, tri_idx = pack_tri_tables(indices, pos, meshes)
        self._tri_pos = dev(tri_pos)
        self._tri_idx = dev(tri_idx)
        self._vattr = dev(pack_vattr(normal, albedo, material))

        self._wide_static = None
        self._chunked = False
        if wide:
            if chunk_max:
                # Chunked fast path (accel/chunks.py): instance-split
                # static TLAS built once here; per-frame tails carry only
                # the dynamic instances. Traversal format is identical.
                from pathtracing_tpu_torch.accel.chunks import ChunkedStaticRegion

                self._wide_static = ChunkedStaticRegion(
                    mesh_arrays,
                    scene.bvh_buf.nodes[:n],
                    scene.bvh_buf.links[: 8 * n],
                    list(scene.meshes.values()),
                    scene.instances[: scene.static_instance_count],
                    leaf_bundle=leaf_bundle,
                    layout=_wide_layout(wide_layout),
                    chunk_max=chunk_max,
                    octants=octants,
                    bake_static=bake_static,
                )
                self._chunked = True
            else:
                self._wide_static = WideStaticRegion(
                    mesh_arrays,
                    scene.bvh_buf.nodes[:n],
                    scene.bvh_buf.links[: 8 * n],
                    list(scene.meshes.values()),
                    leaf_bundle=leaf_bundle,
                    layout=_wide_layout(wide_layout),
                )
            self._hot_dev = self._hot_planes_dev = None
            if hot_rows:
                from pathtracing_tpu_torch.accel.hotperm import apply_hot_permutation

                apply_hot_permutation(self._wide_static, hot_rows, score=hot_score)
                hot = self._wide_static.rows[: self._wide_static.hot_count]
                self._hot_dev = dev(hot)
                self._hot_planes_dev = dev(_hot_byte_planes(hot))
            self._wide_static_dev = dev(self._wide_static.rows)
            self._tri_shade = dev(
                pack_tri_shade(indices, pos, normal, albedo, material, meshes)
            )
            self._root_base = torch.tensor(n, dtype=torch.int32, device=device)

    @staticmethod
    def _bucket(n: int, b: int) -> int:
        return -(-max(n, 1) // b) * b

    def pack_frame(self, scene) -> SceneDevice:
        """Pack the current frame state (after setup_animation_frame)."""
        n_static = self._static_node_count
        nodes = scene.bvh_buf.nodes
        links = scene.bvh_buf.links
        tail_nodes = len(nodes) - n_static
        if tail_nodes > 0:
            # tail rows live at link indices >= 8*n_static; build only them.
            # Padded to _NODE_BUCKET; pad rows are zero and unreachable (no
            # link targets them).
            tail_cap = self._bucket(tail_nodes, self._NODE_BUCKET)
            tail = np.zeros((8 * tail_cap, 8), f32)
            tail_links = np.ascontiguousarray(
                links[8 * n_static :], np.uint32
            ).view(f32)
            for sf in scene.subframes:
                off, cnt = sf.tlas.node_offset, sf.tlas.node_count
                if cnt == 0:
                    continue
                lo = 8 * off - 8 * n_static
                tail[lo : lo + 8 * cnt, 0:6] = np.tile(
                    nodes[off : off + cnt], (8, 1)
                )
                tail[lo : lo + 8 * cnt, 6:8] = tail_links[lo : lo + 8 * cnt]
            nl8 = _concat_rows_bitsafe(self._static_nl8, tail)
        else:
            nl8 = self._static_nl8

        inst_f, inst_u = _instance_rows(
            scene.instances,
            pad_to=self._bucket(len(scene.instances), self._INST_BUCKET),
        )
        sf_tlas, sf_cam, sf_light = _subframe_rows(scene.subframes)
        dev = lambda a: to_device(a, self.device)
        out = SceneDevice(
            nl8=nl8,
            tri_pos=self._tri_pos,
            tri_idx=self._tri_idx,
            inst_f=dev(inst_f),
            inst_u=dev(inst_u),
            vattr=self._vattr,
            sf_tlas_count=dev(sf_tlas[:, 0]),
            sf_tlas_offset=dev(sf_tlas[:, 1]),
            sf_cam=dev(sf_cam),
            sf_light=dev(sf_light),
        )
        if self._wide_static is not None:
            if self._chunked:
                from pathtracing_tpu_torch.accel.chunks import (
                    build_frame_tail_chunked,
                )

                tail_rows, root_by_off = build_frame_tail_chunked(
                    self._wide_static, scene.instances, scene.subframes,
                    scene.subframe_entries,
                    (scene.static_instance_count, scene.frame_static_end),
                    scene.static_instance_count, root_base=n_static,
                )
            else:
                tail_rows, root_by_off = build_frame_tail(
                    self._wide_static, nodes, links, scene.instances,
                    scene.subframes, root_base=n_static,
                )
            cap = self._bucket(len(tail_rows), self._WIDE_BUCKET)
            if len(tail_rows) < cap:
                tail_rows = np.concatenate(
                    [tail_rows, np.zeros((cap - len(tail_rows), tail_rows.shape[1]), f32)]
                )
            rcap = self._bucket(len(root_by_off), self._ROOT_BUCKET)
            if len(root_by_off) < rcap:
                pad = np.full(
                    (rcap - len(root_by_off), 8), END_TLAS, np.uint32
                ).view(np.int32)
                root_by_off = np.concatenate([root_by_off, pad])
            out = out._replace(
                wide_rows=_concat_rows_bitsafe(self._wide_static_dev, tail_rows),
                wide_root=dev(root_by_off),
                wide_root_base=self._root_base,
                tri_shade=self._tri_shade,
                hot_rows=self._hot_dev,
                hot_planes=self._hot_planes_dev,
            )
        return out
