"""Geometry-sharded rendering (the JAX package's ``parallel/geomshard.py``,
same names): the answer to a scene larger than one device's memory.

Each shard of a ``geom`` mesh axis owns a disjoint subset of the TLAS
instances and its tables hold only the meshes and BLASes those instances
reference. Every shard traces the same rays against its own geometry, and
the global closest hit is rebuilt on the rays' device:

  * per-lane winner: the least shard-local ``thit`` (a miss counts +inf),
    ties to the lowest shard index (JAX's ``pmin`` twice);
  * shading runs on every shard's own tables, and the shaded ``HitInfo``
    masked to the winner's lane are added in shard order (JAX's ``psum``;
    the losers add zeros, so no stray inf/NaN of a dead lane leaks); a lane
    that misses on every shard takes shard 0's (scene-independent) miss
    shading;
  * any-hit occlusion is an OR over the shards.

After the combine every lane carries one hit state, so the bounce loop
(RNG, BSDF, NEE, atmosphere) runs once, on the rays' device: only the
two-level BVH traversal and the shading fetch are distributed. Under the
single controller (``parallel/__init__.py``) a shard's query and shading
are issued on its device first for every shard, and the results copied to
the rays' device after, so the copies of one shard do not wait for the
walks of the next.

Instances are assigned to shards by greedy bin packing on BLAS node counts
(each BLAS counted once per shard); each shard's tables are compacted to
what its instances reference, with remapped handles and shard-local
instance ids (``HitInfo`` carries no ids, only shaded floats). The
numpy parts (``tlas_leaf_ids``, ``assign_instances``, ``_compact_shard``)
compute the JAX package's arrays byte for byte. Forward rendering only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.accel.builder_py import build_tlas
from pathtracing_tpu_torch.accel.types import BvhBuffers, BvhHandle
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops.integrator import path_trace_samples, shade_hit
from pathtracing_tpu_torch.ops.traversal import ray_query
from pathtracing_tpu_torch.ops.wavefront import _coords
from pathtracing_tpu_torch.parallel.sharding import Mesh, _split, scene_on
from pathtracing_tpu_torch.scene.device import pack_scene
from pathtracing_tpu_torch.scene.types import Subframe

__all__ = [
    "assign_instances",
    "build_shard_scenes",
    "make_geom_query_shade",
    "make_geom_sharded_render",
]


def tlas_leaf_ids(links: np.ndarray, handle) -> np.ndarray:
    """Instance ids referenced by a TLAS: leaf-encoded accept links carry
    the user index under the 0x80000000 tag (reference: bvh.cc:176-177)."""
    block = np.asarray(
        links[8 * handle.node_offset : 8 * (handle.node_offset + handle.node_count)],
        np.uint32,
    )
    acc = block[:, 0]
    return np.unique(acc[(acc & 0x80000000) != 0] & 0x7FFFFFFF)


def assign_instances(scene, n_shards: int) -> np.ndarray:
    """Greedy balance of instances over shards by BLAS node count (unique
    BLASes counted once per shard). Returns (I,) shard index per instance."""
    insts = scene.instances
    order = sorted(
        range(len(insts)), key=lambda i: -insts[i].blas.node_count
    )
    load = np.zeros(n_shards, np.int64)
    # BLASes already resident on a shard are free for further instances
    resident = [set() for _ in range(n_shards)]
    assign = np.zeros(len(insts), np.int32)
    for i in order:
        blas_key = insts[i].blas.node_offset
        costs = [
            load[s] + (0 if blas_key in resident[s] else insts[i].blas.node_count)
            for s in range(n_shards)
        ]
        s = int(np.argmin(costs))
        assign[i] = s
        load[s] = costs[s]
        resident[s].add(blas_key)
    return assign


def _compact_shard(scene, mine: list[int]):
    """Slice the global buffers down to one shard's instances.

    Returns (mesh_arrays, bvh_nodes, bvh_links, instances) where instances
    carry REMAPPED mesh/BLAS handles into the compacted buffers (transforms,
    inv_transform included, are shared, not recomputed, so traversal math
    is bit-identical to the single-device scene).
    """
    indices, pos, normal, albedo, material = scene.mesh_buf.arrays()

    mesh_map = {}   # (index_offset, base_vertex_offset) -> local MeshHandle
    idx_parts, v_slices = [], []
    cur_idx = cur_v = 0
    blas_map = {}   # global node_offset -> local BvhHandle
    node_parts, link_parts = [], []
    cur_n = 0
    locals_ = []
    for i in mine:
        inst = scene.instances[i]
        mkey = (inst.mesh.index_offset, inst.mesh.base_vertex_offset)
        if mkey not in mesh_map:
            m = inst.mesh
            # per-mesh index values are relative to base_vertex_offset
            # (scene/device.pack_tri_tables adds it back), so the slice
            # copies unchanged
            idx_parts.append(
                indices[m.index_offset : m.index_offset + 3 * m.triangle_count]
            )
            v_slices.append(
                slice(m.base_vertex_offset, m.base_vertex_offset + m.vertex_count)
            )
            mesh_map[mkey] = dataclasses.replace(
                m, index_offset=cur_idx, base_vertex_offset=cur_v
            )
            cur_idx += 3 * m.triangle_count
            cur_v += m.vertex_count
        bkey = inst.blas.node_offset
        if bkey not in blas_map:
            b = inst.blas
            # link node indices are BVH-local (accel/types.py layout
            # contract), so node/link blocks relocate without rewriting
            node_parts.append(scene.bvh_buf.nodes[b.node_offset : b.node_offset + b.node_count])
            link_parts.append(
                scene.bvh_buf.links[8 * b.node_offset : 8 * (b.node_offset + b.node_count)]
            )
            blas_map[bkey] = BvhHandle(node_count=b.node_count, node_offset=cur_n)
            cur_n += b.node_count
        locals_.append(
            dataclasses.replace(inst, blas=blas_map[bkey], mesh=mesh_map[mkey])
        )

    mesh_arrays = (
        np.concatenate(idx_parts).astype(np.uint32) if idx_parts
        else np.zeros((0,), np.uint32),
        *(
            np.concatenate([a[sl] for sl in v_slices]).astype(np.float32)
            if v_slices else np.zeros((0, a.shape[1]), np.float32)
            for a in (pos, normal, albedo, material)
        ),
    )
    nodes = (
        np.concatenate(node_parts).astype(np.float32)
        if node_parts else np.zeros((0, 6), np.float32)
    )
    links = (
        np.concatenate(link_parts).astype(np.uint32)
        if link_parts else np.zeros((0, 2), np.uint32)
    )
    return mesh_arrays, nodes, links, locals_


def build_shard_scenes(
    scene, config: RenderConfig, n_shards: int, assign: np.ndarray | None = None,
    device=None,
):
    """One compacted SceneDevice per shard: each shard's tables hold only
    the meshes/BLASes its instances reference (shard-local instance ids;
    per-shard subframe TLASes over the shard's instance subset), so device
    memory per shard shrinks with the assignment.

    ``device``: one device for every shard or a sequence of one per shard
    (None: CUDA, raising when there is none). Returns (list of SceneDevice,
    shard s on its device, assign). The JAX function stacks the shards
    into one (D, ...) array per field, zero-padded to the largest shard;
    here each shard keeps its own row counts. A shard with no instance in
    a subframe gets a 0-node TLAS there: every ray exhausts at once."""
    if device is None or isinstance(device, (str, torch.device)):
        devices = [resolve_device(device)] * n_shards
    else:
        devices = [resolve_device(d) for d in device]
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    if assign is None:
        assign = assign_instances(scene, n_shards)
    assign = np.asarray(assign, np.int32)

    shards = []
    for s in range(n_shards):
        mine = np.nonzero(assign == s)[0].tolist()
        local_of = {int(g): l for l, g in enumerate(mine)}
        mesh_arrays, blas_nodes, blas_links, locals_ = _compact_shard(scene, mine)
        bc = BvhBuffers()
        bc.nodes, bc.links = blas_nodes, blas_links
        subframes = []
        for sf in scene.subframes:
            active = tlas_leaf_ids(scene.bvh_buf.links, sf.tlas)
            ids = [local_of[int(i)] for i in active if int(i) in local_of]
            if ids:
                handle = build_tlas([locals_[i] for i in ids], ids, bc.nodes, bc)
            else:
                handle = BvhHandle(node_offset=len(bc.nodes), node_count=0)
            subframes.append(Subframe(handle, sf.cam, sf.light))
        shards.append(pack_scene(mesh_arrays, bc.nodes, bc.links, locals_, subframes,
                                 device=devices[s]))
    return shards, assign


def _tree(fn, *trees):
    """fn over the tensors of nested NamedTuples (HitInfo, Vec3, ...), the
    trees' structure kept."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def make_geom_query_shade(shard_scenes):
    """The ``query_shade`` hook (ops/integrator.path_trace_samples) that
    traces each shard's geometry on its device and combines the hits on the
    rays' device.

    shard_scenes: one scene per shard (``build_shard_scenes``), each on
    the device its shard runs on. Each lane's TLAS handles are read from
    each shard's own subframe table by the lane's subframe index (the
    JAX hook reads them from the scene of the device it runs on)."""
    shards = list(shard_scenes)

    def query_shade(scene, light, subframe, org, d, tmin, tmax, active, anyhit,
                    n_shade):
        home = org.x.device
        n = org.x.shape[0]
        n_occ = n - n_shade
        tail = lambda a: a[n_occ:]
        # every shard's walk and shading first, on its device; the copies
        # to the rays' device after
        per = []
        for sc in shards:
            dev = sc.nl8.device
            to = lambda x: x.to(dev, non_blocking=True) if isinstance(x, torch.Tensor) else x
            row = to(subframe).clamp(0, sc.sf_tlas_count.shape[0] - 1)
            o, dd = _tree(to, org), _tree(to, d)
            hit, occ = ray_query(sc, sc.sf_tlas_count[row], sc.sf_tlas_offset[row], o, dd,
                                 to(tmin), to(tmax), to(active), anyhit=to(anyhit))
            hit_t = _tree(tail, hit)
            info = shade_hit(sc, _tree(to, light), hit_t, _tree(tail, o), _tree(tail, dd))
            key = torch.where(hit_t.thit >= 0, hit_t.thit, math.inf)
            per.append((occ[:n_occ], key, info))

        occluded = per[0][0].to(home)
        for occ, _, _ in per[1:]:
            occluded = occluded | occ.to(home)
        keys = torch.stack([key.to(home) for _, key, _ in per])
        gmin = keys.amin(0)
        found = torch.isfinite(gmin)
        cand = (keys == gmin) & found
        idx = torch.arange(len(per), dtype=torch.int32, device=home)[:, None]
        win = torch.where(cand, idx, torch.iinfo(torch.int32).max).amin(0)
        combined = None
        for s, (_, _, info) in enumerate(per):
            mask = cand[s] & (win == s)
            if s == 0:
                mask = mask | ~found
            kept = _tree(lambda x: torch.where(mask, x.to(home), 0.0), info)
            combined = kept if combined is None else _tree(torch.add, combined, kept)
        return occluded, combined

    return query_shade


def _geom_grid(mesh: Mesh, axis_name: str, tile_axis: str | None) -> np.ndarray:
    """The mesh's devices as a (geom, tiles) grid (one tile column without
    a tile axis); the mesh has exactly these axes."""
    names = [axis_name] + ([tile_axis] if tile_axis else [])
    if sorted(mesh.axis_names) != sorted(names):
        raise ValueError(f"mesh {mesh.shape} for axes {names}")
    devs = np.transpose(mesh.devices, [mesh.axis_names.index(a) for a in names])
    return devs.reshape(mesh.shape[axis_name], -1)


def make_geom_sharded_render(
    config: RenderConfig,
    mesh: Mesh,
    spp: int,
    axis_name: str = "geom",
    tile_axis: str | None = None,
):
    """fn(shard_scenes, xs, ys) -> (r, g, b) radiance SUMS over samples
    [0, spp), on the mesh's first device, by the scan (P1 per shard on a
    card).

    shard_scenes: from ``build_shard_scenes``, one per device of the
    ``axis_name`` axis (copied to a shard's device when they lie elsewhere);
    xs / ys are flat pixel lists. tile_axis: optional second mesh axis over
    which the pixel list is split, composing geometry sharding with pixel
    parallelism in one mesh. Area-light scenes are refused here, at the API
    boundary: shard scenes carry no light tables."""
    grid = _geom_grid(mesh, axis_name, tile_axis)
    n_geom, n_tiles = grid.shape

    def fn(shard_scenes, xs, ys):
        if len(shard_scenes) != n_geom:
            raise ValueError(f"{len(shard_scenes)} shard scenes for {n_geom} geometry shards")
        if any(sc.lt_tris is not None for sc in shard_scenes):
            raise NotImplementedError(
                "geometry sharding does not support area-light NEE scenes "
                "(pack the scene without emissive_nee, or render on the "
                "replicated-geometry path)"
            )
        m = _split(len(xs), n_tiles, "pixel list of")
        out = grid[0, 0]
        tiles = []
        for t in range(n_tiles):
            scenes = [scene_on(sc, grid[g, t]) for g, sc in enumerate(shard_scenes)]
            hook = make_geom_query_shade(scenes)
            home = grid[0, t]
            txs = _coords(xs[t * m:(t + 1) * m], home)
            tys = _coords(ys[t * m:(t + 1) * m], home)
            zero = lambda: torch.zeros(txs.shape, dtype=torch.float32, device=home)
            r, g, b = zero(), zero(), zero()
            for s in range(spp):
                si = torch.full(txs.shape, s, dtype=torch.int32, device=home)
                c = path_trace_samples(config, scenes[0], txs, tys, si, query_shade=hook)
                r += c.x
                g += c.y
                b += c.z
            tiles.append((r, g, b))
        return tuple(torch.cat([tile[k].to(out) for tile in tiles]) for k in range(3))

    return fn
