"""The plain reference's scenes, built from the benchmark's OBJ files alone.

``AnimatedScene`` is the reference renderer's animated scene (reference:
scene.cc:135-725): its 18 meshes, the terrain recoloured by height, the
seed-{1,2,3,4} placement of trees and rocks by 1,024 terrain ray casts
(here by brute force), and per frame the animation track's instances,
cameras and sunset light for each motion-blur subframe. ``cornell_box``
is the Cornell box with its emissive ceiling panel, one instance, no sun.

Both give a ``Frame``: the flat tables the integrator reads (their layout
is the renderer's: per instance the inverse transform's columns and the
rotation, per triangle its 9 vertex coordinates and vertex ids, per vertex
normal, albedo and material, per subframe camera and light rows, and the
area-light tables) and the runs of triangles the brute-force query tests.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from . import rng
from .animation import (
    CAMERA_START_ORI,
    CAMERA_START_POS,
    initial_frame_state,
    play_animation_track,
)
from .arealights import build_light_table
from .hostmath import (
    create_tangent_space_np,
    extract_m4m3,
    inverse4,
    mul_m4m4,
    rotation_euler,
    scaling,
    translation,
)
from .obj import MeshBuffers, load_mesh
from .query import build_clusters, mesh_runs, query
from .vec import Vec3

f32 = np.float32
OBJECT_COUNT = 1024  # reference: scene.cc:4

MESH_ORDER = (
    "terrain", "leaf_tree", "maple_tree", "pine_tree", "tropical_tree",
    "willow_tree", "rock0", "rock1", "rock2", "rock3", "rock4", "armadillo",
    "buddha", "bunny", "dragon", "teapot", "end", "logo",
)

ALBEDO_GRADIENT = [
    (-10, (0.25, 0.2, 0.1, 1)),
    (5, (0.2, 0.3, 0.02, 1)),
    (10, (0.2, 0.3, 0.02, 1)),
    (25, (0.3, 0.2, 0.1, 1)),
    (28, (0.95, 0.95, 0.95, 1)),
]  # reference: scene.cc:141-147
MATERIAL_GRADIENT = [
    (5, (1.0, 0, 0, 0)),
    (25, (0.5, 0, 0, 0)),
    (28, (0.2, 0, 0, 0)),
]  # reference: scene.cc:148-152


@dataclasses.dataclass
class Instance:
    mesh: Any               # obj.MeshHandle
    transform: np.ndarray   # (4, 4) f32, row-vector convention
    inv_transform: np.ndarray
    sub: int = -1           # the subframe it belongs to, -1: every subframe


def make_instance(mesh, transform, sub=-1) -> Instance:
    t = np.asarray(transform, f32)
    return Instance(mesh, t, inverse4(t), sub)


def make_transform(pos, pitch_yaw_roll=(0, 0, 0), scale=(1, 1, 1)) -> np.ndarray:
    """reference: scene.cc:62-73."""
    t = scaling(np.asarray(scale, f32))
    t = mul_m4m4(
        rotation_euler(
            (np.asarray(pitch_yaw_roll, f32) * f32(np.pi) / f32(180.0)).astype(f32)
        ),
        t,
    )
    return mul_m4m4(translation(np.asarray(pos, f32)), t)


def gradient_value(gradient, t: float) -> np.ndarray:
    """Piecewise-linear lookup via lower_bound (reference: scene.cc:12-22)."""
    t = f32(t)
    i = 0
    while i < len(gradient) and f32(gradient[i][0]) < t:
        i += 1
    if i == 0:
        return np.asarray(gradient[0][1], f32)
    if i == len(gradient):
        return np.asarray(gradient[-1][1], f32)
    t0, v0 = f32(gradient[i - 1][0]), np.asarray(gradient[i - 1][1], f32)
    t1, v1 = f32(gradient[i][0]), np.asarray(gradient[i][1], f32)
    lt = f32((t - t0) / (t1 - t0))
    return (v0 * (f32(1) - lt) + v1 * lt).astype(f32)


@dataclasses.dataclass
class Camera:
    orientation: np.ndarray
    position: np.ndarray
    aspect_ratio: float
    inv_focal_length: float
    focal_distance: float
    aperture_angle: float
    aperture_polygon: int
    aperture_radius: float


@dataclasses.dataclass
class Light:
    direction: np.ndarray
    color: np.ndarray
    cos_solid_angle: float


@dataclasses.dataclass
class Frame:
    """The tables of one frame on ``device`` (see the module's docstring)."""

    inst_f: torch.Tensor
    inst_u: torch.Tensor
    tri_pos: torch.Tensor
    tri_idx: torch.Tensor
    vattr: torch.Tensor
    sf_cam: torch.Tensor
    sf_light: torch.Tensor
    clusters: Any
    lt_tris: torch.Tensor | None = None
    lt_rows: torch.Tensor | None = None
    lt_cdf: torch.Tensor | None = None
    lt_seg: torch.Tensor | None = None
    lt_rank: torch.Tensor | None = None


def pack_frame(mesh_arrays, meshes, instances, cams, lights, runs, device,
               emissive_nee=False, lowp=None) -> Frame:
    """The tables of a frame. ``meshes``: the MeshHandles of every loaded
    mesh (each mesh's triangles keep their rows whether or not an instance
    uses it). ``lowp``: a function that rounds a float table (the
    lower-precision control), or None."""
    indices, pos, normal, albedo, material = mesh_arrays
    T = max(len(indices) // 3, 1)
    tri_pos = np.zeros((T, 12), f32)
    tri_idx = np.zeros((T, 4), np.int32)
    for m in meshes:
        if m.triangle_count == 0:
            continue
        tri = indices[m.index_offset: m.index_offset + 3 * m.triangle_count].reshape(
            -1, 3).astype(np.int64) + m.base_vertex_offset
        t0 = m.index_offset // 3
        tri_pos[t0: t0 + m.triangle_count, 0:9] = pos[tri].reshape(-1, 9)
        tri_idx[t0: t0 + m.triangle_count, 0:3] = tri
    vattr = np.zeros((max(len(normal), 1), 12), f32)
    if len(normal):
        vattr[:, 0:3] = normal
        vattr[:, 3:7] = albedo
        vattr[:, 7:11] = material
    I = max(len(instances), 1)
    inst_f = np.zeros((I, 21), f32)
    inst_u = np.zeros((I, 6), np.int32)
    for i, ins in enumerate(instances):
        inst_f[i, 0:12] = ins.inv_transform[:, 0:3].reshape(-1)
        inst_f[i, 12:21] = ins.transform[:3, :3].reshape(-1)
        inst_u[i, 4] = ins.mesh.index_offset // 3
    S = max(len(cams), 1)
    sf_cam = np.zeros((S, 18), f32)
    sf_light = np.zeros((S, 7), f32)
    for i, (c, l) in enumerate(zip(cams, lights)):
        sf_cam[i, 0:9] = np.asarray(c.orientation, f32).reshape(-1)
        sf_cam[i, 9:12] = np.asarray(c.position, f32)
        sf_cam[i, 12:18] = (c.aspect_ratio, c.inv_focal_length, c.focal_distance,
                            c.aperture_angle, float(c.aperture_polygon), c.aperture_radius)
        sf_light[i, 0:3] = np.asarray(l.direction, f32)
        sf_light[i, 3:6] = np.asarray(l.color, f32)
        sf_light[i, 6] = l.cos_solid_angle
    q = (lambda t: t) if lowp is None else lowp
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lt = {}
    if emissive_nee:
        table = build_light_table(mesh_arrays, instances)
        if table is not None:
            lt = {k: dev(v) for k, v in table.items()}
            lt["lt_tris"] = q(lt["lt_tris"])
    return Frame(
        inst_f=q(dev(inst_f)), inst_u=dev(inst_u), tri_pos=q(dev(tri_pos)),
        tri_idx=dev(tri_idx), vattr=q(dev(vattr)), sf_cam=q(dev(sf_cam)),
        sf_light=q(dev(sf_light)), clusters=build_clusters(instances, runs, device),
        **lt,
    )


class AnimatedScene:
    """The animated scene's meshes and its frame-independent instances."""

    def __init__(self, data_dir: str, device):
        self.device = torch.device(device)
        self.mb = MeshBuffers()
        self.meshes = {}
        for name in MESH_ORDER:
            self.meshes[name] = load_mesh(self.mb, os.path.join(data_dir, f"{name}.obj"))
        # terrain vertex recolour by height (reference: scene.cc:154-163)
        terrain = self.meshes["terrain"]
        albedo, material, pos = self.mb.albedo[0], self.mb.material[0], self.mb.pos[0]
        for i in range(terrain.vertex_count):
            if material[i][2] != 0:
                continue  # water stays
            albedo[i] = gradient_value(ALBEDO_GRADIENT, pos[i][1])
            material[i] = gradient_value(MATERIAL_GRADIENT, pos[i][1])
        self.arrays = self.mb.arrays()
        indices, pos_all = self.arrays[0], self.arrays[1]
        self.runs = {m.index_offset: mesh_runs(pos_all, indices, m)
                     for m in self.meshes.values() if m.triangle_count}
        self.static = [make_instance(terrain, make_transform((0, 0, 0)))]
        self._place()

    def _placement_uniforms(self) -> np.ndarray:
        """(OBJECT_COUNT, 4) f32: the seed-{1,2,3,4} stream's draws in order
        (reference: scene.cc:191-197)."""
        one = lambda v: torch.tensor([v], dtype=torch.int32)
        seed = rng.Seed(one(1), one(2), one(3), one(4))
        us = np.empty((OBJECT_COUNT, 4), f32)
        for i in range(OBJECT_COUNT):
            seed, u = rng.uniform4(seed)
            us[i] = (u.x.item(), u.y.item(), u.z.item(), u.w.item())
        return us

    def _terrain_casts(self, origins, dirs):
        """Closest hits on the terrain alone (reference: scene.cc:93-133):
        (hit, position, normal), water rejected."""
        dev = self.device
        frame = pack_frame(self.arrays, [self.meshes["terrain"]], self.static, [], [],
                           self.runs, dev)
        n = len(origins)
        col = lambda a, i: torch.from_numpy(np.ascontiguousarray(a[:, i], f32)).to(dev)
        org = Vec3(*(col(origins, i) for i in range(3)))
        d = Vec3(*(col(dirs, i) for i in range(3)))
        full = lambda v, dt: torch.full((n,), v, dtype=dt, device=dev)
        hit, _ = query(frame, frame.clusters, org, d, full(0.0, torch.float32),
                       full(1e9, torch.float32), full(True, torch.bool),
                       full(False, torch.bool), full(0, torch.int32))
        host = lambda v: v.cpu().numpy()
        thit, prim = host(hit.thit), host(hit.prim)
        bary = np.stack([host(hit.bary_u), host(hit.bary_v), host(hit.bary_w)], -1)
        indices, pos, normal, albedo, material = self.arrays
        m = self.meshes["terrain"]
        ok = thit >= 0
        hit_pos = origins + dirs * thit[:, None]
        hit_normal = np.zeros_like(hit_pos)
        for i in np.nonzero(ok)[0]:
            tri = indices[m.index_offset + prim[i] * 3: m.index_offset + prim[i] * 3 + 3]
            if material[m.base_vertex_offset + tri[0]][2] != 0:
                ok[i] = False  # water (reference: scene.cc:118-120)
                continue
            ns = normal[m.base_vertex_offset + tri]
            nsum = (ns[0] * bary[i, 0] + ns[1] * bary[i, 1] + ns[2] * bary[i, 2]).astype(f32)
            hit_normal[i] = nsum / f32(np.sqrt(np.dot(nsum, nsum)))
        return ok, hit_pos.astype(f32), hit_normal.astype(f32)

    def _place(self):
        """Deterministic placement, seed {1,2,3,4} (reference: scene.cc:191-263)."""
        us = self._placement_uniforms()
        origins = np.stack([
            us[:, 0] * f32(200.0) - f32(100.0),
            np.full(OBJECT_COUNT, 200.0, f32),
            us[:, 1] * f32(200.0) - f32(100.0),
        ], -1).astype(f32)
        dirs = np.tile(np.array([0.0, -1.0, 0.0], f32), (OBJECT_COUNT, 1))
        ok, hit_pos, hit_normal = self._terrain_casts(origins, dirs)
        add = lambda name, t: self.static.append(make_instance(self.meshes[name], t))
        tree_probability = f32(0.3)
        for i in range(OBJECT_COUNT):
            if not ok[i]:
                continue
            n_y = hit_normal[i][1]
            tree_allowed = n_y > 0.7
            rock_allowed = n_y > 0.9
            if not tree_allowed and not rock_allowed:
                continue
            u_z, u_w = us[i, 2], us[i, 3]
            if rock_allowed and not tree_allowed:
                spawn_type = 1
            elif not rock_allowed and tree_allowed:
                spawn_type = 0
            else:
                spawn_type = 0 if u_z < tree_probability else 1
            if spawn_type == 0:
                u_z = f32(u_z / tree_probability)
                transform = rotation_euler(np.array([0.0, 2.0 * np.pi * u_w, 0.0], f32))
                transform = mul_m4m4(translation(hit_pos[i]), transform)
                y = hit_pos[i][1]
                if y < 10:
                    add("tropical_tree", transform)
                elif y < 20:
                    # the second `< 0.3` makes leaf_tree unreachable
                    # (reference: scene.cc:234-239)
                    add("maple_tree" if u_z < 0.3 else "willow_tree", transform)
                else:
                    add("pine_tree", transform)
            else:
                u_z = f32((u_z - tree_probability) / (f32(1.0) - tree_probability))
                t3 = create_tangent_space_np(hit_normal[i])
                transform = np.eye(4, dtype=f32)
                transform[:3, :3] = t3
                transform[[1, 2]] = transform[[2, 1]]  # scene.cc:248-250
                transform = mul_m4m4(translation(hit_pos[i]), transform)
                if not tree_allowed:
                    add("rock3" if u_z < 0.6 else "rock4", transform)
                else:
                    # rock1 is unreachable (reference: scene.cc:259)
                    add("rock0" if u_z < 0.3 else "rock2", transform)

    def frame(self, frame_index: int, cfg, lowp=None) -> Frame:
        """The frame's tables (reference: scene.cc:271-718): the static
        instances, the frame-static logo and buddha, and per subframe the
        animated creatures, cameras and sunset light."""
        state = initial_frame_state()
        play_animation_track(state, f32(frame_index) / f32(cfg.framerate) * f32(30.0))
        instances = list(self.static)
        add = lambda name, t, sub=-1: instances.append(
            make_instance(self.meshes[name], t, sub))
        if state["logo_visible"] != 0:
            transform = rotation_euler(
                (np.asarray(CAMERA_START_ORI, f32) * f32(np.pi) / f32(180.0)).astype(f32))
            logo_pos = np.asarray(CAMERA_START_POS, f32) - np.array([-1.3, 2, -2], f32)
            add("logo", mul_m4m4(translation(logo_pos), transform))
        add("buddha", make_transform((-39.255131, 30.395447, 40.472446)))
        n_sub = cfg.subframe_count
        cams, lights = [], []
        for i in range(n_sub):
            sub_t = (f32(f32(frame_index) + f32(i) / f32(n_sub)) / f32(cfg.framerate)
                     * f32(30.0))
            play_animation_track(state, sub_t)
            add("teapot", make_transform(
                (state["teapot_pos_x"], state["teapot_pos_y"], state["teapot_pos_z"]),
                (state["teapot_ori_x"], state["teapot_ori_y"], state["teapot_ori_z"])), i)
            for name in ("armadillo", "dragon", "bunny", "end"):
                if state[f"{name}_visible"] != 0:
                    add(name, make_transform(
                        tuple(state[f"{name}_pos_{a}"] for a in "xyz"),
                        tuple(state[f"{name}_ori_{a}"] for a in "xyz")), i)
            ori = np.array([state["cam_ori_x"], state["cam_ori_y"], state["cam_ori_z"]], f32)
            cams.append(Camera(
                orientation=extract_m4m3(rotation_euler(
                    (ori * f32(np.pi) / f32(180.0)).astype(f32))),
                position=np.array([state["cam_pos_x"], state["cam_pos_y"],
                                   state["cam_pos_z"]], f32),
                aspect_ratio=cfg.image_width / float(cfg.image_height),
                inv_focal_length=float(f32(np.tan(f32(state["fov"]) * f32(np.pi) / f32(360.0)))),
                focal_distance=float(state["focal_distance"]),
                aperture_angle=float(f32(np.pi / 16.0)),
                aperture_polygon=6,
                aperture_radius=float(state["aperture_radius"]),
            ))
            # sunset curve (reference: scene.cc:691-693)
            sunset_t = f32(sub_t / f32(30.0 * 60.0) * f32(1.1) - f32(0.05))
            lights.append(Light(
                direction=np.array([0.0, np.sin(sunset_t * f32(np.pi)),
                                    np.cos(sunset_t * f32(np.pi))], f32),
                color=np.array([4, 4, 4], f32),
                cos_solid_angle=float(f32(np.cos(f32(4.0 * np.pi / 180.0)))),
            ))
        return pack_frame(self.arrays, list(self.meshes.values()), instances, cams, lights,
                          self.runs, self.device, lowp=lowp)


def cornell_box(obj_path: str, cfg, device, lowp=None) -> Frame:
    """The Cornell box: its mesh as one instance, the camera at (0, 1, 3.6)
    looking down -z with a 40 degree field of view, a black sun, and the
    emissive panel's area-light tables."""
    mb = MeshBuffers()
    mesh = load_mesh(mb, obj_path)
    arrays = mb.arrays()
    runs = {mesh.index_offset: mesh_runs(arrays[1], arrays[0], mesh)}
    instances = [make_instance(mesh, make_transform((0, 0, 0)))]
    cam = Camera(
        orientation=extract_m4m3(rotation_euler(np.zeros(3, f32))),
        position=np.asarray((0, 1.0, 3.6), f32),
        aspect_ratio=cfg.image_width / float(cfg.image_height),
        inv_focal_length=float(f32(np.tan(f32(40 * math.pi / 360.0)))),
        focal_distance=2.0,
        aperture_angle=float(np.pi / 16),
        aperture_polygon=6,
        aperture_radius=0.0,
    )
    d = np.asarray((0, 1, 0), f32)
    light = Light(direction=(d / f32(np.sqrt(np.dot(d, d)))).astype(f32),
                  color=np.zeros(3, f32),
                  cos_solid_angle=float(f32(np.cos(f32(4.0 * np.pi / 180.0)))))
    n_sub = cfg.subframe_count
    return pack_frame(arrays, [mesh], instances, [cam] * n_sub, [light] * n_sub, runs,
                      torch.device(device), emissive_nee=True, lowp=lowp)
