"""Scene assembly: the reference's full animated scene
(reference: scene.cc:135-725); the JAX package's ``scene/loader.py``.

load_scene(): loads the 18 meshes (terrain/bunny/pine replaced by
procedural substitutes when the originals are absent), recolors terrain by
height gradients, and performs the deterministic seed-{1,2,3,4} object
placement with 1024 terrain ray casts — batched through the renderer's own
``ray_query`` on the scene's device (the ``ray_query`` kernel on a CUDA
device, its plain version on the CPU).

setup_animation_frame(): evaluates the animation track, rebuilds the
per-subframe TLASes (threaded native SAH builds — the C++ builder releases
the GIL, mirroring the reference's OpenMP loop at scene.cc:698-710) and
appends them to the shared buffers with offset fix-ups.

The reference's meshes are read from ``data_dir`` (``{data_dir}/{name}.obj``);
a folder of stand-ins for all of them is written by
``scene/standins.write_standins``.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.accel.builder_py import build_blas, build_tlas
from pathtracing_tpu_torch.accel.types import BvhBuffers, BvhHandle
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.io.obj import load_mesh
from pathtracing_tpu_torch.ops import rng
from pathtracing_tpu_torch.scene.animation import (
    CAMERA_START_ORI,
    CAMERA_START_POS,
    initial_frame_state,
    play_animation_track,
)
from pathtracing_tpu_torch.scene.types import (
    Camera,
    DirectionalLight,
    Scene,
    Subframe,
    TlasInstance,
)
from pathtracing_tpu_torch.utils.hostmath import (
    create_tangent_space_np,
    extract_m4m3,
    mul_m4m4,
    rotation_euler,
    scaling,
    translation,
)
from pathtracing_tpu_torch.utils.vec import Vec3

f32 = np.float32
OBJECT_COUNT = 1024  # reference: scene.cc:4

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

MESH_ORDER = [
    # (name, file stem); terrain loads first (reference: scene.cc:139-182)
    "terrain",
    "leaf_tree",
    "maple_tree",
    "pine_tree",
    "tropical_tree",
    "willow_tree",
    "rock0",
    "rock1",
    "rock2",
    "rock3",
    "rock4",
    "armadillo",
    "buddha",
    "bunny",
    "dragon",
    "teapot",
    "end",
    "logo",
]


def data_dir_or_env(data_dir: str | None) -> str:
    """``data_dir``, else ``$PT_DATA_DIR``; raises when neither names a
    folder (the reference's ``data/`` or one of stand-ins)."""
    data_dir = data_dir or os.environ.get("PT_DATA_DIR")
    if not data_dir:
        raise ValueError(
            "no mesh folder: pass data_dir= (or set PT_DATA_DIR) to the "
            "reference's data/ folder or to stand-ins written by "
            "scene.standins.write_standins"
        )
    return data_dir


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


def add_instance(s: Scene, name: str, transform: np.ndarray) -> None:
    """reference: scene.cc:51-60."""
    m, blas = s.meshes[name]
    s.instances.append(TlasInstance.create(blas, m, transform))


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


def _terrain_trace_batch(s: Scene, terrain_tlas: BvhHandle, origins, dirs, device):
    """Batch of closest-hit terrain queries (reference: scene.cc:93-133),
    traced on ``device``.

    Returns (hit bool, hit_pos (N,3), hit_normal (N,3)) — water rejected.
    """
    from pathtracing_tpu_torch.ops.traversal import ray_query
    from pathtracing_tpu_torch.scene.device import pack_scene

    sub = Subframe(
        terrain_tlas,
        Camera(np.eye(3, dtype=f32), np.zeros(3, f32), 1.0, 1.0, 1.0, 0.0, 0, 0.0),
        DirectionalLight(np.array([0, 1, 0], f32), np.ones(3, f32), 0.5),
    )
    dev = pack_scene(
        s.mesh_buf.arrays(), s.bvh_buf.nodes, s.bvh_buf.links, s.instances, [sub],
        device=device,
    )
    n = len(origins)
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)
    col = lambda a, i: torch.from_numpy(np.ascontiguousarray(a[:, i], f32)).to(device)
    hit, _ = ray_query(
        dev, full(terrain_tlas.node_count), full(terrain_tlas.node_offset),
        Vec3(*(col(origins, i) for i in range(3))),
        Vec3(*(col(dirs, i) for i in range(3))),
        0.0, 1e9, torch.ones(n, dtype=torch.bool, device=device),
    )

    host = lambda v: v.cpu().numpy()
    thit = host(hit.thit)
    inst = host(hit.inst)
    prim = host(hit.prim)
    bary = np.stack([host(hit.bary_u), host(hit.bary_v), host(hit.bary_w)], -1)

    indices, pos, normal, albedo, material = s.mesh_buf.arrays()
    ok = thit >= 0
    hit_pos = origins + dirs * thit[:, None]
    hit_normal = np.zeros_like(hit_pos)
    for i in np.nonzero(ok)[0]:
        m = s.instances[inst[i]].mesh
        tri = indices[m.index_offset + prim[i] * 3 : m.index_offset + prim[i] * 3 + 3]
        # water triangles don't count (reference: scene.cc:118-120)
        if material[m.base_vertex_offset + tri[0]][2] != 0:
            ok[i] = False
            continue
        ns = normal[m.base_vertex_offset + tri]
        nsum = (
            ns[0] * bary[i, 0] + ns[1] * bary[i, 1] + ns[2] * bary[i, 2]
        ).astype(f32)
        hit_normal[i] = nsum / f32(np.sqrt(np.dot(nsum, nsum)))
    return ok, hit_pos.astype(f32), hit_normal.astype(f32)


def _placement_uniforms() -> np.ndarray:
    """(OBJECT_COUNT, 4) f32: the seed-{1,2,3,4} stream's draws in order
    (reference: scene.cc:191-197), on the CPU."""
    one = lambda v: torch.tensor([v], dtype=torch.int32)
    seed = rng.Seed(one(1), one(2), one(3), one(4))
    us = np.empty((OBJECT_COUNT, 4), f32)
    for i in range(OBJECT_COUNT):
        seed, u = rng.uniform4(seed)
        us[i] = (u.x.item(), u.y.item(), u.z.item(), u.w.item())
    return us


def load_scene(
    data_dir: str | None = None,
    generated_dir: str | None = None,
    config: RenderConfig | None = None,
    device=None,
) -> Scene:
    """reference: scene.cc:135-269. Meshes are read from ``data_dir`` (or
    ``$PT_DATA_DIR``); a missing terrain, bunny or pine comes from the
    procedural substitutes in ``generated_dir`` (the repo's
    ``assets/generated``). The placement rays are traced on ``device``
    (None: CUDA, raising when there is none)."""
    from pathtracing_tpu_torch.scene.assets import ensure_substitutes

    device = resolve_device(device)
    data_dir = data_dir_or_env(data_dir)
    generated_dir = generated_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets",
        "generated",
    )
    substitutes = ensure_substitutes(generated_dir)

    s = Scene()
    for name in MESH_ORDER:
        path = os.path.join(data_dir, f"{name}.obj")
        if not os.path.exists(path) and name in substitutes:
            path = substitutes[name]
        m = load_mesh(s.mesh_buf, path)
        blas = build_blas(m, s.mesh_buf.arrays(), s.bvh_buf)
        s.meshes[name] = (m, blas)

    # Terrain vertex recolor by height (reference: scene.cc:154-163).
    terrain_mesh, _ = s.meshes["terrain"]
    albedo_chunk = s.mesh_buf.albedo[0]
    material_chunk = s.mesh_buf.material[0]
    pos_chunk = s.mesh_buf.pos[0]
    for i in range(terrain_mesh.vertex_count):
        if material_chunk[i][2] != 0:
            continue  # water stays
        height = pos_chunk[i][1]
        albedo_chunk[i] = gradient_value(ALBEDO_GRADIENT, height)
        material_chunk[i] = gradient_value(MATERIAL_GRADIENT, height)

    add_instance(s, "terrain", make_transform((0, 0, 0)))

    # Throwaway terrain TLAS for placement ray casts
    # (reference: scene.cc:186-189).
    terrain_tlas = build_tlas(
        s.instances[:1], [0], s.bvh_buf.nodes, s.bvh_buf
    )

    # Deterministic placement, seed {1,2,3,4} (reference: scene.cc:191-263).
    us = _placement_uniforms()

    origins = np.stack(
        [
            us[:, 0] * f32(200.0) - f32(100.0),
            np.full(OBJECT_COUNT, 200.0, f32),
            us[:, 1] * f32(200.0) - f32(100.0),
        ],
        -1,
    ).astype(f32)
    dirs = np.tile(np.array([0.0, -1.0, 0.0], f32), (OBJECT_COUNT, 1))
    ok, hit_pos, hit_normal = _terrain_trace_batch(
        s, terrain_tlas, origins, dirs, device
    )

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
            transform = rotation_euler(
                np.array([0.0, 2.0 * np.pi * u_w, 0.0], f32)
            )
            transform = mul_m4m4(translation(hit_pos[i]), transform)
            y = hit_pos[i][1]
            if y < 10:
                add_instance(s, "tropical_tree", transform)
            elif y < 20:
                # dead branch kept verbatim: the second `< 0.3` makes
                # leaf_tree unreachable (reference: scene.cc:234-239)
                if u_z < 0.3:
                    add_instance(s, "maple_tree", transform)
                elif u_z < 0.3:
                    add_instance(s, "leaf_tree", transform)
                else:
                    add_instance(s, "willow_tree", transform)
            else:
                add_instance(s, "pine_tree", transform)
        else:
            u_z = f32((u_z - tree_probability) / (f32(1.0) - tree_probability))
            t3 = create_tangent_space_np(hit_normal[i])
            transform = np.eye(4, dtype=f32)
            transform[:3, :3] = t3
            # std::swap(r[2], r[1]) (reference: scene.cc:248-250)
            transform[[1, 2]] = transform[[2, 1]]
            transform = mul_m4m4(translation(hit_pos[i]), transform)
            if not tree_allowed:
                if u_z < 0.6:
                    add_instance(s, "rock3", transform)
                else:
                    add_instance(s, "rock4", transform)
            else:
                if u_z < 0.3:
                    add_instance(s, "rock0", transform)
                elif u_z < 0.3:  # dead branch kept verbatim (scene.cc:259)
                    add_instance(s, "rock1", transform)
                else:
                    add_instance(s, "rock2", transform)

    s.bvh_buf.pop(terrain_tlas)
    s.static_instance_count = len(s.instances)
    return s


def get_animation_frame_count(config: RenderConfig) -> int:
    """reference: scene.cc:720-724."""
    return 60 * config.framerate


def setup_animation_frame(
    s: Scene, frame_index: int, config: RenderConfig,
    build_tlas_trees: bool = True,
) -> None:
    """reference: scene.cc:271-718.

    build_tlas_trees=False skips the per-subframe binary TLAS builds
    (reference: scene.cc:698-710) and appends zero-count placeholder
    handles with distinct node_offsets instead. Valid ONLY for the chunked
    wide tables: their packer (accel/chunks.build_frame_tail_chunked)
    builds its own per-subframe dynamic trees from the instance list and
    uses sf.tlas.node_offset only as a row key, so the binary trees are
    dead weight there. The binary walks (the scan, P1, K5 on binary
    tables) need the real trees."""
    if s.subframes:
        s.bvh_buf.pop(s.subframes[0].tlas)
    del s.instances[s.static_instance_count :]
    s.subframes = []

    state = initial_frame_state()
    anim_t = f32(frame_index) / f32(config.framerate) * f32(30.0)
    play_animation_track(state, anim_t)

    static_begin = 0

    # Frame-static instances (reference: scene.cc:634-645).
    if state["logo_visible"] != 0:
        transform = rotation_euler(
            (np.asarray(CAMERA_START_ORI, f32) * f32(np.pi) / f32(180.0)).astype(f32)
        )
        logo_pos = np.asarray(CAMERA_START_POS, f32) - np.array(
            [-1.3, 2, -2], f32
        )
        transform = mul_m4m4(translation(logo_pos), transform)
        add_instance(s, "logo", transform)

    add_instance(
        s, "buddha", make_transform((-39.255131, 30.395447, 40.472446))
    )
    static_end = len(s.instances)

    subframe_count = config.subframe_count
    entries = []
    cams = []
    lights = []
    for i in range(subframe_count):
        sub_t = (
            f32(f32(frame_index) + f32(i) / f32(subframe_count))
            / f32(config.framerate)
            * f32(30.0)
        )
        play_animation_track(state, sub_t)

        dynamic_begin = len(s.instances)
        add_instance(
            s,
            "teapot",
            make_transform(
                (state["teapot_pos_x"], state["teapot_pos_y"], state["teapot_pos_z"]),
                (state["teapot_ori_x"], state["teapot_ori_y"], state["teapot_ori_z"]),
            ),
        )
        for name, vis in [
            ("armadillo", "armadillo_visible"),
            ("dragon", "dragon_visible"),
            ("bunny", "bunny_visible"),
            ("end", "end_visible"),
        ]:
            if state[vis] != 0:
                add_instance(
                    s,
                    name,
                    make_transform(
                        (
                            state[f"{name}_pos_x"],
                            state[f"{name}_pos_y"],
                            state[f"{name}_pos_z"],
                        ),
                        (
                            state[f"{name}_ori_x"],
                            state[f"{name}_ori_y"],
                            state[f"{name}_ori_z"],
                        ),
                    ),
                )
        dynamic_end = len(s.instances)
        entries.append((dynamic_begin, dynamic_end))

        cam = Camera(
            orientation=extract_m4m3(
                rotation_euler(
                    (
                        np.array(
                            [
                                state["cam_ori_x"],
                                state["cam_ori_y"],
                                state["cam_ori_z"],
                            ],
                            f32,
                        )
                        * f32(np.pi)
                        / f32(180.0)
                    ).astype(f32)
                )
            ),
            position=np.array(
                [state["cam_pos_x"], state["cam_pos_y"], state["cam_pos_z"]], f32
            ),
            aspect_ratio=config.image_width / float(config.image_height),
            inv_focal_length=float(
                f32(np.tan(f32(state["fov"]) * f32(np.pi) / f32(360.0)))
            ),
            focal_distance=float(state["focal_distance"]),
            aperture_angle=float(f32(np.pi / 16.0)),
            aperture_polygon=6,
            aperture_radius=float(state["aperture_radius"]),
        )
        cams.append(cam)

        # Sunset curve (reference: scene.cc:691-693).
        sunset_t = f32(sub_t / f32(30.0 * 60.0) * f32(1.1) - f32(0.05))
        direction = np.array(
            [
                0.0,
                np.sin(sunset_t * f32(np.pi)),
                np.cos(sunset_t * f32(np.pi)),
            ],
            f32,
        )
        lights.append(
            DirectionalLight(
                direction=direction,
                color=np.array([4, 4, 4], f32),
                cos_solid_angle=float(f32(np.cos(f32(4.0 * np.pi / 180.0)))),
            )
        )

    if not build_tlas_trees:
        base = len(s.bvh_buf.nodes)
        for i in range(subframe_count):
            s.subframes.append(
                Subframe(
                    BvhHandle(node_count=0, node_offset=base + i),
                    cams[i], lights[i],
                )
            )
        s.subframe_entries = entries
        s.frame_static_end = static_end
        return

    # Parallel TLAS builds into local buffers (reference: scene.cc:698-710);
    # the native builder releases the GIL during the C++ call.
    def build_one(i):
        local = BvhBuffers()
        instances = list(range(static_begin, static_end)) + list(
            range(entries[i][0], entries[i][1])
        )
        handle = build_tlas(
            [s.instances[j] for j in instances],
            instances,
            s.bvh_buf.nodes,
            local,
        )
        return handle, local

    with concurrent.futures.ThreadPoolExecutor(
        max_workers=min(subframe_count, os.cpu_count() or 4)
    ) as pool:
        results = list(pool.map(build_one, range(subframe_count)))

    for i, (handle, local) in enumerate(results):
        handle.node_offset = len(s.bvh_buf.nodes)
        s.bvh_buf.nodes = np.concatenate([s.bvh_buf.nodes, local.nodes])
        s.bvh_buf.links = np.concatenate([s.bvh_buf.links, local.links])
        s.subframes.append(Subframe(handle, cams[i], lights[i]))

    s.subframe_entries = entries
    s.frame_static_end = static_end
