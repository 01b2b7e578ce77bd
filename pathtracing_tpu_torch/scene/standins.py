"""Stand-in meshes for the reference's animated scene.

``load_scene`` reads the 18 meshes of ``loader.MESH_ORDER`` from
``{data_dir}/{name}.obj``; the reference's own files are not in this
repository. ``write_standins(data_dir)`` writes a stand-in for each of the
17 meshes other than the terrain (which comes from the repo's generated
substitute, ``assets/generated/terrain.obj``): the trees from
``assets.write_pine_obj``, every other mesh from ``assets.write_bunny_obj``,
all with vertex normals and slashed faces, which the native and the Python
OBJ loaders read alike. These are stand-ins with the reference's names and
roles, not its meshes: they claim none of their sizes or shapes, and frames
rendered from them cannot be validated against the reference's frames.

    from pathtracing_tpu_torch.scene.standins import write_standins
    write_standins("build/standins")
    scene = load_scene(data_dir="build/standins", config=cfg)
"""

from __future__ import annotations

import os

from pathtracing_tpu_torch.scene import assets
from pathtracing_tpu_torch.scene.loader import MESH_ORDER

TREES = ("leaf_tree", "maple_tree", "pine_tree", "tropical_tree", "willow_tree")


def write_standins(data_dir) -> dict:
    """Writes the 17 stand-in OBJ files (and their MTL files) into
    ``data_dir``; returns mesh name -> path."""
    os.makedirs(data_dir, exist_ok=True)
    out = {}
    for name in MESH_ORDER:
        if name == "terrain":
            continue
        path = os.path.join(str(data_dir), f"{name}.obj")
        writer = assets.write_pine_obj if name in TREES else assets.write_bunny_obj
        writer(path, normals=True)
        out[name] = path
    return out
