"""Scene-preset zoo ("model families") for the framework.

The reference ships exactly one hard-coded scene (scene.cc:135-269 plus the
animation table); a framework needs named, parameterized presets. Every
model exposes

    build(config=TESTING, **kwargs) -> (Scene, SceneDevice)

where ``Scene`` is the host-side handle (instances, shared buffers — edit
and re-pack with scene.builder.rebuild_static_tlas) and ``SceneDevice`` is
the packed device table set that render.render_pixels consumes. Keyword
arguments go to the preset, ``device=`` among them (None: CUDA).

    from pathtracing_tpu_torch import models
    scene, dev = models.build("sphere_ground")                  # on the card
    scene, dev = models.build("sphere_ground", device="cpu")    # on the CPU

Presets (the JAX package's registry, same names):
  full_animation  the reference's animated scene at a given frame
                  (terrain placement, animation table, sunset — the
                  flagship; needs the reference's meshes or stand-ins,
                  scene/standins.py)
  teapot_rocks    teapot + five rocks on a ground slab (the golden-test
                  family; the same meshes)
  cornell_box     procedural Cornell box with an emissive ceiling panel —
                  exercises the emission path with no sun/sky light; its
                  default emissive_nee=True samples the panel (area-light
                  NEE), emissive_nee=False is the BSDF-only estimator
  sphere_ground   dense smooth sphere over a ground plane — the
                  inverse-pose optimization scene (procedural)
"""

from __future__ import annotations

from pathtracing_tpu_torch.config import TESTING, RenderConfig

_BUILDERS = {}


def _register(name):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn

    return deco


def names() -> list[str]:
    _load()
    return sorted(_BUILDERS)


def build(name: str, config: RenderConfig = TESTING, **kwargs):
    """Build a named scene preset -> (Scene, SceneDevice)."""
    _load()
    try:
        fn = _BUILDERS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {names()}")
    return fn(config, **kwargs)


_loaded = False


def _load():
    global _loaded
    if _loaded:
        return
    _loaded = True
    from pathtracing_tpu_torch.models import (  # noqa: F401
        cornell_box,
        full_animation,
        sphere_ground,
        teapot_rocks,
    )


def __getattr__(name):
    _load()
    if name in _BUILDERS:
        return _BUILDERS[name]
    raise AttributeError(name)
