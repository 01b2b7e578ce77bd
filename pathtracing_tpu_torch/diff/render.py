"""Differentiable (inverse) rendering: gradients of a loss of the rendered
radiance with respect to the scene's tables.

Counterpart of the JAX package's ``diff/render.py``, with the same names,
argument order and defaults. The integrator is plain tensor code, so
PyTorch's autograd runs through it end to end with one carve-out: BVH
traversal is discrete and stays outside the graph (``ray_query`` runs under
``torch.no_grad``, as JAX's runs under ``stop_gradient``); the hit's (u, v,
t) are re-derived differentiably from the hit ids (``ops/integrator.
shade_hit``). These are fixed-topology gradients: with respect to materials,
lights, vertices, poses and camera at fixed visibility. Silhouette
(visibility) gradients are out of scope.

Differentiable tables of ``SceneDevice`` (``DIFFERENTIABLE_FIELDS``):
  vattr   per-vertex normals, albedo, materials
  tri_pos triangle vertex positions (shading and the hit re-derivation)
  inst_f  instance transforms
          (the transposes of these three tables' gathers: K7b)
  sf_cam / sf_light  per-subframe camera and sun rows (their transpose: K7a)

Each entry point returns ``(loss, grads)``: the loss as a 0-d tensor and a
dict of field -> gradient tensor of the field's shape (zeros where the loss
does not depend on it). The caller's scene is not changed: the fields are
cloned into leaf tensors. Everything stays on the scene's device. There is
no ``jit``: the ``make_*`` functions return plain callables.

The fast gradients (``make_fast_grad_fn``, ``make_fast_grad_frame_fn``) run
two passes: a record pass without autograd that traces and keeps each
bounce's hit topology (the scan's ``path_trace_samples(record=True)``, or
the megakernel's record build K6 for a frame), then autograd through a
replay of the same radiance computation in which every ray query is a
record lookup. The replay and its backward are eager tensor code, as they
are XLA autodiff of plain ``jnp`` code in JAX; the gathers of the
differentiable tables run their backward kernels (K7a, K7b) on the card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.wavefront import _wrap_int32
from pathtracing_tpu_torch.utils.vec import Vec3

DIFFERENTIABLE_FIELDS = ("vattr", "tri_pos", "inst_f", "sf_cam", "sf_light")

# Lanes of one chunk of the frame replay (make_fast_grad_frame_fn). An eager
# autograd replay keeps about one saved lane-wide tensor per elementwise op:
# each atmosphere march is 8 x (4 + 1) steps of a few dozen ops, and a path
# of 5 bounces runs six of them besides its shading, so a lane holds some
# 20 KB until the backward. 2**19 lanes keep one chunk near 10 GB, well
# inside one 80 GB card beside the backward's own temporaries; a 1080p frame
# at 1 spp (2,073,600 items) replays in 4 chunks. Chunking does not change
# the function: the loss is taken once over every item, and each chunk's
# backward carries its share of that loss's cotangent.
REPLAY_CHUNK = 1 << 19


def mean_luminance(c: Vec3) -> torch.Tensor:
    """The default loss: the mean luminance of the per-lane radiance."""
    return torch.mean(0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z)


def _detached(scene):
    """The scene with every table detached: the record pass's input."""
    return type(scene)(*(None if t is None else t.detach() for t in scene))


def _leaves(scene, fields: Sequence[str]) -> dict:
    """Fresh leaf tensors for ``fields``, cloned from the scene's."""
    return {f: getattr(scene, f).detach().clone().requires_grad_(True) for f in fields}


def _grads(params: dict, grads) -> dict:
    return {f: torch.zeros_like(p) if g is None else g
            for (f, p), g in zip(params.items(), grads)}


def render_value_and_grad(
    config: RenderConfig,
    scene,
    xs,
    ys,
    sample_indices,
    loss_fn: Callable[[Vec3], torch.Tensor] | None = None,
    fields: Sequence[str] = DIFFERENTIABLE_FIELDS,
):
    """Returns (loss, grads), grads mapping field name -> gradient.

    loss_fn maps the per-lane radiance Vec3 to a scalar; the default is the
    mean luminance. xs, ys, sample_indices: (R,) int32 tensors on the
    scene's device, one sample per lane (average several calls for several
    samples; samples are independent)."""
    loss_fn = mean_luminance if loss_fn is None else loss_fn
    params = _leaves(scene, fields)
    c = path_trace_samples(config, scene._replace(**params), xs, ys, sample_indices)
    loss = loss_fn(c)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), _grads(params, grads)


def make_render_grad_fn(
    config: RenderConfig,
    fields: Sequence[str] = DIFFERENTIABLE_FIELDS,
    loss_fn: Callable[[Vec3], torch.Tensor] | None = None,
):
    """(scene, xs, ys, sample_indices) -> (loss, grads)."""

    def fn(scene, xs, ys, sample_indices):
        return render_value_and_grad(config, scene, xs, ys, sample_indices, loss_fn, fields)

    return fn


def make_fast_grad_fn(
    config: RenderConfig,
    fields: Sequence[str] = DIFFERENTIABLE_FIELDS,
    loss_fn: Callable[[Vec3], torch.Tensor] | None = None,
):
    """Record/replay gradients: (scene, xs, ys, sample_indices) -> (loss,
    grads), like ``make_render_grad_fn``.

    Pass 1, without autograd, traces the lanes with the scene's walk (the
    wide mega-table when the scene has wide tables; the ray-query kernels on
    the card) and records the hit topology of every bounce. Pass 2 runs
    autograd through a replay of the same radiance computation with every
    ray query replaced by a record lookup. Traversal is outside the graph
    in the slow path too, so the gradients are the same, with no walk in
    the graph."""
    loss_fn = mean_luminance if loss_fn is None else loss_fn

    def fn(scene, xs, ys, sample_indices):
        with torch.no_grad():
            _, records = path_trace_samples(
                config, _detached(scene), xs, ys, sample_indices, record=True
            )
        return replay_value_and_grad(config, scene, xs, ys, sample_indices, records,
                                     loss_fn, fields)

    return fn


def make_fast_grad_frame_fn(
    config: RenderConfig,
    n_pixels: int,
    spp: int,
    fields: Sequence[str] = DIFFERENTIABLE_FIELDS,
    loss_fn: Callable[[Vec3], torch.Tensor] | None = None,
    sample_base: int = 0,
):
    """Frame record/replay gradients through the megakernel: scene ->
    (loss, grads).

    Like ``make_fast_grad_fn``, but pass 1 records the hit topology with the
    megakernel (``path_trace_megakernel(record=True)``: its record build K6
    on the card, one launch) over the row-major pixels [0, n_pixels) x
    samples [sample_base, sample_base + spp), and pass 2 runs autograd
    through the scan's replay of one lane per (pixel, sample) work item,
    sample-major (item k * n_pixels + p is sample sample_base + k of pixel
    p): ``loss_fn`` sees the radiance of the n_pixels * spp items in that
    order. The replay runs in chunks of ``REPLAY_CHUNK`` lanes (see there).
    Needs the wide tables; sun-NEE scenes only (the record build's
    constraint). The JAX function's SIMD schedule knobs (``lanes``,
    ``leaf_every``, ``service_div``) have nothing to schedule here."""
    from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel

    loss_fn = mean_luminance if loss_fn is None else loss_fn

    def fn(scene):
        xs, ys, si = frame_items(config, n_pixels, spp, sample_base, scene.nl8.device)
        with torch.no_grad():
            _, records, n_truncated = path_trace_megakernel(
                config, _detached(scene), n_pixels, spp, sample_base, record=True,
                return_truncated=True, device=scene.nl8.device,
            )
        out = replay_value_and_grad(config, scene, xs, ys, si, records, loss_fn, fields)
        # read once the replay is queued, so the record launch is not waited
        # for on its own: a sample the step cap abandoned keeps the rows it
        # wrote and zeros after them, and its replay would be a wrong path
        k = int(n_truncated[0])
        if k:
            raise RuntimeError(
                f"megakernel step cap abandoned {k} samples (samples [{sample_base}, "
                f"{sample_base + spp})): their records are incomplete"
            )
        return out

    return fn


def frame_items(config: RenderConfig, n_pixels: int, spp: int, sample_base: int, device,
                pixel_base: int = 0):
    """(xs, ys, sample_indices) of the frame's work items, int32 on
    ``device``: item k * n_pixels + p is sample sample_base + k of pixel
    pixel_base + p of the row-major frame (the megakernel's record
    order)."""
    item = torch.arange(n_pixels * spp, dtype=torch.int64, device=device)
    pix = item % n_pixels + pixel_base
    xs = (pix % config.image_width).to(torch.int32)
    ys = torch.div(pix, config.image_width, rounding_mode="floor").to(torch.int32)
    # sample_base + k wraps as int32, as the megakernel's does
    si = (torch.div(item, n_pixels, rounding_mode="floor") + _wrap_int32(sample_base))
    si = ((si + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    return xs, ys, si


def _slice_records(records, a: int, b: int):
    prim, bounce = records
    return ({k: v[a:b] for k, v in prim.items()}, {k: v[:, a:b] for k, v in bounce.items()})


def replay_value_and_grad(config, scene, xs, ys, sample_indices, records, loss_fn,
                          fields):
    """Pass 2 of the fast gradients: autograd through the replay of
    ``records`` on these lanes. Returns (loss, grads).

    Up to ``REPLAY_CHUNK`` lanes replay at once. Past that, the replay runs
    first without autograd, chunk by chunk, for the loss and its cotangent
    with respect to every lane's radiance; then each chunk replays again
    under autograd and takes its share of that cotangent backward, adding
    into the fields' gradients."""
    loss_fn = mean_luminance if loss_fn is None else loss_fn
    params = _leaves(scene, fields)
    s = scene._replace(**params)
    targets = list(params.values())
    n = xs.shape[0]
    replay = lambda a, b: path_trace_samples(
        config, s, xs[a:b], ys[a:b], sample_indices[a:b],
        replay=_slice_records(records, a, b))
    if n <= REPLAY_CHUNK:
        loss = loss_fn(replay(0, n))
        grads = torch.autograd.grad(loss, targets, allow_unused=True)
        return loss.detach(), _grads(params, grads)

    spans = [(a, min(n, a + REPLAY_CHUNK)) for a in range(0, n, REPLAY_CHUNK)]
    with torch.no_grad():
        parts = [replay(a, b) for a, b in spans]
    c = Vec3(*(torch.cat([p[i] for p in parts]).requires_grad_(True) for i in range(3)))
    loss = loss_fn(c)
    gc = torch.autograd.grad(loss, list(c), allow_unused=True)
    gc = [torch.zeros_like(x) if g is None else g for x, g in zip(c, gc)]
    total = [None] * len(targets)
    for a, b in spans:
        c = replay(a, b)
        part = torch.autograd.grad(list(c), targets, [g[a:b] for g in gc], allow_unused=True)
        total = [t if p is None else (p if t is None else t + p) for t, p in zip(total, part)]
    return loss.detach(), _grads(params, total)
