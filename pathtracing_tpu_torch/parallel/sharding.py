"""Pixel and sample sharding of the render loop (the JAX package's
``parallel/sharding.py``, same names).

The reference's only parallelism is one OpenMP loop over pixels
(reference: main.cc:16). The decomposition is two mesh axes:

  * ``tiles``: each device owns a disjoint contiguous slice of the flat
    pixel list. No communication.
  * ``samples``: each device renders a disjoint ``sample_index`` range of
    the same pixels, and the partial sums are added on the output device
    in shard order (JAX's ``psum``). Valid because the RNG seed depends
    only on (x, y, sample_index, student_id) (reference:
    path_tracer.hh:659), so sample ranges can be rendered anywhere and
    summed.

One controller drives the mesh (``parallel/__init__.py``): shard (t, s)
runs on ``mesh.devices[t, s]`` with a copy of the scene there (none when
the scene already lies on it), and every result is returned on the mesh's
first device, ``mesh.devices[0, 0]``. The adds run in a fixed order, so a
sharded result repeats bit for bit: with one sample shard it is the
single-device result, and with several it is the shard-order sum of the
single-device sums of each shard's sample range.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.config import RenderConfig
from pathtracing_tpu_torch.diff.render import (
    DIFFERENTIABLE_FIELDS,
    _detached,
    _grads,
    _leaves,
    frame_items,
    replay_value_and_grad,
)
from pathtracing_tpu_torch.ops.integrator import path_trace_samples
from pathtracing_tpu_torch.ops.megakernel import path_trace_megakernel
from pathtracing_tpu_torch.ops.wavefront import _coords, path_trace_wavefront
from pathtracing_tpu_torch.render import _render_tile


class Mesh:
    """A grid of ``torch.device``s with named axes, the single-controller
    counterpart of ``jax.sharding.Mesh``. ``devices`` is an object array
    (or nested lists) of devices, one axis per name; a device may appear
    more than once."""

    def __init__(self, devices, axis_names):
        devs = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[i] = torch.device(d)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_tiles: int, n_samples: int, devices=None) -> Mesh:
    """A (tiles, samples) mesh over the first n_tiles * n_samples of
    ``devices`` (None: this machine's CUDA cards; never the CPU unasked).
    Raises ValueError when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_tiles * n_samples
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        devs[i] = resolve_device(d)
    return Mesh(devs.reshape(n_tiles, n_samples), ("tiles", "samples"))


def scene_on(scene, device):
    """The scene with every table on ``device``: the scene itself when its
    tables already lie there, else a copy (a byte copy per table)."""
    device = torch.device(device)
    if scene.nl8.device == device:
        return scene
    return type(scene)(*(None if t is None else t.to(device) for t in scene))


def _axes(mesh: Mesh, spp: int):
    n_tiles, n_samples = mesh.shape["tiles"], mesh.shape["samples"]
    if spp % n_samples:
        raise ValueError(f"spp {spp} is not a multiple of {n_samples} sample shards")
    return n_tiles, n_samples, spp // n_samples


def _split(n: int, n_tiles: int, what: str) -> int:
    if n % n_tiles:
        raise ValueError(f"{what} {n} is not a multiple of {n_tiles} tiles")
    return n // n_tiles


def _shard_sum(parts, out):
    """Per tile, the shards' tuples of tensors added on ``out`` in shard
    order (the first shard's, plus the second's, ...); the tiles then
    concatenated in tile order. ``parts[t][s]`` is shard (t, s)'s tuple."""
    tiles = []
    for row in parts:
        acc = [p.to(out) for p in row[0]]
        for part in row[1:]:
            acc = [a + p.to(out) for a, p in zip(acc, part)]
        tiles.append(acc)
    return tuple(torch.cat([tile[k] for tile in tiles]) for k in range(len(tiles[0])))


def _check_truncated(kind: str, truncated) -> None:
    """Raise when a path kernel's step cap abandoned samples: ``truncated``
    holds (first sample, one-element count tensor) per launch. Read after
    every launch is queued, so no launch waits for another."""
    counts = [int(k.cpu()[0]) for _, k in truncated]
    for (first, _), k in zip(truncated, counts):
        if k:
            raise RuntimeError(f"{kind} step cap abandoned {k} samples (from sample "
                               f"{first}): output would be darkened")


def _sum_luminance(c):
    """The JAX functions' default loss: the summed luminance of the lanes."""
    return torch.sum(0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z)


def make_sharded_render(config: RenderConfig, mesh: Mesh, spp: int, wavefront: bool = False):
    """fn(scene, xs, ys) -> (r, g, b) per-pixel radiance sums over samples
    [0, spp), on the mesh's first device.

    xs / ys: flat pixel lists (numpy or int tensors), split into
    ``tiles`` contiguous slices; each device of a ``samples`` column renders
    its slice of the spp range, by the scan (P1 / K1 on a card) or, with
    ``wavefront=True``, the wavefront renderer (K5 on a card); the column's
    sums are added in shard order."""
    n_tiles, n_samples, local_spp = _axes(mesh, spp)

    def fn(scene, xs, ys):
        m = _split(len(xs), n_tiles, "pixel list of")
        parts = [[None] * n_samples for _ in range(n_tiles)]
        truncated = []
        for t in range(n_tiles):
            for s in range(n_samples):
                dev = mesh.devices[t, s]
                sc = scene_on(scene, dev)
                txs = _coords(xs[t * m:(t + 1) * m], dev)
                tys = _coords(ys[t * m:(t + 1) * m], dev)
                base = s * local_spp
                if wavefront:
                    acc, k = path_trace_wavefront(config, sc, txs, tys, local_spp, base,
                                                  return_truncated=True, device=dev)
                    truncated.append((base, k))
                    parts[t][s] = tuple(acc)
                else:
                    parts[t][s] = _render_tile(config, sc, txs, tys, local_spp, base)
        out = _shard_sum(parts, mesh.devices[0, 0])
        _check_truncated("wavefront", truncated)
        return out

    return fn


def make_sharded_render_megakernel(config: RenderConfig, mesh: Mesh, n_pixels: int, spp: int):
    """fn(scene) -> (r, g, b) per-pixel radiance sums for the row-major
    pixels [0, n_pixels) over samples [0, spp), by the megakernel (K2 on a
    card, its plain version on the CPU), on the mesh's first device.

    Tile t renders its contiguous block through ``pixel_base``, sample
    shard s its range through ``sample_base``: one launch per shard, the
    column's sums added in shard order. Needs the wide tables. The JAX
    function's SIMD schedule knobs (``lanes``, ``leaf_every``,
    ``service_div``) have nothing to schedule here
    (ops/megakernel.py)."""
    n_tiles, n_samples, local_spp = _axes(mesh, spp)
    local_pixels = _split(n_pixels, n_tiles, "n_pixels")

    def fn(scene):
        parts = [[None] * n_samples for _ in range(n_tiles)]
        truncated = []
        for t in range(n_tiles):
            for s in range(n_samples):
                dev = mesh.devices[t, s]
                base = s * local_spp
                acc, k = path_trace_megakernel(
                    config, scene_on(scene, dev), local_pixels, local_spp, base,
                    pixel_base=t * local_pixels, return_truncated=True, device=dev,
                )
                truncated.append((base, k))
                parts[t][s] = tuple(acc)
        out = _shard_sum(parts, mesh.devices[0, 0])
        _check_truncated("megakernel", truncated)
        return out

    return fn


def _reduce_grads(losses, grads, out):
    """Loss and per-field gradients of every shard, added on ``out`` in
    shard order (JAX's ``psum`` over both axes)."""
    loss = losses[0].to(out)
    total = {f: g.to(out) for f, g in grads[0].items()}
    for l, g in zip(losses[1:], grads[1:]):
        loss = loss + l.to(out)
        total = {f: total[f] + g[f].to(out) for f in total}
    return loss, total


def make_sharded_render_grad(
    config: RenderConfig,
    mesh: Mesh,
    spp: int,
    fields=None,
    loss_fn=None,
    remat: bool = True,
):
    """The renderer's distributed training step: fn(scene, xs, ys) ->
    (loss, grads), on the mesh's first device.

    The forward is sharded as ``make_sharded_render``'s scan (pixels over
    ``tiles``, sample ranges over ``samples``); each shard runs autograd on
    its own device, and the loss and the per-field gradients are added over
    both axes in shard order. The loss is the global mean lane-sample value
    of ``loss_fn`` (a Vec3 -> scalar sum; default the summed luminance)
    over every lane and sample, so it does not depend on the mesh's shape.

    remat=True recomputes each sample's forward in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint``): gradient memory
    stays that of one sample, whatever the spp."""
    from torch.utils.checkpoint import checkpoint

    fields = tuple(fields) if fields is not None else DIFFERENTIABLE_FIELDS
    loss_fn = _sum_luminance if loss_fn is None else loss_fn
    n_tiles, n_samples, local_spp = _axes(mesh, spp)

    def fn(scene, xs, ys):
        m = _split(len(xs), n_tiles, "pixel list of")
        losses, grads = [], []
        for t in range(n_tiles):
            for s in range(n_samples):
                dev = mesh.devices[t, s]
                sc = scene_on(scene, dev)
                txs = _coords(xs[t * m:(t + 1) * m], dev)
                tys = _coords(ys[t * m:(t + 1) * m], dev)
                denom = torch.tensor(m * n_tiles * spp, dtype=torch.float32, device=dev)
                params = _leaves(sc, fields)
                shard_scene = sc._replace(**params)

                def sample_loss(sample):
                    si = torch.full(txs.shape, sample, dtype=torch.int32, device=dev)
                    c = path_trace_samples(config, shard_scene, txs, tys, si)
                    return loss_fn(c) / denom

                total = torch.zeros((), dtype=torch.float32, device=dev)
                for k in range(local_spp):
                    sample = s * local_spp + k
                    term = (checkpoint(sample_loss, sample, use_reentrant=False,
                                       preserve_rng_state=False)
                            if remat else sample_loss(sample))
                    total = total + term
                g = torch.autograd.grad(total, list(params.values()), allow_unused=True)
                losses.append(total.detach())
                grads.append(_grads(params, g))
        return _reduce_grads(losses, grads, mesh.devices[0, 0])

    return fn


def make_sharded_fast_grad_frame(
    config: RenderConfig,
    mesh: Mesh,
    n_pixels: int,
    spp: int,
    fields=None,
    loss_fn=None,
):
    """The fast gradients over a frame, sharded: fn(scene) -> (loss, grads)
    over the row-major pixels [0, n_pixels) x samples [0, spp), on the
    mesh's first device.

    Per shard: the megakernel's record pass over its (pixel block x sample
    range) (K6 on a card: ``path_trace_megakernel(record=True,
    pixel_base=)``), then autograd through the replay of those records on
    its device (diff/render.replay_value_and_grad). The loss is the global
    mean lane-sample value of ``loss_fn`` (a Vec3 -> scalar sum; default
    the summed luminance); loss and gradients are added over both axes in
    shard order. Needs the wide tables; sun-NEE scenes only."""
    fields = tuple(fields) if fields is not None else DIFFERENTIABLE_FIELDS
    loss_fn = _sum_luminance if loss_fn is None else loss_fn
    n_tiles, n_samples, local_spp = _axes(mesh, spp)
    local_pixels = _split(n_pixels, n_tiles, "n_pixels")

    def fn(scene):
        losses, grads, truncated = [], [], []
        for t in range(n_tiles):
            for s in range(n_samples):
                dev = mesh.devices[t, s]
                sc = scene_on(scene, dev)
                pixel_base, sample_base = t * local_pixels, s * local_spp
                with torch.no_grad():
                    _, records, k = path_trace_megakernel(
                        config, _detached(sc), local_pixels, local_spp, sample_base,
                        pixel_base=pixel_base, record=True, return_truncated=True,
                        device=dev,
                    )
                truncated.append((sample_base, k))
                xs, ys, si = frame_items(config, local_pixels, local_spp, sample_base, dev,
                                         pixel_base=pixel_base)
                denom = torch.tensor(n_pixels * spp, dtype=torch.float32, device=dev)
                loss, g = replay_value_and_grad(
                    config, sc, xs, ys, si, records, lambda c: loss_fn(c) / denom, fields)
                losses.append(loss)
                grads.append(g)
        out = _reduce_grads(losses, grads, mesh.devices[0, 0])
        # a sample the step cap abandoned keeps incomplete records, and its
        # replay would be a wrong path
        _check_truncated("megakernel record", truncated)
        return out

    return fn


def render_frame_sharded(
    config: RenderConfig,
    scene,
    mesh: Mesh,
    spp: int | None = None,
    wavefront: bool = False,
):
    """Full-frame render across the mesh; returns (H, W, 3) averaged f32
    (numpy). The row-major pixel list is padded with pixel 0 to a multiple
    of the tile count, as the JAX function pads it."""
    spp = spp or config.samples_per_pixel
    W, H = config.image_width, config.image_height
    n_tiles = mesh.shape["tiles"]
    idx = np.arange(W * H, dtype=np.int32)
    idx = np.concatenate([idx, np.zeros((-len(idx)) % n_tiles, np.int32)])
    r, g, b = make_sharded_render(config, mesh, spp, wavefront=wavefront)(
        scene, idx % W, idx // W)
    colors = np.stack([r.cpu().numpy(), g.cpu().numpy(), b.cpu().numpy()], -1)
    colors = colors[: W * H] / np.float32(spp)
    return colors.reshape(H, W, 3)
