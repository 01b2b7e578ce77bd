"""Frames over hosts (the JAX package's ``parallel/multihost.py``, same
names).

The reference has no distributed layer. Frames are embarrassingly
parallel, so the coarsest and most effective distribution is frames
round-robined over hosts (``frames_for_host``), each host rendering its
frames over its own devices (``local_device_mesh`` +
``sharding.render_frame_sharded``) and writing its own files: the frames
need no collective, and the file system composes the output. The process
group (``torch.distributed`` with the ``gloo`` backend, where the JAX
package uses ``jax.distributed``) gives each process its rank and the
world size, and carries the demo's sanity all-reduce
(``parallel/multihost_demo.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from pathtracing_tpu_torch.config import RenderConfig


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the process group (idempotent: a second call does nothing).

    ``coordinator_address`` is "host:port" of rank 0; with no arguments
    the ``env://`` variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
    are read, as ``torch.distributed`` reads them."""
    if dist.is_initialized():
        return
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group("gloo", init_method=init, **kw)


def frames_for_host(
    begin: int, end: int, process_id: int | None = None, n_hosts: int | None = None
) -> list[int]:
    """Round-robin frame assignment: frame f goes to host f % n_hosts. The
    rank and world size default to the process group's (0 and 1 outside
    one)."""
    grouped = dist.is_initialized()
    pid = (dist.get_rank() if grouped else 0) if process_id is None else process_id
    n = (dist.get_world_size() if grouped else 1) if n_hosts is None else n_hosts
    return [f for f in range(begin, end) if f % n == pid]


def local_device_mesh(n_samples: int = 1, device_type: str = "cuda"):
    """A (tiles, samples) mesh over this host's devices: its CUDA cards
    (ValueError when there are fewer than ``n_samples``), or the CPU when
    ``device_type="cpu"`` asks for it."""
    from pathtracing_tpu_torch.parallel.sharding import make_mesh

    if device_type == "cpu":
        local = [torch.device("cpu")]
    elif device_type == "cuda":
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    n_tiles = max(len(local) // n_samples, 1)
    return make_mesh(n_tiles, n_samples, local[: n_tiles * n_samples])


def render_frames_distributed(
    config: RenderConfig,
    scene_factory,
    begin: int,
    end: int,
    out_dir: str,
    spp: int | None = None,
    device_type: str = "cuda",
) -> None:
    """Render [begin, end) with frames round-robined across hosts and each
    frame sharded over this host's devices (``local_device_mesh``), each
    written to ``out_dir/frame_NNNN.bmp``.

    scene_factory(frame_index) -> SceneDevice for that frame."""
    from pathtracing_tpu_torch.io.bmp import write_bmp
    from pathtracing_tpu_torch.parallel.sharding import render_frame_sharded
    from pathtracing_tpu_torch.render import to_bgra

    mesh = local_device_mesh(device_type=device_type)
    for frame_index in frames_for_host(begin, end):
        colors = render_frame_sharded(config, scene_factory(frame_index), mesh, spp)
        write_bmp(os.path.join(out_dir, f"frame_{frame_index:04d}.bmp"),
                  to_bgra(colors, device=mesh.devices[0, 0]))
