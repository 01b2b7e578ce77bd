"""The CUDA ray-query kernel: build, binding and wrapper.

``ray_query_cuda`` is the counterpart of the JAX package's
``ray_query_pallas`` (pathtracing_tpu/ops/pallas_traversal.py): same
contract as ``ops/traversal.ray_query``, served by the hand-written kernel
in ``csrc/ray_query.cu`` (one thread per ray; see the note at the top of
that file for what bounds it and what its design does about it).

Differences from the TPU wrapper's interface, on purpose:
  * no ``block`` / ``leaf_every`` arguments — they were schedule knobs of a
    SIMD loop whose results are identical by construction; a thread leaves
    its own loop here;
  * no ``vmem_fits`` gate and no ``ray_query_auto`` — the kernel reads the
    tables from device memory through L2 and takes any table size, and
    there is no second path to give way to: a build or launch failure
    propagates. ``table_bytes`` only reports the tables' size.

Build: ``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers: seconds, not minutes). Built at first use
from the source in this package into ``build/torch_kernels/`` at the root
of the checkout, under a name keyed by a hash of source and flags, so a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from pathtracing_tpu_torch.ops.traversal import RayHit
from pathtracing_tpu_torch.utils.vec import Vec3

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ray_query.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# Parity flags: no FMA contraction (the oracle goldens were made without it,
# and contraction in the triangle test flips equal-t ties between coincident
# triangles), IEEE division and square root, denormals kept (the link words
# in nl8 are bit patterns, small ones subnormal). No fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "--prec-div=true", "--prec-sqrt=true", "--ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches of the kernel since the last reset: incremented where the kernel
# is launched and nowhere else, so a run can show that it went through it.
launches = 0

_lib = None
build_seconds: float | None = None  # set when this process built the library


def reset_launches() -> None:
    global launches
    launches = 0


def table_bytes(scene) -> int:
    """Bytes of the four tables the kernel reads (reporting only: nothing is
    gated on it)."""
    return sum(
        t.numel() * t.element_size()
        for t in (scene.nl8, scene.tri_pos, scene.inst_f, scene.inst_u)
    )


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
            if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
                return os.path.join(root, "bin", "nvcc")
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return nvcc


def build_command(nvcc: str, source, out, extra=()) -> list[str]:
    """The one compiler call that builds the kernel's shared library."""
    return [nvcc, *NVCC_FLAGS, *extra, "-o", str(out), str(source)]


def _library_path() -> pathlib.Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"ray_query_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Build the library if its hash-named file is missing; returns its path.
    ``verbose`` adds ptxas' register/spill report to the returned build log
    (``build.log`` beside the library)."""
    global build_seconds
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = build_command(
        find_nvcc(), SOURCE, tmp, extra=("-Xptxas", "-v") if verbose else ()
    )
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a half-written library is never loaded
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.pt_ray_query.argtypes = [p] * 15 + [f, f, i] + [p] * 7 + [i, p]
        lib.pt_ray_query.restype = i
        lib.pt_ray_query_block_size.argtypes = []
        lib.pt_ray_query_block_size.restype = i
        _lib = lib
    return _lib


def block_size() -> int:
    """Threads per block of the built kernel."""
    return int(_load().pt_ray_query_block_size())


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ray_query_cuda(
    scene,
    tlas_count,
    tlas_offset,
    org: Vec3,
    d: Vec3,
    tmin,
    tmax0,
    active,
    anyhit=False,
):
    """Ray query on CUDA tensors by the hand-written kernel; same contract
    as ``ops/traversal.ray_query``. Returns (RayHit, occluded).

    ``anyhit``: a Python bool, or a per-lane bool tensor (one batch may mix
    shadow and bounce rays). ``tmax0``: a scalar or a per-lane f32 tensor.

    Launches on PyTorch's current stream and does not synchronise. Raises on
    a tensor of the wrong device, dtype, shape or layout, and on a refused
    launch; it never gives way to the plain version.
    """
    global launches
    device = org.x.device
    if device.type != "cuda":
        raise ValueError(f"ray_query_cuda needs CUDA tensors, got {device}")
    if scene.wide_rows is not None or scene.nl5 is not None:
        raise NotImplementedError(
            "wide-BVH and bf16 node tables are later slices of the port"
        )
    R = org.x.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _check("scene.nl8", scene.nl8, f32, (scene.nl8.shape[0], 8), device)
    _check("scene.tri_pos", scene.tri_pos, f32, (scene.tri_pos.shape[0], 12), device)
    _check("scene.inst_f", scene.inst_f, f32, (scene.inst_f.shape[0], 21), device)
    _check("scene.inst_u", scene.inst_u, i32, (scene.inst_u.shape[0], 6), device)
    for name, t in (("scene.nl8", scene.nl8), ("scene.tri_pos", scene.tri_pos)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows are read as 16-byte vectors; "
                             "the table must be 16-byte aligned")
    _check("tlas_count", tlas_count, i32, (R,), device)
    _check("tlas_offset", tlas_offset, i32, (R,), device)
    for name, t in zip(("org.x", "org.y", "org.z", "d.x", "d.y", "d.z"), (*org, *d)):
        _check(name, t, f32, (R,), device)
    _check("active", active, b8, (R,), device)

    anyhit_lane, anyhit_all = None, 0
    if isinstance(anyhit, torch.Tensor):
        _check("anyhit", anyhit, b8, (R,), device)
        anyhit_lane = anyhit
    elif isinstance(anyhit, bool):
        anyhit_all = int(anyhit)
    else:
        raise TypeError("anyhit: a Python bool or a per-lane bool tensor")

    tmax_lane, tmax_all = None, 0.0
    if isinstance(tmax0, torch.Tensor) and tmax0.dim() > 0:
        _check("tmax0", tmax0, f32, (R,), device)
        tmax_lane = tmax0
    else:
        tmax_all = float(tmax0)

    lib = _load()
    thit = torch.empty(R, dtype=f32, device=device)
    bu = torch.empty(R, dtype=f32, device=device)
    bv = torch.empty(R, dtype=f32, device=device)
    inst = torch.empty(R, dtype=i32, device=device)
    prim = torch.empty(R, dtype=i32, device=device)
    back = torch.empty(R, dtype=b8, device=device)
    occ = torch.empty(R, dtype=b8, device=device)

    # The launch is asynchronous. Inputs and outputs need no reference kept
    # past this call: PyTorch's allocator hands a freed block out again only
    # in the order of the stream it was used on, and this is that stream.
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_ray_query(
            ptr(scene.nl8), ptr(scene.tri_pos), ptr(scene.inst_f), ptr(scene.inst_u),
            ptr(tlas_count), ptr(tlas_offset),
            ptr(org.x), ptr(org.y), ptr(org.z), ptr(d.x), ptr(d.y), ptr(d.z),
            ptr(tmax_lane), ptr(active), ptr(anyhit_lane),
            float(tmin), tmax_all, anyhit_all,
            ptr(thit), ptr(bu), ptr(bv), ptr(inst), ptr(prim), ptr(back), ptr(occ),
            R, stream,
        )
    if err != 0:
        raise RuntimeError(f"ray_query kernel launch refused: cudaError {err}")
    if R > 0:
        launches += 1
    hit = RayHit(
        thit=thit, bary_u=bu, bary_v=bv, bary_w=1.0 - bu - bv,
        inst=inst, prim=prim, back=back,
    )
    return hit, occ
