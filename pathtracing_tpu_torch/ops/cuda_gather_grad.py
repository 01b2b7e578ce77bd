"""The backward kernels of the integrator's two custom-VJP gathers (K7):
binding and wrappers.

``small_table_grad_cuda`` (K7a) and ``vattr_grad3_cuda`` (K7b) compute the
transposes of ``table[idx]`` and ``vattr[ti3]`` with the hand-written kernels
in ``csrc/gather_grad.cu`` (see the note at the top of that file for the
designs: block partials in row order for the tiny subframe tables; a stable
sort and one sum per run of equal indices for the vertex table). They are
what ``ops/integrator.SmallTableGather`` / ``VattrGather3`` run backward for
CUDA tensors; ``ops/integrator.small_table_grad_plain`` /
``vattr_grad3_plain`` are their plain versions, for CPU tensors.

Both are deterministic: two calls give the same bytes. Both add in double
and round once to float, as the plain versions do. There is no second
path to give way to: a build or launch failure, or a tensor the kernel does
not take (CPU tensors among them), raises. Autograd runs a backward on a
thread of its own, so the launches take ``torch.cuda.current_stream()`` of
the tensors' device there.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracing_tpu_torch.ops.cuda_build import CSRC, KernelLibrary, check_tensor as _check

SOURCE = CSRC / "gather_grad.cu"

_p, _i = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    SOURCE,
    symbols={
        "pt_small_table_grad": ([_p, _p, _i, _i, _i, _i, _p, _p, _p], _i),
        "pt_vattr_grad3": ([_p, _p, _p, _i, _i, _i, _p, _p, _p, _p], _i),
        "pt_vattr_grad3_chunk": ([], _i),
    },
)

# Rows one block of K7a sums, and the most blocks: the count depends on R
# alone, so the order of every sum, and so the bytes, do too.
ROWS_PER_BLOCK = 2048
MAX_BLOCKS = 1024

# Launches of each kernel since the last reset (one per wrapper call that
# launches): incremented where the kernel is launched and nowhere else.
small_table_launches = 0
vattr_launches = 0


def reset_launches() -> None:
    global small_table_launches, vattr_launches
    small_table_launches = 0
    vattr_launches = 0


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def small_table_blocks(R: int) -> int:
    """K7a's block count for R rows."""
    return max(1, min(MAX_BLOCKS, -(-R // ROWS_PER_BLOCK), R))


def small_table_grad_cuda(idx: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K7a: ``out[s, c] = sum of g[r, c] over r with idx[r] == s``, (n_rows,
    C) float32, for int32 ``idx`` (R,) and float32 ``g`` (R, C), contiguous
    CUDA tensors. An index outside [0, n_rows) adds nowhere."""
    global small_table_launches
    if g.dim() != 2:
        raise ValueError(f"g: shape {tuple(g.shape)}, expected (R, C)")
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"small_table_grad_cuda needs CUDA tensors, got {device}")
    R, C = g.shape
    _check("g", g, torch.float32, (R, C), device)
    _check("idx", idx, torch.int32, (R,), device)
    if n_rows <= 0:
        raise ValueError(f"n_rows={n_rows}: must be > 0")
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=device)
    if R == 0 or C == 0:
        return out
    blocks = small_table_blocks(R)
    partial = torch.empty((blocks, n_rows * C), dtype=torch.float64, device=device)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        err = lib.pt_small_table_grad(g.data_ptr(), idx.data_ptr(), R, n_rows, C, blocks,
                                      partial.data_ptr(), out.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"small_table_grad launch refused: {err}")
    small_table_launches += 1
    return out


def vattr_grad3_cuda(ti3: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K7b: ``out[v, :] = sum of g.flat[j, :] over j with ti3.flat[j] ==
    v``, (n_rows, C) float32, for int32 ``ti3`` (R, 3) and float32 ``g`` (R,
    3, C), contiguous CUDA tensors, C <= 32. The indices are sorted stably on
    the card first (``torch.sort``, glue); an index outside [0, n_rows) adds
    nowhere."""
    global vattr_launches
    if g.dim() != 3 or g.shape[1] != 3:
        raise ValueError(f"g: shape {tuple(g.shape)}, expected (R, 3, C)")
    if g.shape[2] > 32:
        raise ValueError(f"g: {g.shape[2]} columns, the kernel takes at most 32")
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"vattr_grad3_cuda needs CUDA tensors, got {device}")
    R, _, C = g.shape
    _check("g", g, torch.float32, (R, 3, C), device)
    _check("ti3", ti3, torch.int32, (R, 3), device)
    if n_rows <= 0:
        raise ValueError(f"n_rows={n_rows}: must be > 0")
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=device)
    N = 3 * R
    if N == 0 or C == 0:
        return out
    if N >= 1 << 31:
        raise ValueError(f"{N} rows do not fit in int32")
    keys, perm = torch.sort(ti3.reshape(-1), stable=True)
    perm = perm.to(torch.int32)
    lib = LIBRARY.load()
    chunks = -(-N // lib.pt_vattr_grad3_chunk())
    head = torch.empty((chunks, C), dtype=torch.float64, device=device)
    tail = torch.empty((chunks, C), dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        err = lib.pt_vattr_grad3(keys.data_ptr(), perm.data_ptr(), g.data_ptr(), N, C,
                                 n_rows, head.data_ptr(), tail.data_ptr(), out.data_ptr(),
                                 _stream(device))
    if err != 0:
        raise RuntimeError(f"vattr_grad3 launch refused: {err}")
    vattr_launches += 1
    return out
