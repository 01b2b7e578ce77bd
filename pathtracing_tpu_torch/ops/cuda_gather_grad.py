"""The backward kernels of the integrator's custom-VJP gathers (K7):
binding and wrappers.

``small_table_grad_cuda`` (K7a) and ``row_grad_cuda`` (K7b) compute the
transposes of ``table[idx]`` for the tiny subframe tables and of
``table[index]`` for an index of shape (R,) or (R, 3) into any table with at
most 32 columns (``vattr``, ``inst_f``, ``tri_pos``), with the hand-written
kernels in ``csrc/gather_grad.cu`` (see the note at the top of that file for
the designs). They are what ``ops/integrator.SmallTableGather`` /
``RowGather`` run backward for CUDA tensors;
``ops/integrator.small_table_grad_plain`` / ``row_grad_plain`` are their
plain versions, for CPU tensors.

K7a sums a block's stretch of rows with every thread and folds the blocks'
partials in the same launch; K7b sorts the indices stably by counting (in
one pass for a table of at most 12,288 rows, in passes over digits past
that) and sums each run of equal indices.

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

_p, _i, _q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_qp = ctypes.POINTER(ctypes.c_longlong)
LIBRARY = KernelLibrary(
    SOURCE,
    symbols={
        "pt_small_table_grad_work": ([_i, _i, _i], _q),
        "pt_small_table_grad": ([_p, _p, _i, _i, _i, _i, _p, _p, _p], _i),
        "pt_row_grad_passes": ([_i], _i),
        "pt_row_grad_work": ([_i, _i, _i, _qp, _qp], None),
        "pt_row_grad": ([_p, _p, _i, _i, _i, _p, _p, _p, _p], _i),
    },
)

# Rows one block of K7a sums, and the most blocks: the count depends on R
# alone, so the order of every sum, and so the bytes, do too.
ROWS_PER_BLOCK = 512
MAX_BLOCKS = 1024

# Launches of each kernel since the last reset (one per wrapper call that
# launches): incremented where the kernel is launched and nowhere else.
small_table_launches = 0
row_launches = 0


def reset_launches() -> None:
    global small_table_launches, row_launches
    small_table_launches = 0
    row_launches = 0


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
    if R == 0 or C == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32, device=device)
    blocks = small_table_blocks(R)
    lib = LIBRARY.load()
    out = torch.empty((n_rows, C), dtype=torch.float32, device=device)
    work = torch.empty(lib.pt_small_table_grad_work(blocks, n_rows, C), dtype=torch.float64,
                       device=device)
    with torch.cuda.device(device):
        err = lib.pt_small_table_grad(g.data_ptr(), idx.data_ptr(), R, n_rows, C, blocks,
                                      work.data_ptr(), out.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"small_table_grad launch refused: {err}")
    small_table_launches += 1
    return out


def row_grad_cuda(index: torch.Tensor, g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K7b: ``out[v, :] = sum of g.flat[j, :] over j with index.flat[j] ==
    v``, (n_rows, C) float32, for an int32 ``index`` of shape (R,) or (R, 3)
    and a float32 ``g`` of shape index.shape + (C,), contiguous CUDA
    tensors, C <= 32. An index outside [0, n_rows) adds nowhere."""
    global row_launches
    if index.dim() not in (1, 2) or (index.dim() == 2 and index.shape[1] != 3):
        raise ValueError(f"index: shape {tuple(index.shape)}, expected (R,) or (R, 3)")
    if g.dim() != index.dim() + 1:
        raise ValueError(f"g: shape {tuple(g.shape)}, expected index.shape + (C,) = "
                         f"{tuple(index.shape)} + (C,)")
    C = g.shape[-1]
    if C > 32:
        raise ValueError(f"g: {C} columns, the kernel takes at most 32")
    device = g.device
    if device.type != "cuda":
        raise ValueError(f"row_grad_cuda needs CUDA tensors, got {device}")
    _check("g", g, torch.float32, (*index.shape, C), device)
    _check("index", index, torch.int32, None, device)
    if n_rows <= 0:
        raise ValueError(f"n_rows={n_rows}: must be > 0")
    N = index.numel()
    if N == 0 or C == 0:
        return torch.zeros((n_rows, C), dtype=torch.float32, device=device)
    if N >= 1 << 31 or n_rows >= 1 << 31:
        raise ValueError(f"{N} entries or {n_rows} rows do not fit in int32")
    lib = LIBRARY.load()
    ints, doubles = ctypes.c_longlong(), ctypes.c_longlong()
    lib.pt_row_grad_work(N, C, n_rows, ctypes.byref(ints), ctypes.byref(doubles))
    out = torch.empty((n_rows, C), dtype=torch.float32, device=device)
    wi = torch.empty(ints.value, dtype=torch.int32, device=device)
    wd = torch.empty(doubles.value, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        err = lib.pt_row_grad(index.data_ptr(), g.data_ptr(), N, C, n_rows, wi.data_ptr(),
                              wd.data_ptr(), out.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"row_grad launch refused: {err}")
    row_launches += 1
    return out
