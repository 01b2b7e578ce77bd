"""Row-fetch probe: what a random row read from a device-memory table costs.

    python3 -m pathtracing_tpu_torch.probes.gather_probe [--reps 64] [--k 16]
                                                         [--iters 5]

Counterpart of the JAX package's ``tools/gather_probe.py``. The wide-BVH walk
(ops/wide_traversal.py) reads one table row per step per ray, each address
depending on the row before it; this probe measures that row fetch alone, for
a table that fits the card's L2 cache and for one that does not.

``gather_rows(table, idx, k)`` is the function under test: ``(R,)`` int32
indices -> ``(R, W)`` rows of an ``(N, W)`` f32 table. On CUDA tensors it is
the hand-written kernel ``csrc/gather_rows.cu`` (the replacement of that
tool's ``pallas_gather``): where the table spans several L2-sized slices and
the batch has at least ``N`` positions, a counting pass puts the positions in
slice order first (``bucket_order_plain`` is its plain version); then warps
claim chunks of the list and move each row as 16-byte asynchronous copies
through a ``k``-deep ring in shared memory. On CPU tensors it is its plain
version ``gather_rows_plain`` = ``table.index_select(0, idx)``, which is also
the one PyTorch call that computes the same function and so the yardstick the
kernel is timed against.

The harnesses keep the JAX tool's names and arithmetic, over any gather
function:
  chain         ``reps`` dependent gathers: the next indices come from column
                0 of the rows just fetched, as a walk's next cursor does;
  chain_window  the same with every lane's index inside one ``window``-row
                span per step (the span jumps): clustered access;
  indep         ``reps`` independent gathers, nothing carried but a sum.
They are timed with CUDA events on the card (``main``); the tests run them on
the CPU against the JAX tool's own functions.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from pathtracing_tpu_torch import resolve_device
from pathtracing_tpu_torch.ops.cuda_build import (
    CSRC,
    KernelLibrary,
    check_tensor as _check,
)

SOURCE = CSRC / "gather_rows.cu"

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = KernelLibrary(
    SOURCE,
    symbols={
        "pt_gather_rows": ([_p, _p, _p, _i, _i, _i, _i, _p, _p], _i),
        "pt_gather_rows_scratch": ([_i, _i, _i, _i], _ll),
        "pt_gather_rows_order": ([_p, _i, _i, _i, _i, _p, _p], _i),
        "pt_gather_rows_warps": ([], _i),
        "pt_gather_rows_max_in_flight": ([], _i),
        "pt_gather_rows_max_shared_bytes": ([], _i),
        "pt_gather_rows_slice_bytes": ([], _ll),
    },
)

# The kernel's limits, for checking arguments where the library cannot be
# asked (no card); the first launch holds them against the built library.
MAX_IN_FLIGHT = 32            # most row copies in flight per warp
WARPS_PER_BLOCK = 4
MAX_SHARED_BYTES = 232_448    # what one block may use on an H100
SLICE_BYTES = 8 << 20         # the table rows one bucket of the counting pass spans
MAX_BUCKETS = 256

# The two tables of the probe: the golden scene's w8 mega-table (inside L2)
# and a 235 MB table (beyond the 50 MB L2); two batch sizes: a small one and
# the lanes of one 1920x1080 render tile.
TABLES = ((3680, 48), (458752, 128))
LANES = (8192, 2_073_600)
WINDOWS = (4096, 16384, 65536)

# Launches of the kernel's copy since the last reset: incremented where it is
# launched and nowhere else, so a run can show that it went through it.
launches = 0
_limits_held = False


def reset_launches() -> None:
    global launches
    launches = 0


def gather_rows_plain(table, idx):
    """The plain PyTorch version of the kernel: ``table[idx]`` by one
    ``index_select``."""
    return table.index_select(0, idx)


def slice_shift(n_rows: int, width: int, slice_bytes: int = SLICE_BYTES) -> int:
    """log2 of a slice's rows: the most rows of ``width`` floats that fit
    ``slice_bytes``, raised until at most ``MAX_BUCKETS`` slices cover the
    table (the kernel's rule)."""
    shift = 0
    while (width * 4 << (shift + 1)) <= slice_bytes and shift < 30:
        shift += 1
    while ((n_rows - 1) >> shift) + 1 > MAX_BUCKETS:
        shift += 1
    return shift


def buckets(n_rows: int, width: int, lanes: int, slice_bytes: int = SLICE_BYTES) -> int:
    """Slices the kernel's counting pass sorts a batch into; 1 means no pass:
    the table fits one slice, or the batch is smaller than the table (few
    rows repeat)."""
    if lanes < n_rows:
        return 1
    return ((n_rows - 1) >> slice_shift(n_rows, width, slice_bytes)) + 1


def bucket_order_plain(idx, shift: int):
    """The plain version of the counting pass: the positions ``i`` grouped by
    ``idx[i] >> shift``, in ascending bucket. Stable, where the kernel's order
    inside a bucket is not; no byte of the gather depends on it."""
    return torch.argsort(idx >> shift, stable=True)


def gather_in_order_plain(table, idx, order):
    """``table[idx]`` computed the kernel's way: the positions of ``order``
    in turn, each row written at its own position."""
    out = table.new_empty((idx.shape[0], table.shape[1]))
    out[order] = table.index_select(0, idx[order])
    return out


def check_args(table, idx, k, device) -> int:
    """Raise unless (table, idx, k) are what the kernel takes, on ``device``;
    returns ``k`` as an int."""
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected (N, W)")
    N, W = table.shape
    _check("table", table, torch.float32, (N, W), device)
    _check("idx", idx, torch.int32, None, device)
    if idx.dim() != 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected (R,)")
    if N == 0:
        raise ValueError("table: no rows")
    if (W * 4) % 16 or W == 0:
        raise ValueError(
            f"table: rows of {W * 4} bytes; the kernel copies 16-byte pieces, "
            "so the row width must be a positive multiple of 4 floats"
        )
    if table.data_ptr() % 16:
        raise ValueError("table: rows are copied as 16-byte pieces; the table "
                         "must be 16-byte aligned")
    k = int(k)
    if not 1 <= k <= MAX_IN_FLIGHT:
        raise ValueError(f"k: {k} copies in flight, expected 1..{MAX_IN_FLIGHT}")
    ring = WARPS_PER_BLOCK * k * W * 4
    if ring > MAX_SHARED_BYTES:
        raise ValueError(
            f"k={k} rows of {W * 4} bytes for {WARPS_PER_BLOCK} warps need "
            f"{ring} bytes of shared memory; a block has {MAX_SHARED_BYTES}"
        )
    return k


def _library():
    """The built library, its limits held against the wrapper's once."""
    global _limits_held
    lib = LIBRARY.load()
    if not _limits_held:
        built = (lib.pt_gather_rows_max_in_flight(), lib.pt_gather_rows_warps(),
                 lib.pt_gather_rows_max_shared_bytes(), lib.pt_gather_rows_slice_bytes())
        want = (MAX_IN_FLIGHT, WARPS_PER_BLOCK, MAX_SHARED_BYTES, SLICE_BYTES)
        if built != want:
            raise RuntimeError(
                "kernel and wrapper disagree on (copies in flight, warps per "
                f"block, shared bytes per block, slice bytes): {built} vs {want}"
            )
        _limits_held = True
    return lib


def _scratch(lib, table, R, k):
    n = lib.pt_gather_rows_scratch(table.shape[1], table.shape[0], R, k)
    if n < 0:
        raise RuntimeError(f"gather_rows: launch plan refused: cudaError {-n}")
    return torch.empty(n, dtype=torch.int32, device=table.device) if n else None


def _cuda_args(table, idx, k):
    if not isinstance(table, torch.Tensor) or table.device.type != "cuda":
        where = table.device if isinstance(table, torch.Tensor) else type(table).__name__
        raise ValueError(f"gather_rows_cuda needs CUDA tensors, got {where}")
    return check_args(table, idx, k, table.device)


def gather_rows_cuda(table, idx, k: int = 16):
    """``(R, W)`` rows ``table[idx]`` on CUDA tensors by the hand-written
    kernel, ``k`` row copies in flight per warp.

    Launches on PyTorch's current stream and does not synchronise. Raises on
    a tensor of the wrong device, dtype, shape or layout, on a row that is
    not a whole number of 16-byte pieces, on a misaligned table, on ``k``
    outside 1..32, on a ring that does not fit shared memory and on a refused
    launch; it never gives way to the plain version. Indices are not range
    checked: they must lie in ``[0, N)``.
    """
    global launches
    k = _cuda_args(table, idx, k)
    N, W = table.shape
    R = idx.shape[0]
    out = torch.empty((R, W), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        lib = _library()
        scratch = _scratch(lib, table, R, k)
        err = lib.pt_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), W, N, R, k,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch refused: cudaError {err}")
    if R > 0:
        launches += 1
    return out


def bucket_order_cuda(table, idx, k: int = 16):
    """The kernel's counting pass alone, for checks on the card: ``(rows,
    positions)`` in the order the copy takes them, or ``None`` where this
    shape takes no pass. Does not count as a launch of the kernel."""
    k = _cuda_args(table, idx, k)
    N, W = table.shape
    R = idx.shape[0]
    with torch.cuda.device(table.device):
        lib = _library()
        scratch = _scratch(lib, table, R, k)
        err = lib.pt_gather_rows_order(
            idx.data_ptr(), W, N, R, k,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err == 1:
        return None
    if err != 0:
        raise RuntimeError(f"gather_rows counting pass refused: cudaError {err}")
    return scratch[4:4 + R], scratch[4 + R:4 + 2 * R]


def gather_rows(table, idx, k: int = 16):
    """``table[idx]``: CUDA tensors launch the kernel (or raise), CPU tensors
    take the plain version."""
    if table.is_cuda:
        return gather_rows_cuda(table, idx, k)
    return gather_rows_plain(table, idx)


# ----------------------------------------------------------------- harnesses


def chain(gather_fn, table, idx0, reps: int, n_rows: int):
    """``reps`` dependent gathers; each feeds indices derived from the last.
    Nothing here asks the device for a value."""
    idx = idx0
    outs = torch.zeros((), dtype=torch.float32, device=table.device)
    for _ in range(reps):
        rows = gather_fn(table, idx)
        idx = (idx + rows[:, 0].to(torch.int32).abs() + 12345) % n_rows
        outs = outs + rows[0, 0]
    return idx.to(torch.float32).sum() + outs


def chain_window(gather_fn, table, deltas, reps: int, n_rows: int, window: int):
    """Dependent chain where every lane's index stays inside ONE
    ``window``-row span per step (the span itself jumps step to step):
    clustered access, as rays binned by tree region would make. ``deltas``
    are the lanes' offsets in ``[0, window)``; the arithmetic is int32 and
    wraps as the JAX tool's does."""
    base = torch.zeros((), dtype=torch.int32, device=table.device)
    outs = torch.zeros((), dtype=torch.float32, device=table.device)
    for _ in range(reps):
        idx = (base + deltas) % n_rows
        rows = gather_fn(table, idx)
        base = (base + rows[:, 0].sum().to(torch.int32).abs() * 7919 + 104729) % n_rows
        outs = outs + rows[0, 0]
    return base.to(torch.float32) + outs


def indep(gather_fn, table, idx_rows):
    """One independent gather per row of ``idx_rows`` (reps, R); only a sum
    is carried."""
    acc = torch.zeros((), dtype=torch.float32, device=table.device)
    for idx in idx_rows:
        acc = acc + gather_fn(table, idx)[:, 0].sum()
    return acc


# -------------------------------------------------------------------- timing


def make_table(rng: np.random.Generator, n_rows: int, width: int, device):
    """The JAX tool's table: 0.25 or 1.25 in every cell, so column 0 read as
    an integer is a coin flip."""
    a = rng.integers(0, 2, (n_rows, width)).astype(np.float32) + 0.25
    return torch.from_numpy(a).to(device)


def time_ms(fn, iters: int) -> float:
    """Best of ``iters`` runs of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def probe(n_rows: int, width: int, lanes: int, reps: int, k: int, iters: int,
          device) -> list[dict]:
    """Every harness over {kernel, index_select} for one table and batch
    size. The two gather functions must return the same harness value."""
    rng = np.random.default_rng(0)
    table = make_table(rng, n_rows, width, device)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    idx0 = i32(rng.integers(0, n_rows, lanes))
    idx_rows = i32(rng.integers(0, n_rows, (reps, lanes)))
    kernel = lambda t, i: gather_rows_cuda(t, i, k)
    runs = {
        "chain": lambda g: chain(g, table, idx0, reps, n_rows),
        "indep": lambda g: indep(g, table, idx_rows),
    }
    for window in WINDOWS:
        if window >= n_rows:
            continue
        deltas = i32(rng.integers(0, window, lanes))
        runs[f"win{window // 1024}k"] = (
            lambda g, d=deltas, w=window: chain_window(g, table, d, reps, n_rows, w)
        )
    out = []
    for name, run in runs.items():
        values = {}
        for fn_name, g in (("kernel", kernel), ("index_select", gather_rows_plain)):
            values[fn_name] = float(run(g))
            ms = time_ms(lambda: run(g), iters)
            rows = reps * lanes
            out.append({
                "table": [n_rows, width], "lanes": lanes, "reps": reps, "k": k,
                "harness": name, "gather": fn_name, "ms": ms,
                "ns_per_row": ms * 1e6 / rows,
                "payload_gb_per_s": rows * width * 4 / (ms * 1e-3) / 1e9,
            })
        if values["kernel"] != values["index_select"]:
            raise AssertionError(
                f"{name} on {n_rows}x{width}, {lanes} lanes: kernel "
                f"{values['kernel']} != index_select {values['index_select']}"
            )
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    device = resolve_device(None)  # the card, or it raises
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    results = []
    for n_rows, width in TABLES:
        for lanes in LANES:
            for r in probe(n_rows, width, lanes, args.reps, args.k, args.iters,
                           device):
                r["card"] = card
                results.append(r)
                print(
                    f"{r['gather']:12s} {r['harness']:7s} rows={n_rows} width={width} "
                    f"lanes={lanes} reps={args.reps} k={args.k}: best {r['ms']:.3f} ms = "
                    f"{r['ns_per_row']:.4f} ns/row ({r['payload_gb_per_s']:.1f} GB/s payload)",
                    flush=True,
                )
    return results


if __name__ == "__main__":
    main()
