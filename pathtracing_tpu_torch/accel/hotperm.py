"""Hot-row permutation of the chunked wide mega-table (the JAX package's
``accel/hotperm.py``, byte for byte in what it computes).

The JAX package moves the most-gathered rows of the static region to table
indices [0, H), so that its TPU walk can test ``row < H`` and fetch those
rows from a small side table (``SceneDevice.hot_rows``, and the same words
as int8 byte planes, ``hot_planes``, for a one-hot matmul fetch). The port
packs the same tables; its walks (the plain wide walk, K1, K2 and K5) read
every row, hot or not, from ``wide_rows`` by a plain row gather, so the
permutation moves only row addresses and every hit and sum stays
bit-identical to the unpermuted pack.

Row kinds are recovered by a vectorized BFS over the cursor graph (rows do
not carry their kind; the cursors pointing at them do), every cursor field
is rewritten through the permutation, and the root tables (static_root8,
chunks_of) are updated so per-frame tails keep chaining correctly.

Scoring: the structural order (default; BFS level from the static TLAS
root) or a measured per-row score passed by the caller.
"""

from __future__ import annotations

import numpy as np

from pathtracing_tpu_torch.accel.wide import (
    KIND_INST,
    KIND_LEAF,
    KIND_SENTINEL,
    KIND_WIDE,
    WideLayout,
)

u32 = np.uint32
_INVALID = u32(0xFFFFFFFF)


def _cursor_rows(c: np.ndarray, lay: WideLayout):
    return (c >> u32(lay.slot_bits)) & lay.row_mask


def scan_kinds(rows: np.ndarray, lay: WideLayout, roots: np.ndarray):
    """Tag each static row's kind by BFS over the cursor graph.

    rows: (N, W) u32 view of the static region. roots: (K,) u32 cursors.
    Returns (kinds (N,) int8 with -1 = unreachable, levels (N,) int32 BFS
    level with huge for unreachable)."""
    N = rows.shape[0]
    S = lay.n_slots
    kinds = np.full(N, -1, np.int8)
    levels = np.full(N, np.iinfo(np.int32).max, np.int32)
    frontier = np.unique(roots.astype(u32))
    level = 0
    while len(frontier):
        kind = (frontier >> u32(30)).astype(np.int8)
        keep = kind != KIND_SENTINEL
        frontier = frontier[keep]
        kind = kind[keep]
        row = _cursor_rows(frontier, lay).astype(np.int64)
        inside = row < N   # tail rows are outside the static region
        row, kind = row[inside], kind[inside]
        new = kinds[row] == -1
        row, kind = row[new], kind[new]
        if len(row) == 0:
            break
        # a row can appear twice in one frontier batch; first wins
        row, first = np.unique(row, return_index=True)
        kind = kind[first]
        kinds[row] = kind
        levels[row] = level
        nxt = []
        wr = row[kind == KIND_WIDE]
        if len(wr):
            nxt.append(rows[wr][:, lay.links_col:lay.links_col + S].ravel())
            nxt.append(rows[wr][:, lay.exit_col])
        lr = row[kind == KIND_LEAF]
        if len(lr):
            nxt.append(rows[lr][:, lay.next_col])
        ir = row[kind == KIND_INST]
        if len(ir):
            nxt.append(rows[ir][:, 12:20].ravel())
        frontier = (
            np.unique(np.concatenate(nxt).astype(u32)) if nxt
            else np.zeros(0, u32)
        )
        level += 1
    return kinds, levels


def _remap_cursors(c: np.ndarray, perm: np.ndarray, lay: WideLayout,
                   n_static: int):
    """Rewrite the row field of cursor words through perm; sentinels
    (kind 3, incl. 0xFFFFFFFF empty slots) and rows outside the static
    region pass through unchanged."""
    c = c.astype(u32)
    kind = c >> u32(30)
    row = _cursor_rows(c, lay).astype(np.int64)
    ok = (kind != KIND_SENTINEL) & (row < n_static)
    new_row = np.where(ok, perm[np.minimum(row, n_static - 1)], row)
    slot = c & u32((1 << lay.slot_bits) - 1)
    out = (kind << u32(30)) | (new_row.astype(u32) << u32(lay.slot_bits)) | slot
    return np.where(ok, out, c).astype(u32)


def build_perm(score: np.ndarray, hot: int) -> np.ndarray:
    """perm[old_row] = new_row: the ``hot`` highest-score rows move to
    [0, hot) in descending-score order (ties by old id, deterministic);
    everything else keeps its relative order after them."""
    N = len(score)
    hot = min(hot, N)
    order = np.lexsort((np.arange(N), -np.asarray(score, np.float64)))
    top = np.sort(order[:hot])  # hot ids
    is_hot = np.zeros(N, bool)
    is_hot[top] = True
    perm = np.empty(N, np.int64)
    # hot rows ranked by score (not old order) so the very hottest sit
    # lowest — keeps the [0, small) prefix optimal if H is later shrunk
    perm[order[:hot]] = np.arange(hot)
    perm[~is_hot] = hot + np.arange(N - hot)
    return perm


def apply_hot_permutation(static, hot: int, score: np.ndarray | None = None):
    """Permute a ChunkedStaticRegion's rows so the hottest ``hot`` rows
    occupy [0, hot). Mutates static.rows / static.static_root8 /
    static.chunks_of in place and returns the permutation.

    score: optional per-row gather-frequency array (a measured histogram;
    longer arrays are truncated to the static region). Default: structural BFS-level order (top of the static TLAS
    first, then chunk-entry INST rows, then chunk tree tops).
    """
    lay = static.layout
    rows_f = np.asarray(static.rows, np.float32)
    rows = rows_f.view(u32)
    N = rows.shape[0]

    roots = [np.asarray(static.static_root8, u32).ravel()]
    for (_ids, _aabb, r8) in static.chunks_of.values():
        roots.append(np.asarray(r8, u32).ravel())
    roots = np.concatenate(roots)

    kinds, levels = scan_kinds(rows, lay, roots)

    if score is None:
        # structural: lower BFS level = hotter; unreachable rows last.
        # Negate so build_perm's "highest score first" applies.
        s = -levels.astype(np.float64)
    else:
        s = np.zeros(N, np.float64)
        m = min(N, len(score))
        s[:m] = np.asarray(score[:m], np.float64)
    perm = build_perm(s, hot)

    # ---- rewrite cursor fields per kind ----
    out = rows.copy()
    S = lay.n_slots
    wr = np.nonzero(kinds == KIND_WIDE)[0]
    if len(wr):
        cols = list(range(lay.links_col, lay.links_col + S)) + [lay.exit_col]
        for c in cols:
            out[wr, c] = _remap_cursors(rows[wr, c], perm, lay, N)
    lr = np.nonzero(kinds == KIND_LEAF)[0]
    if len(lr):
        out[lr, lay.next_col] = _remap_cursors(
            rows[lr, lay.next_col], perm, lay, N
        )
    ir = np.nonzero(kinds == KIND_INST)[0]
    if len(ir):
        for c in range(12, 20):
            out[ir, c] = _remap_cursors(rows[ir, c], perm, lay, N)

    # ---- permute row storage ----
    dst = np.empty_like(out)
    dst[perm] = out
    static.rows = dst.view(np.float32)

    # ---- remap root tables ----
    static.static_root8 = _remap_cursors(
        np.asarray(static.static_root8, u32), perm, lay, N
    )
    static.chunks_of = {
        k: (ids, aabb, _remap_cursors(np.asarray(r8, u32), perm, lay, N))
        for k, (ids, aabb, r8) in static.chunks_of.items()
    }
    static.hot_count = min(hot, N)
    return perm
