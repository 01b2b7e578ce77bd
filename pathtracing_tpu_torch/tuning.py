"""Per-device-type tuning defaults, with a persisted tuned-file layer.

The JAX package's ``tuning.py`` resolves its schedule knobs through this
table, keyed by ``(platform, size_class)`` where size_class is "large" for
scenes above ``render.LARGE_SCENE_NODES`` packed nodes. The knobs are
scheduling choices: results are bit-identical under every value. Here the
platform is a torch device type ("cpu", "cuda"); ``KNOBS`` is the JAX
package's tuple, so one tuned file (``PT_TUNED_FILE``) serves both
packages: the "cpu" rows are the host's for both, "tpu" rows only the JAX
package reads, "cuda" rows only the port.

What the port reads: ``tile_pixels`` (``render.default_tile_pixels``: the
lanes of a scan or wavefront tile). The binary walk's schedule knobs
(``leaf_every``, ``compact_div``, ``mid_entry``, ``unroll``) and the JAX
megakernel's lane scheduler (``mk_lanes``, ``mk_leaf_every``,
``mk_service_div``) shape an XLA loop whose lanes step together; a CUDA
thread leaves its own loop, so no code of the port reads them, and their
rows stay the CPU's. ``wide_layout`` names the layout the port packs by
default (``scene/device.pack_scene``'s "w8").

Resolution order (first hit wins):
1. an explicit argument (``render_pixels(tile_pixels=...)``, the CLI's
   ``--tile-pixels``),
2. the tuned file (``pathtracing_tpu_torch/tuned.json`` or
   ``$PT_TUNED_FILE``), written by ``record_tuning``,
3. the builtin table below.
"""

from __future__ import annotations

import json
import os
import pathlib
from functools import lru_cache
from typing import Any

KNOBS = (
    "leaf_every", "compact_div", "mid_entry", "unroll", "tile_pixels",
    "mk_lanes", "mk_leaf_every", "mk_service_div", "wide_layout",
)

# Builtin fallbacks; any unknown device type falls back to the "cpu" rows.
BUILTIN: dict[str, dict[str, dict[str, Any]]] = {
    # the JAX package's CPU rows (measured there on the CPU)
    "cpu": {
        "small": {
            "leaf_every": 8,
            "compact_div": 4,
            "mid_entry": False,
            "unroll": False,
            "tile_pixels": 1 << 15,  # cache-bound optimum on the CPU
            "mk_lanes": 1 << 13,
            "mk_leaf_every": 4,
            "mk_service_div": 8,
            "wide_layout": "w8",
        },
        "large": {
            "leaf_every": 16,
            "compact_div": 8,
            "mid_entry": False,
            "unroll": False,
            "tile_pixels": 1 << 15,
            "mk_lanes": 1 << 13,
            "mk_leaf_every": 4,
            "mk_service_div": 8,
            "wide_layout": "w8",
        },
    },
    # An H100. tile_pixels: a scan sample is ~20,000 small eager kernels
    # whatever the tile size, enqueued by the host at ~10 us each, so a tile
    # is as large as memory allows: 2^21 lanes take a 1080p frame whole (the
    # merged ray query then runs 2 x tile lanes; PERF.md has the peak memory
    # taken on the card). wide_layout: w8, the fastest of the three layouts
    # in K2 on the card (PERF.md). The schedule knobs keep the CPU rows:
    # no code of the port reads them (see the module's note).
    "cuda": {
        "small": {
            "leaf_every": 8,
            "compact_div": 4,
            "mid_entry": False,
            "unroll": False,
            "tile_pixels": 1 << 21,
            "mk_lanes": 1 << 13,
            "mk_leaf_every": 4,
            "mk_service_div": 8,
            "wide_layout": "w8",
        },
        "large": {
            "leaf_every": 16,
            "compact_div": 8,
            "mid_entry": False,
            "unroll": False,
            "tile_pixels": 1 << 21,
            "mk_lanes": 1 << 13,
            "mk_leaf_every": 4,
            "mk_service_div": 8,
            "wide_layout": "w8",
        },
    },
}


def tuned_file_path() -> pathlib.Path:
    env = os.environ.get("PT_TUNED_FILE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).parent / "tuned.json"


@lru_cache(maxsize=None)
def _load_tuned(path_str: str, mtime_ns: int, size: int) -> dict:
    try:
        with open(path_str) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _tuned() -> dict:
    """The tuned file's contents, read again whenever its modification time
    or its size changes."""
    p = tuned_file_path()
    try:
        st = p.stat()
    except OSError:
        return {}
    return _load_tuned(str(p), st.st_mtime_ns, st.st_size)


def get_tuning(platform: str, size_class: str) -> dict[str, Any]:
    """Merged knob dict for (platform, size_class).

    ``platform`` is a torch device type ("cpu"/"cuda"/...); unknown device
    types use the cpu rows. ``size_class`` is "small" or "large". The tuned
    file's knobs for the pair override the builtin row, knob by knob; a file
    that cannot be read or parsed counts as empty.
    """
    base = BUILTIN.get(platform, BUILTIN["cpu"]).get(size_class)
    if base is None:
        base = BUILTIN["cpu"]["small"]
    out = dict(base)
    tuned = _tuned().get(platform, {}).get(size_class, {})
    for k in KNOBS:
        if k in tuned:
            out[k] = tuned[k]
    return out


def record_tuning(platform: str, size_class: str, **knobs: Any) -> pathlib.Path:
    """Persist measured knob optima into the tuned file (read-modify-write;
    unknown knob names are rejected). Returns the file path."""
    bad = set(knobs) - set(KNOBS)
    if bad:
        raise ValueError(f"unknown knobs: {sorted(bad)}")
    p = tuned_file_path()
    data: dict = {}
    if p.exists():
        try:
            data = json.loads(p.read_text())
        except ValueError:
            data = {}
    data.setdefault(platform, {}).setdefault(size_class, {}).update(knobs)
    p.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return p
