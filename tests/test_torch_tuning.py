"""The port's tuning table (``pathtracing_tpu_torch/tuning.py``): builtin
rows, the tuned file over them, recording, and ``render.default_tile_pixels``
resolved from it by device type and scene size. Mirrors tests/test_tuning.py
on the port; every test sets its own ``PT_TUNED_FILE`` (monkeypatch), which
no other test sees. No JAX call."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pathtracing_tpu import tuning as jax_tuning
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch import tuning
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden

SMALL = dataclasses.replace(TESTING, image_width=16, image_height=9, max_bounces=2,
                            samples_per_pixel=1)


@pytest.fixture
def tuned_file(tmp_path, monkeypatch):
    p = tmp_path / "tuned.json"
    monkeypatch.setenv("PT_TUNED_FILE", str(p))
    return p


def test_builtin_rows(tuned_file):
    cpu_small = tuning.get_tuning("cpu", "small")
    assert cpu_small["leaf_every"] == 8
    assert cpu_small["compact_div"] == 4
    assert cpu_small["tile_pixels"] == 1 << 15
    cpu_large = tuning.get_tuning("cpu", "large")
    assert cpu_large["leaf_every"] == 16
    assert cpu_large["compact_div"] == 8
    # unknown platform falls back to cpu rows
    assert tuning.get_tuning("quantum", "large") == cpu_large
    # the card's rows: the tile and the layout; the schedule knobs are the
    # CPU's (no code of the port reads them)
    for size in ("small", "large"):
        cuda = tuning.get_tuning("cuda", size)
        assert cuda["tile_pixels"] == 1 << 21 and cuda["wide_layout"] == "w8"
        sched = lambda row: {k: v for k, v in row.items()
                             if k not in ("tile_pixels", "wide_layout")}
        assert sched(cuda) == sched(tuning.get_tuning("cpu", size))
    # one tuned file serves both packages: the same knobs; no TPU row here
    assert tuning.KNOBS == jax_tuning.KNOBS
    assert tuning.BUILTIN["cpu"] == jax_tuning.BUILTIN["cpu"]
    assert set(tuning.BUILTIN) == {"cpu", "cuda"}
    assert all(set(row) == set(tuning.KNOBS)
               for rows in tuning.BUILTIN.values() for row in rows.values())


def test_record_and_override(tuned_file):
    tuning.record_tuning("cuda", "small", tile_pixels=12345, unroll=True)
    got = tuning.get_tuning("cuda", "small")
    assert got["tile_pixels"] == 12345
    assert got["unroll"] is True
    # untouched knobs keep builtin values
    assert got["compact_div"] == tuning.BUILTIN["cuda"]["small"]["compact_div"]
    # other rows unaffected
    assert tuning.get_tuning("cuda", "large") == tuning.BUILTIN["cuda"]["large"]
    assert tuning.get_tuning("cpu", "small") == tuning.BUILTIN["cpu"]["small"]

    # read-modify-write preserves earlier entries
    tuning.record_tuning("cuda", "large", mid_entry=True)
    data = json.loads(tuned_file.read_text())
    assert data["cuda"]["small"]["tile_pixels"] == 12345
    assert data["cuda"]["large"]["mid_entry"] is True
    assert tuning.get_tuning("cuda", "small")["tile_pixels"] == 12345


def test_reject_unknown_knob(tuned_file):
    with pytest.raises(ValueError):
        tuning.record_tuning("cuda", "small", warp_factor=9)
    assert not tuned_file.exists()


def test_corrupt_file_falls_back(tuned_file):
    tuned_file.write_text("{not json")
    assert tuning.get_tuning("cpu", "small") == tuning.BUILTIN["cpu"]["small"]
    assert tuning.get_tuning("cuda", "large") == tuning.BUILTIN["cuda"]["large"]


class _Nodes:
    """A scene stand-in: given the device type, default_tile_pixels reads
    only nl8's rows."""

    def __init__(self, nodes):
        self.nl8 = torch.empty((8 * nodes, 8), device="meta")


@pytest.mark.parametrize("kind", ["cpu", "cuda"])
@pytest.mark.parametrize("size", ["small", "large"])
def test_default_tile_pixels_from_table(tuned_file, kind, size):
    nodes = trender.LARGE_SCENE_NODES + (1 if size == "large" else 0)
    scene = _Nodes(nodes)
    want = tuning.BUILTIN[kind][size]["tile_pixels"]
    assert trender.default_tile_pixels(scene, kind) == want
    # the tuned file's row for the pair, and only for it
    tuning.record_tuning(kind, size, tile_pixels=777)
    assert trender.default_tile_pixels(scene, kind) == 777
    other = "large" if size == "small" else "small"
    assert tuning.get_tuning(kind, other)["tile_pixels"] == tuning.BUILTIN[kind][other][
        "tile_pixels"]


def test_tuned_tile_changes_launches_not_colours(tuned_file, monkeypatch):
    """A tiny scan frame under a tuned file whose cpu row halves the tile
    (to half the frame): twice the tiles, and the colours bit-equal."""
    scene = scene_device_from_golden(golden("scene.gold"), SMALL, device="cpu")
    n = SMALL.image_width * SMALL.image_height
    idx = np.arange(n, dtype=np.int32)
    tiles = []
    render_tile = trender._render_tile

    def spy(config, sc, xs, ys, spp, sample_base=0):
        tiles.append(len(xs))
        return render_tile(config, sc, xs, ys, spp, sample_base)

    monkeypatch.setattr(trender, "_render_tile", spy)
    frame = lambda: trender.render_pixels(SMALL, scene, idx % 16, idx // 16, spp=1,
                                          device="cpu")
    tuning.record_tuning("cpu", "small", tile_pixels=n)
    whole = frame()
    assert tiles == [n]
    tuning.record_tuning("cpu", "small", tile_pixels=n // 2)
    tiles.clear()
    halves = frame()
    assert tiles == [n // 2, n - n // 2]
    assert halves.tobytes() == whole.tobytes() and whole.mean() > 0
