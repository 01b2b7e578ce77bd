"""The port's command line (cli.py), its validator (validate.py) and the
teapot_rocks preset, on the CPU (``--device cpu``), from stand-in meshes
(scene/standins.py) and a small generated terrain (n = 40) in one folder.

The CLI renders frames of the animated scene at 8 x 4 pixels, 1 bounce;
``--resume`` skips the frames it finds; sample ranges add up to the whole
range (rtol 1e-6, tests/test_checkpoint.py's bar) and ``--merge`` makes of
them the BMP that the whole range renders; the metrics lines carry the
load, every frame and the kernel launches (none on the CPU). teapot_rocks'
tables are byte-equal to the JAX package's on the same files. No JAX
render runs."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pathtracing_tpu import models as jmodels
from pathtracing_tpu_torch import cli, models as tmodels
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.io.bmp import read_bmp, write_bmp
from pathtracing_tpu_torch.render import render_frame
from pathtracing_tpu_torch.scene import assets
from pathtracing_tpu_torch.scene.standins import write_standins
from pathtracing_tpu_torch.testing import assert_same_tables, golden
from pathtracing_tpu_torch.validate import downscale_local_mean, main as validate_main

W, H, BOUNCES = 8, 4, 1
SMALL = ["--device", "cpu", "--width", str(W), "--height", str(H),
         "--max-bounces", str(BOUNCES)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("standins")
    write_standins(d)
    assets.write_terrain_obj(str(d / "terrain.obj"), n=40)
    return str(d)


def run(data_dir, out, *args):
    return cli.main(SMALL + ["--data-dir", data_dir, "--out", str(out), *args])


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    """frames 1000-1001 at 2 spp with metrics, then a resume to 1003;
    samples [0, 1), [1, 2) and [0, 2) of frame 1000, each in a folder."""
    base = tmp_path_factory.mktemp("cli")
    frames = base / "frames"
    run(data_dir, frames, "--spp", "2", "--frames", "1000", "1002",
        "--metrics", str(base / "m.jsonl"))
    first = {f: os.stat(frames / f).st_mtime_ns for f in os.listdir(frames)}
    run(data_dir, frames, "--spp", "2", "--frames", "1000", "1003", "--resume",
        "--metrics", str(base / "m.jsonl"))
    for a, b in ((0, 1), (1, 2), (0, 2)):
        run(data_dir, base / f"r{a}{b}", "--spp", "2", "--frames", "1000", "1001",
            "--sample-range", str(a), str(b))
    return base, first


def test_frames_and_resume(runs, data_dir):
    base, first = runs
    frames = base / "frames"
    assert sorted(first) == ["frame_1000.bmp", "frame_1001.bmp"]
    assert sorted(os.listdir(frames)) == ["frame_1000.bmp", "frame_1001.bmp",
                                          "frame_1002.bmp"]
    for f, t in first.items():  # --resume left them alone
        assert os.stat(frames / f).st_mtime_ns == t
    # the CLI's frame is the library's: the preset at that frame, rendered
    cfg = dataclasses.replace(TESTING, image_width=W, image_height=H, max_bounces=BOUNCES,
                              samples_per_pixel=2)
    _, dev = tmodels.build("full_animation", cfg, frame=1000, data_dir=data_dir,
                           device="cpu")
    _, image = render_frame(cfg, dev, device="cpu")
    got = read_bmp(str(frames / "frame_1000.bmp"))
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, image[..., [2, 1, 0]])


def test_metrics_lines(runs):
    base, _ = runs
    lines = [json.loads(x) for x in (base / "m.jsonl").read_text().splitlines()]
    assert [x["kind"] for x in lines] == ["load", "frame", "frame", "load", "frame"]
    assert [x["frame"] for x in lines if x["kind"] == "frame"] == [1000, 1001, 1002]
    zero = {"ray_query": 0, "wide_ray_query": 0, "megakernel": 0, "wavefront": 0}
    for x in lines:
        assert x["launches"] == zero  # the CPU runs the kernels' plain versions
        if x["kind"] == "frame":
            assert x["render_ms"] > 0 and x["setup_ms"] > 0
            assert x["table_bytes"]["nl8"] > 0 and "wide_rows" not in x["table_bytes"]
            assert x["mrays_per_s_upper"] >= x["msamples_per_s"] >= 0
        else:
            assert x["device"] == "cpu" and x["wide"] is False and x["load_ms"] > 0


def test_sample_ranges_are_additive_and_merge(runs):
    base, _ = runs
    part = lambda a, b: np.load(base / f"r{a}{b}" / f"frame_1000.part_{a}_{b}.npz")["sums"]
    p0, p1, full = part(0, 1), part(1, 2), part(0, 2)
    assert full.shape == (H, W, 3)
    np.testing.assert_allclose(p0 + p1, full, rtol=1e-6, atol=1e-7)
    assert (np.abs(p1 - p0) > 0).any()  # different samples, different noise
    merged = base / "merged"
    merged.mkdir()
    for a, b in ((0, 1), (1, 2)):
        os.link(base / f"r{a}{b}" / f"frame_1000.part_{a}_{b}.npz",
                merged / f"frame_1000.part_{a}_{b}.npz")
    assert cli.main(["--merge", "--out", str(merged), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(read_bmp(str(merged / "frame_1000.bmp")),
                                  read_bmp(str(base / "frames" / "frame_1000.bmp")))


def test_cli_merge_roundtrip(tmp_path):
    """tests/test_checkpoint.py's round trip: two partials of random sums."""
    rng = np.random.default_rng(0)
    sums_a = rng.random((4, 6, 3), np.float32)
    sums_b = rng.random((4, 6, 3), np.float32)
    np.savez_compressed(tmp_path / "frame_0000.part_0_2.npz", sums=sums_a, sample_range=(0, 2))
    np.savez_compressed(tmp_path / "frame_0000.part_2_4.npz", sums=sums_b, sample_range=(2, 4))
    assert cli.merge_partials(argparse.Namespace(out=str(tmp_path), device="cpu")) == 0
    assert read_bmp(str(tmp_path / "frame_0000.bmp")).shape == (4, 6, 3)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.merge_partials(argparse.Namespace(out=str(empty), device="cpu")) == 1


def test_device_rule_and_later_slices(data_dir, tmp_path):
    if not torch.cuda.is_available():
        # no fallback: without --device cpu and without a card it raises
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--data-dir", data_dir, "--out", str(tmp_path)])
    # --adaptive is refused with a sample range or --shard, and outside
    # [1, spp] (an argparse error, before anything renders)
    for bad in (["--adaptive", "4", "--sample-range", "0", "2"],
                ["--adaptive", "4", "--shard"],
                ["--adaptive", "9", "--spp", "8"], ["--adaptive", "0"]):
        with pytest.raises(SystemExit):
            run(data_dir, tmp_path, *bad)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("wavefront", [False, True], ids=["scan", "wavefront"])
def test_shard_matches_unsharded(runs, data_dir, tmp_path, wavefront):
    """--shard renders each frame through parallel/sharding.
    render_frame_sharded over the CPU's one-device mesh: the BMP the
    unsharded frame gives, byte for byte."""
    base, _ = runs
    extra = ["--wavefront"] if wavefront else []
    run(data_dir, tmp_path, "--spp", "2", "--frames", "1000", "1001", "--shard", *extra)
    got = (tmp_path / "frame_1000.bmp").read_bytes()
    if wavefront:
        (tmp_path / "wf").mkdir()
        run(data_dir, tmp_path / "wf", "--spp", "2", "--frames", "1000", "1001", *extra)
        assert got == (tmp_path / "wf" / "frame_1000.bmp").read_bytes()
    else:
        assert got == (base / "frames" / "frame_1000.bmp").read_bytes()


@pytest.mark.parametrize("wide", [False, True], ids=["binary", "w8"])
def test_teapot_rocks_matches_jax(data_dir, tmp_path, wide):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    cfg = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=1)
    ts, tdev = tmodels.build("teapot_rocks", cfg, data_dir=data_dir,
                             asset_dir=str(tmp_path / "t"), wide=wide, device="cpu")
    js, jdev = jmodels.build("teapot_rocks", cfg, data_dir=data_dir,
                             asset_dir=str(tmp_path / "j"), wide=wide)
    assert_same_tables(tdev, jdev)
    assert len(ts.instances) == len(js.instances) == 7


def _write_pair(tmp_path, own_img, ref_img):
    from PIL import Image

    (tmp_path / "ref").mkdir(exist_ok=True)
    (tmp_path / "own").mkdir(exist_ok=True)
    Image.fromarray(ref_img).save(tmp_path / "ref" / "0000.png")
    bgra = np.dstack([own_img[..., 2], own_img[..., 1], own_img[..., 0],
                      np.full(own_img.shape[:2], 255, np.uint8)])
    write_bmp(str(tmp_path / "own" / "frame_0000.bmp"), bgra)


def test_validator_pass_fail_and_missing(tmp_path, monkeypatch):
    """tests/test_validator.py's cases on the port's validator: a frame
    matching its reference passes, a corrupted one fails, a missing one
    fails."""
    own = golden("render8.gold")["image_bgra"][..., [2, 1, 0]]  # RGB
    ref = downscale_local_mean(own, 2).astype(np.uint8)
    args = [str(tmp_path / "ref"), str(tmp_path / "own"), "--frames", "1"]
    monkeypatch.chdir(tmp_path)
    _write_pair(tmp_path, own, ref)
    assert validate_main(args) == 0
    assert "successful" in (tmp_path / "validation_result.txt").read_text()
    corrupted = own.copy()
    corrupted[: own.shape[0] // 2] = 0
    _write_pair(tmp_path, corrupted, ref)
    assert validate_main(args) == 1
    assert "BROKEN" in (tmp_path / "validation_result.txt").read_text()
    os.remove(tmp_path / "own" / "frame_0000.bmp")
    assert validate_main(args) == 1
    assert "missing image" in (tmp_path / "validation_result.txt").read_text()


def test_cornell_box_adaptive_and_aovs(tmp_path):
    """--model cornell_box renders with its default area lights; --adaptive
    and --aovs write what the JAX CLI writes (frame_NNNN.bmp, and
    frame_NNNN.aovs.npz with albedo / normal (H, W, 3), depth / coverage
    (H, W)), equal to the port's library calls on the same scene."""
    from pathtracing_tpu_torch.adaptive import render_adaptive
    from pathtracing_tpu_torch.aov import render_aovs
    from pathtracing_tpu_torch.render import to_bgra

    w, h = 12, 8
    base = ["--device", "cpu", "--model", "cornell_box", "--width", str(w),
            "--height", str(h), "--max-bounces", "2"]
    cli.main(base + ["--spp", "2", "--out", str(tmp_path / "plain")])
    plain = read_bmp(str(tmp_path / "plain" / "frame_0000.bmp"))
    assert plain.shape == (h, w, 3) and plain.max() > 0
    out = tmp_path / "adaptive"
    cli.main(base + ["--spp", "4", "--adaptive", "2", "--aovs", "--out", str(out),
                     "--metrics", str(tmp_path / "m.jsonl")])
    assert sorted(os.listdir(out)) == ["frame_0000.aovs.npz", "frame_0000.bmp"]
    cfg = dataclasses.replace(TESTING, image_width=w, image_height=h, max_bounces=2,
                              samples_per_pixel=4)
    _, dev = tmodels.build("cornell_box", cfg, device="cpu")
    idx = np.arange(w * h, dtype=np.int32)
    colors, counts = render_adaptive(cfg, dev, idx % w, idx // w, 2, 4, device="cpu")
    assert counts.min() >= 2 and counts.sum() <= 4 * w * h
    bgra = to_bgra(colors.reshape(h, w, 3), device="cpu")
    assert (read_bmp(str(out / "frame_0000.bmp")) == bgra[..., 2::-1]).all()
    aovs = np.load(out / "frame_0000.aovs.npz")
    ref = render_aovs(cfg, dev, idx % w, idx // w, spp=4, device="cpu")
    assert sorted(aovs.files) == ["albedo", "coverage", "depth", "normal"]
    for k, v in ref.items():
        assert aovs[k].shape == ((h, w, 3) if v.ndim == 2 else (h, w))
        assert aovs[k].tobytes() == v.reshape(aovs[k].shape).tobytes(), k
    line = [json.loads(x) for x in open(tmp_path / "m.jsonl")][-1]
    assert {"pass1_ms", "pass2_ms", "aov_ms"} <= set(line)
