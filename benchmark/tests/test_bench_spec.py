"""The harness finds a configuration, a mix, a cell and a metric by the
names in BENCHMARK.json: a later one is added as new files and entries,
with no file that is there edited."""

import copy
import json
import shutil
import time

import pytest

from benchmark.harness import spec

# a new per-layer metric, as a later change would add it
NEW_METRIC = '''"""samples_per_request: samples of the window's requests, the mean."""


def read(run):
    return run.samples / len(run.done) if run.done else None
'''


def test_every_cell_of_the_benchmark_is_found():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert spec.find_module("scenes", cell.config["scene"]).Program
        assert spec.find_module("routes", cell.traffic["route"]["entry"]).render
        assert spec.find_module("tables", cell.traffic["route"]["tables"]).options
        assert cell.traffic["samples"]["spp"] >= 1
        assert "far_pct" in cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer, "every cell reports a per-layer metric"
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_a_cell_added_as_files(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = copy.deepcopy(spec.load_json(spec.ROOT / "BENCHMARK.json"))

    # a configuration, a mix, a cell, its limits and a metric: new files ...
    cfg = json.loads((bench_dir / "configs" / "cornell_box.json").read_text())
    cfg["name"] = "cornell_box_720p"
    cfg["render"].update(image_width=1280, image_height=720)
    (bench_dir / "configs" / "cornell_box_720p.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "preview4.json").read_text())
    mix["samples"]["spp"] = 16
    (bench_dir / "traffic" / "preview16.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "cornell_box_720p.preview16.json").write_text(
        (bench_dir / "limits" / "cornell_box.preview4.json").read_text())
    (bench_dir / "metrics" / "samples_per_request.py").write_text(NEW_METRIC)
    # ... and entries
    bench["configs"].append({"name": "cornell_box_720p", "source": "x",
                             "file": "benchmark/configs/cornell_box_720p.json",
                             "reduced": ["image_width", "image_height"], "why": "x"})
    bench["workloads"].append({"name": "cornell_box_720p.preview16",
                               "config": "cornell_box_720p", "traffic": "preview16",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "samples_per_request", "unit": "samples",
                               "better": "higher", "source": "program_counter",
                               "layer": "render entry", "moves": "msamples_per_s",
                               "workloads": ["cornell_box_720p.preview16"]})

    cell = spec.find_cell("cornell_box_720p.preview16", bench, bench_dir)
    assert cell.config["render"]["image_width"] == 1280
    assert cell.traffic["samples"]["spp"] == 16
    assert "samples_per_request" in [m["name"] for m in cell.per_layer]
    read = spec.metric_reader("samples_per_request", bench_dir)

    class R:
        samples, done = 32, [0, 1]

    assert read(R()) == 16
    # the cells that were there are found as before, and no file changed
    old = spec.find_cell("cornell_box.preview4", bench, bench_dir)
    assert "samples_per_request" not in [m["name"] for m in old.per_layer]
    for p, b in before.items():
        assert p.read_bytes() == b, p


# a new scene: the Cornell box with its lamp lowered and widened, read by
# the program's loader and by the reference alike
NEW_SCENE = '''"""The Cornell box with a low, wide lamp."""

import os

from benchmark.harness import inputs


def write_inputs(folder) -> str:
    path = os.path.join(str(folder), "cornell.obj")
    if not os.path.exists(path):
        inputs.write_cornell(folder)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace("0.25", "0.45").replace("1.998", "1.9"))
    return str(folder)


class Program:
    def __init__(self, cfg, tables, data_dir, device, rec):
        from pathtracing_tpu_torch import models

        _, self.static = models.build("cornell_box", cfg, asset_dir=data_dir,
                                      wide=tables.options()["wide"], device=device)

    def prepare(self, req):
        return self.static


def reference(cfg, data_dir, device, lowp=None):
    from benchmark.reference.scene import cornell_box

    return lambda index: cornell_box(os.path.join(data_dir, "cornell.obj"), cfg, device,
                                     lowp=lowp)
'''

# a new route: the pixel list rendered in two halves, one call each
NEW_ROUTE = '''"""render_pixels in two halves of the row-major list, then to_bgra."""

import numpy as np


def render(cfg, tables, req, route, device):
    from pathtracing_tpu_torch.render import render_pixels, to_bgra

    W, H = cfg.image_width, cfg.image_height
    idx = np.arange(W * H, dtype=np.int32)
    parts = [render_pixels(cfg, tables, p % W, p // W, spp=req.spp,
                           sample_base=req.sample_base, average=True, device=device)
             for p in np.array_split(idx, 2)]
    colors = np.concatenate(parts).reshape(H, W, 3)
    return colors, to_bgra(colors, device=device)


def counter(route):
    from pathtracing_tpu_torch.ops import cuda_megakernel

    return cuda_megakernel
'''


def test_a_scene_and_a_route_added_as_files(tmp_path):
    from benchmark.harness import main as M
    from benchmark.tests.conftest import tiny_cell

    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = copy.deepcopy(spec.load_json(spec.ROOT / "BENCHMARK.json"))

    (bench_dir / "scenes" / "low_lamp_box.py").write_text(NEW_SCENE)
    (bench_dir / "routes" / "render_halves.py").write_text(NEW_ROUTE)
    cfg = json.loads((bench_dir / "configs" / "cornell_box.json").read_text())
    cfg.update(name="low_lamp_box", scene="low_lamp_box")
    (bench_dir / "configs" / "low_lamp_box.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "preview4.json").read_text())
    mix.update(name="halves4")
    mix["route"]["entry"] = "render_halves"
    (bench_dir / "traffic" / "halves4.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "low_lamp_box.halves4.json").write_text(
        (bench_dir / "limits" / "cornell_box.preview4.json").read_text())
    bench["configs"].append({"name": "low_lamp_box", "source": "x",
                             "file": "benchmark/configs/low_lamp_box.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "low_lamp_box.halves4", "config": "low_lamp_box",
                               "traffic": "halves4", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornell_box.preview4" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + ["low_lamp_box.halves4"]

    # a whole run of the new cell on the CPU, at a test's size
    cell = spec.find_cell("low_lamp_box.halves4", bench, bench_dir)
    tiny = tiny_cell("cornell_box.preview4", spp=2, pixels=6)
    cell.config["render"].update(tiny.config["render"])
    cell.traffic["samples"].update(tiny.traffic["samples"])
    cell.traffic["check"] = tiny.traffic["check"]
    out = M.run_cell(cell, 2**31 + 3, 0.1, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    obj = (bench_dir / ".cache" / "inputs" / "low_lamp_box" / "cornell.obj").read_text()
    assert "1.9" in obj and "1.998" not in obj  # the new scene's own inputs
    for p, b in before.items():
        assert p.read_bytes() == b, p


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no_such.cell")


@pytest.mark.parametrize("kind", ["scenes", "routes", "tables", "metrics"])
def test_an_unknown_module_is_refused(kind):
    with pytest.raises(ValueError):
        spec.find_module(kind, "no_such_name")
