"""The port's policies: no JAX at run time, no silent CPU fallback, the
kernel's build flags, and NotImplementedError for what later slices bring."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pathtracing_tpu_torch
from pathtracing_tpu_torch import render as trender
from pathtracing_tpu_torch.config import TESTING
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.scene import golden as tgolden
from pathtracing_tpu_torch.testing import golden

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dataclasses.replace(TESTING, image_width=16, image_height=9, samples_per_pixel=1)


def _port_modules():
    pkg = ROOT / "pathtracing_tpu_torch"
    mods = []
    for p in sorted(pkg.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_imports_load_neither_jax_nor_the_jax_package():
    mods = _port_modules() + ["chip_smoke"]
    assert len(mods) > 20
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'pathtracing_tpu' or m.startswith('pathtracing_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_import():
    for p in [*(ROOT / "pathtracing_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "jax" not in s.split() and " jax." not in s, (p, line)
                assert "pathtracing_tpu." not in s and not s.endswith("pathtracing_tpu"), (p, line)


def test_device_none_means_cuda_and_raises_without_one():
    """Runs where there is no card: ``device=None`` must raise, not drop to
    the CPU; ``device='cpu'`` works."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None would render on it")
    g = golden("scene.gold")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgolden.scene_device_from_golden(g, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgolden.scene_device_from_motion_golden(golden("motion.gold"))
    scene = tgolden.scene_device_from_golden(g, CFG, device="cpu")
    idx = np.arange(16 * 9, dtype=np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render_frame(CFG, scene)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render_pixels(CFG, scene, idx % 16, idx // 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render_frame(CFG, scene, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pathtracing_tpu_torch.resolve_device(None)
    colors, image = trender.render_frame(CFG, scene, device="cpu")
    assert colors.shape == (9, 16, 3) and image.shape == (9, 16, 4)
    assert np.isfinite(colors).all()


def test_kernel_wrapper_refuses_cpu_tensors_and_has_no_fallback():
    from pathtracing_tpu_torch.testing import vec3_t

    g, rg = golden("scene.gold"), golden("rays.gold")
    scene = tgolden.scene_device_from_golden(g, CFG, device="cpu")
    z = torch.zeros(8, dtype=torch.int32)
    before = CT.launches
    with pytest.raises(ValueError, match="CUDA"):
        CT.ray_query_cuda(
            scene, z, z, vec3_t(rg["origins"][:8]), vec3_t(rg["dirs"][:8]),
            0.0, 1e9, torch.ones(8, dtype=torch.bool),
        )
    assert CT.launches == before  # counted only where the kernel is launched
    src = (ROOT / "pathtracing_tpu_torch" / "ops" / "cuda_traversal.py").read_text()
    assert "except" not in src and "ray_query_plain" not in src
    assert CT.table_bytes(scene) == sum(
        x.numel() * 4 for x in (scene.nl8, scene.tri_pos, scene.inst_f, scene.inst_u)
    )


def test_build_command_flags():
    cmd = CT.build_command("nvcc", CT.SOURCE, "out.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(CT.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd and "-shared" in cmd and "-std=c++17" in cmd
    joined = " ".join(cmd)
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "ftz=true" not in joined and "prec-div=false" not in joined
    assert "-I" not in joined  # plain C interface: no PyTorch headers
    assert CT.SOURCE.exists() and "torch/extension.h" not in CT.SOURCE.read_text()
    # built into a git-ignored directory of the checkout, keyed by a hash
    lib = CT._library_path()
    assert lib.parent == ROOT / "build" / "torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert len(lib.stem.split("_")[-1]) == 16


@pytest.mark.parametrize("kw", [{"wavefront": True}, {"megakernel": True}])
def test_later_renderers_raise(kw):
    scene = tgolden.scene_device_from_golden(golden("scene.gold"), CFG, device="cpu")
    idx = np.arange(16 * 9, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="later slice"):
        trender.render_pixels(CFG, scene, idx % 16, idx // 16, device="cpu", **kw)


def test_scene_on_another_device_is_refused():
    scene = tgolden.scene_device_from_golden(golden("scene.gold"), CFG, device="cpu")
    meta = scene._replace(nl8=scene.nl8.to("meta"))
    idx = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="scene is on"):
        trender.render_pixels(CFG, meta, idx, idx, device="cpu")


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""  # no result line
