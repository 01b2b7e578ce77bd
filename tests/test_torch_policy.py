"""The port's policies: no JAX at run time, no silent CPU fallback, the
kernels' build flags, what the kernel wrappers refuse, and
NotImplementedError for what later slices bring."""

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
from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops import cuda_denoise as CD
from pathtracing_tpu_torch.ops import cuda_megakernel as CM
from pathtracing_tpu_torch.ops import cuda_traversal as CT
from pathtracing_tpu_torch.ops import cuda_wavefront as CWF
from pathtracing_tpu_torch.ops import cuda_wide_traversal as CW
from pathtracing_tpu_torch.probes import gather_probe as GP
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


def test_port_files_name_no_path_of_the_jax_package():
    """No file of the port (code, comments, CUDA and C++ sources) names a
    path under the JAX package's directory: the port builds, loads and reads
    nothing of it."""
    files = [p for p in (ROOT / "pathtracing_tpu_torch").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    assert len(files) > 40
    for p in files:
        assert "pathtracing_tpu/" not in p.read_text(), p


def test_native_libraries_are_built_apart_from_the_jax_package():
    """The port's host C++ (OBJ loader, BVH and wide builders) are copies of
    the JAX package's sources, built with its flags into the port's own
    ``build/torch_native/``, keyed by a hash of source and flags; never into
    ``build/native/``, where the JAX package keeps its libraries."""
    from pathtracing_tpu_torch.accel import native as tnative
    from pathtracing_tpu_torch.io import native_loader
    from pathtracing_tpu_torch.utils import native_build

    assert native_build.BUILD_DIR == ROOT / "build" / "torch_native"
    assert native_build.GXX_FLAGS == ("-O2", "-std=c++17", "-shared", "-fPIC",
                                      "-ffp-contract=off")
    libs = {"io/native/obj_loader.cc": native_loader.LIBRARY,
            "accel/native/bvh_builder.cc": tnative.BVH_LIBRARY,
            "accel/native/wide_builder.cc": tnative.WIDE_LIBRARY}
    for rel, lib in libs.items():
        assert lib.source == ROOT / "pathtracing_tpu_torch" / rel
        assert lib.source.read_bytes() == (ROOT / "pathtracing_tpu" / rel).read_bytes()
        path = lib.path()
        assert path.parent == native_build.BUILD_DIR
        assert len(path.stem.split("_")[-1]) == 16
        loaded = lib.load()
        assert loaded is not None and pathlib.Path(loaded._name) == path
        assert ROOT / "build" / "native" not in path.parents


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
    cmd = cuda_build.build_command("nvcc", CT.SOURCE, "out.so")
    assert cmd[0] == "nvcc" and cmd[-1] == str(CT.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd and "-shared" in cmd and "-std=c++17" in cmd
    joined = " ".join(cmd)
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "ftz=true" not in joined and "prec-div=false" not in joined
    assert "-I" not in joined  # plain C interface: no PyTorch headers
    assert CT.SOURCE.exists() and "torch/extension.h" not in CT.SOURCE.read_text()
    # built into a git-ignored directory of the checkout, keyed by a hash
    lib = CT.LIBRARY.path()
    assert lib.parent == ROOT / "build" / "torch_kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert len(lib.stem.split("_")[-1]) == 16


@pytest.mark.parametrize(
    "library", [CT.LIBRARY, CW.LIBRARY, GP.LIBRARY, CM.LIBRARY, CWF.LIBRARY,
                CM.LIT_LIBRARY, CWF.LIT_LIBRARY, CD.LIBRARY],
    ids=lambda lib: lib.name
)
def test_kernel_library_sources_and_hash(library, tmp_path):
    """Every kernel is a CUDA source of the package with a plain C interface;
    its library's name is keyed by the source, every header it includes and
    the flags (a library's -D flags too: the path kernels' area-light
    instances build from the same sources into libraries of their own), so
    an edit to a shared header never loads a stale library."""
    src = library.source.read_text()
    assert library.source.parent == ROOT / "pathtracing_tpu_torch" / "csrc"
    assert "torch/extension.h" not in src and "__global__" in src
    for name in library.symbols:
        assert f"{name}(" in src
    included = {
        line.split('"')[1] for line in src.splitlines()
        if line.startswith("#include \"")
    }
    assert included == {h.name for h in library.headers}
    assert library.path().name.startswith(library.name + "_")
    # the hash moves with the header's bytes
    for h in library.headers:
        copy_src = tmp_path / library.source.name
        copy_hdr = tmp_path / h.name
        copy_src.write_bytes(library.source.read_bytes())
        copy_hdr.write_bytes(h.read_bytes() + b"\n// edited\n")
        kw = dict(defines=library.defines, name=library.name)
        edited = cuda_build.KernelLibrary(copy_src, headers=(copy_hdr,), **kw)
        same = cuda_build.KernelLibrary(library.source, headers=library.headers, **kw)
        assert same.path() == library.path() != edited.path()
    if library.defines:  # the same source without them is another library
        plain = cuda_build.KernelLibrary(library.source, headers=library.headers,
                                         name=library.name)
        assert plain.path() != library.path()
        assert cuda_build.build_command("nvcc", library.source, "o.so", library.defines)[
            -4:-3] == list(library.defines[-1:])


def test_both_ray_query_kernels_share_the_header():
    assert CT.HEADER == CW.HEADER and CT.HEADER in CT.LIBRARY.headers
    assert CW.HEADER in CW.LIBRARY.headers and GP.LIBRARY.headers == ()


def _wide_args(n=8, device="cpu"):
    from pathtracing_tpu_torch.testing import vec3_t

    g, rg = golden("scene.gold"), golden("rays.gold")
    scene = tgolden.scene_device_from_golden(g, CFG, wide=True, device=device)
    z = torch.zeros(n, dtype=torch.int32)
    return scene, (
        z, z, vec3_t(rg["origins"][:n]), vec3_t(rg["dirs"][:n]),
        0.0, 1e9, torch.ones(n, dtype=torch.bool),
    )


def test_wide_kernel_wrapper_refuses_cpu_tensors_and_has_no_fallback():
    scene, args = _wide_args()
    before = CW.launches
    with pytest.raises(ValueError, match="CUDA"):
        CW.wide_ray_query_cuda(scene, *args)
    assert CW.launches == before  # counted only where the kernel is launched
    src = (ROOT / "pathtracing_tpu_torch" / "ops" / "cuda_wide_traversal.py").read_text()
    assert "except" not in src and "wide_ray_query_plain" not in src
    assert CW.table_bytes(scene) == sum(
        x.numel() * 4 for x in (scene.wide_rows, scene.wide_root, scene.tri_pos,
                                scene.inst_f, scene.inst_u)
    )


def test_wide_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper's table checks (``check_scene``) run before anything is
    built or launched; here on CPU tensors, with the CPU as the device asked
    for."""
    from pathtracing_tpu_torch.ops.wide_traversal import wide_ray_query_plain

    scene, args = _wide_args()
    cpu = torch.device("cpu")
    assert CW.check_scene(scene, cpu).w_row == 48
    # a row width no shipped layout has: refused by the wrapper's check and
    # by the plain walk alike
    bad = scene._replace(wide_rows=scene.wide_rows[:, :44].contiguous())
    with pytest.raises(ValueError, match="44 columns"):
        CW.check_scene(bad, cpu)
    with pytest.raises(ValueError, match="44 columns"):
        wide_ray_query_plain(bad, *args)
    # a table that starts 4 bytes past a 16-byte boundary
    flat = torch.zeros(scene.wide_rows.numel() + 1, dtype=torch.float32)
    shifted = flat[1:].view(scene.wide_rows.shape)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        CW.check_scene(scene._replace(wide_rows=shifted), cpu)
    # a strided view, a float root table, a scene without wide tables, a
    # table on another device
    with pytest.raises(ValueError, match="not contiguous"):
        CW.check_scene(
            scene._replace(wide_rows=scene.wide_rows.repeat(1, 2)[:, :48]), cpu
        )
    with pytest.raises(TypeError, match="dtype"):
        CW.check_scene(scene._replace(wide_root=scene.wide_root.float()), cpu)
    with pytest.raises(ValueError, match="wide=True"):
        CW.check_scene(scene._replace(wide_rows=None), cpu)
    with pytest.raises(ValueError, match="expected"):
        CW.check_scene(scene._replace(wide_root=scene.wide_root.to("meta")), cpu)


def test_gather_wrapper_refusals():
    table = torch.zeros((16, 8), dtype=torch.float32)
    idx = torch.zeros(4, dtype=torch.int32)
    before = GP.launches
    with pytest.raises(ValueError, match="CUDA"):
        GP.gather_rows_cuda(table, idx)
    with pytest.raises(ValueError, match="CUDA"):
        GP.bucket_order_cuda(table, idx)
    # CPU tensors take the plain version through the dispatcher only
    assert torch.equal(GP.gather_rows(table, idx), table[idx.long()])
    assert GP.launches == before
    src = (ROOT / "pathtracing_tpu_torch" / "probes" / "gather_probe.py").read_text()
    assert "except" not in src
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GP.main([])
    cpu = torch.device("cpu")
    assert GP.check_args(table, idx, 16, cpu) == 16
    for width in (6, 0):
        with pytest.raises(ValueError, match="multiple of 4 floats"):
            GP.check_args(torch.zeros((16, width)), idx, 16, cpu)
    with pytest.raises(ValueError, match="no rows"):
        GP.check_args(torch.zeros((0, 8)), idx, 16, cpu)
    flat = torch.zeros(16 * 8 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        GP.check_args(flat[1:].view(16, 8), idx, 16, cpu)
    for k in (0, 33):
        with pytest.raises(ValueError, match="copies in flight"):
            GP.check_args(table, idx, k, cpu)
    # the ring: WARPS_PER_BLOCK x k rows, up to the block's shared memory
    row_fits = GP.MAX_SHARED_BYTES // (GP.WARPS_PER_BLOCK * GP.MAX_IN_FLIGHT * 16) * 4
    assert GP.check_args(torch.zeros((4, row_fits)), idx, 32, cpu) == 32
    with pytest.raises(ValueError, match="shared memory"):
        GP.check_args(torch.zeros((4, row_fits + 4)), idx, 32, cpu)
    with pytest.raises(ValueError, match="shared memory"):
        GP.check_args(torch.zeros((4, 1024)), idx, 32, cpu)
    with pytest.raises(TypeError, match="dtype"):
        GP.check_args(table, idx.long(), 16, cpu)


@pytest.mark.parametrize("kw", [{"wavefront": True}, {"megakernel": True}])
def test_later_renderers_raise(kw):
    """The wavefront renderer and the megakernel are in. The tables of
    once later slices render through them: bf16 node rows (S2) on the binary
    walk as the nl8 rows render, area-light tables through both as the
    scan renders them."""
    from pathtracing_tpu_torch import models
    from pathtracing_tpu_torch.scene.device import with_bf16_nodes

    wide = "megakernel" in kw
    scene = tgolden.scene_device_from_golden(golden("scene.gold"), CFG, wide=wide,
                                             device="cpu")
    idx = np.arange(16 * 9, dtype=np.int32)
    if not wide:
        got = trender.render_pixels(CFG, with_bf16_nodes(scene), idx % 16, idx // 16,
                                    device="cpu", **kw)
        ref = trender.render_pixels(CFG, scene, idx % 16, idx // 16, device="cpu", **kw)
        assert got.tobytes() == ref.tobytes() and got.mean() > 0
    _, lit = models.build("cornell_box", CFG, wide=wide, device="cpu")
    got = trender.render_pixels(CFG, lit, idx % 16, idx // 16, device="cpu", **kw)
    ref = trender.render_pixels(CFG, lit, idx % 16, idx // 16, megakernel=False,
                                device="cpu")
    assert got.tobytes() == ref.tobytes() and got.mean() > 0


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
