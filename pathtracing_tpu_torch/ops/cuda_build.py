"""Build and load the hand-written CUDA kernels: one ``KernelLibrary`` each.

A kernel's source (``csrc/*.cu``) is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers: seconds, not minutes). It is built at first use into
``build/torch_kernels/`` at the root of the checkout, under a name keyed by a
hash of the source, of every header it includes and of the flags, so a stale
library is never loaded after an edit to any of them. A build or load failure
propagates: nothing here gives way to another path.
"""

from __future__ import annotations

import os
import pathlib
import re
import shutil
import time

from pathtracing_tpu_torch.utils.shared_lib import bind, compile_into, hashed_path

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# Parity flags: no FMA contraction (the oracle goldens were made without it,
# and contraction in the triangle test flips equal-t ties between coincident
# triangles), IEEE division and square root, denormals kept (link words in
# the tables are bit patterns, small ones subnormal). No fast-math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false", "--prec-div=true", "--prec-sqrt=true", "--ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills per kernel, into the build log
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
            if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
                return os.path.join(root, "bin", "nvcc")
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return nvcc


def build_command(nvcc: str, source, out, defines=()) -> list[str]:
    """The one compiler call that builds a kernel's shared library. Headers
    lie beside the source, so no include path is given; ``defines`` are -D
    flags that select what a source instantiates."""
    return [nvcc, *NVCC_FLAGS, *defines, "-o", str(out), str(source)]


class KernelLibrary:
    """One CUDA source, the headers it includes, and its C symbols.

    ``symbols``: ``{name: (argtypes, restype)}`` — declared on the loaded
    library, or ctypes would pass a pointer as a 32-bit int. ``defines``:
    -D flags for this library (one source can build two libraries, e.g. the
    path kernels' sun-only and area-light instances, compiled side by side),
    with ``name`` telling them apart (default: the source's stem).
    """

    def __init__(self, source, headers=(), symbols=None, defines=(), name=None):
        self.source = pathlib.Path(source)
        self.headers = tuple(pathlib.Path(h) for h in headers)
        self.symbols = dict(symbols or {})
        self.defines = tuple(defines)
        self._name = name
        self.build_seconds: float | None = None  # set when this process built it
        self._lib = None

    @property
    def name(self) -> str:
        return self._name or self.source.stem

    def path(self) -> pathlib.Path:
        return hashed_path(BUILD_DIR, self.name, (self.source, *self.headers),
                           NVCC_FLAGS + self.defines)

    @property
    def build_log(self) -> pathlib.Path:
        return self.path().with_suffix(".log")

    def build(self) -> pathlib.Path:
        """Build the library if its hash-named file is missing; returns its
        path. The compiler's output, ptxas' register/spill report included,
        goes to the build log (``<library>.log`` beside the library)."""
        out = self.path()
        if out.exists():
            return out
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        proc = compile_into(out, lambda tmp: build_command(nvcc, self.source, tmp,
                                                           self.defines))
        self.build_seconds = time.perf_counter() - t0
        self.build_log.write_text(" ".join(proc.args) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        return out

    def load(self):
        if self._lib is None:
            self._lib = bind(self.build(), self.symbols)
        return self._lib

    def resources(self) -> list[dict]:
        """ptxas' report per kernel from the build log: registers, spill
        bytes, shared memory."""
        log = self.build_log.read_text()
        out = []
        for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?",
            log, re.S,
        ):
            out.append({
                "entry": m.group(1), "registers": int(m.group(4)),
                "spill_store_bytes": int(m.group(2)),
                "spill_load_bytes": int(m.group(3)),
                "smem_bytes": int(m.group(5) or 0),
            })
        return out


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of this dtype, shape and
    device (``shape=None``: any)."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
