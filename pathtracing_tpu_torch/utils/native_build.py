"""Build and load the port's host C++ libraries (the OBJ loader and the two
BVH builders), and count which builder served each call.

Each source (``io/native/obj_loader.cc``, ``accel/native/bvh_builder.cc``,
``accel/native/wide_builder.cc``) is compiled with ``g++`` at first use into
``build/torch_native/`` at the root of the checkout, under a name keyed by a
hash of the source and the flags, and loaded with ``ctypes``, by the steps
of ``utils/shared_lib`` that the CUDA kernels' libraries take too. The
directory is the port's own: the JAX package keeps its libraries elsewhere,
keyed by modification time against its own sources, so neither package can
load the other's library. Where ``g++`` is missing or fails, ``load``
returns None and the caller takes the Python builder, which gives the same
bytes.
"""

from __future__ import annotations

import collections
import pathlib
import threading

from pathtracing_tpu_torch.utils.shared_lib import bind, compile_into, hashed_path

_PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "torch_native"

# No FMA contraction: bit parity with the IEEE oracle and the Python builders.
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

# Calls served per builder: "obj_native" / "obj_python" (one mesh each),
# "bvh_native" / "bvh_python" (one binary BVH each), "wide_native" /
# "wide_python" (one BLAS region or frame tail each).
builds: collections.Counter = collections.Counter()


def reset_builds() -> None:
    builds.clear()


class HostLibrary:
    """One C++ source and the ``ctypes`` signatures of its C symbols
    (``{name: (argtypes, restype)}``)."""

    def __init__(self, source, symbols):
        self.source = pathlib.Path(source)
        self.symbols = dict(symbols)
        self._lock = threading.Lock()
        self._tried = False
        self._lib = None

    def path(self) -> pathlib.Path:
        return hashed_path(BUILD_DIR, f"lib{self.source.stem}", (self.source,), GXX_FLAGS)

    def build(self) -> pathlib.Path | None:
        """The library's path, built if its hash-named file is missing;
        None when ``g++`` is missing or fails."""
        out = self.path()
        if out.exists():
            return out
        try:
            proc = compile_into(out, lambda tmp: ["g++", *GXX_FLAGS, str(self.source),
                                                  "-o", str(tmp)])
        except FileNotFoundError:
            return None
        return out if proc.returncode == 0 else None

    def load(self):
        """The loaded library, or None when it cannot be built."""
        with self._lock:
            if not self._tried:
                self._tried = True
                so = self.build()
                self._lib = None if so is None else bind(so, self.symbols)
            return self._lib
