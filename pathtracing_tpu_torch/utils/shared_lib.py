"""The steps that build and bind the port's compiled libraries, shared by
the CUDA kernels (``ops/cuda_build``) and the host C++ (``utils/native_build``).

A library's file is named by a hash of its sources and flags, so a stale
one is never loaded after an edit; it is compiled to a temporary name and
moved into place with ``os.replace``, so processes building at the same
time never load half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading


def hashed_path(build_dir, stem: str, files, flags) -> pathlib.Path:
    """``<build_dir>/<stem>_<16 hex digits>.so``, keyed by the bytes of
    ``files`` and the ``flags``."""
    h = hashlib.sha256()
    for f in files:
        h.update(pathlib.Path(f).read_bytes())
    h.update(" ".join(flags).encode())
    return pathlib.Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def compile_into(out: pathlib.Path, command) -> subprocess.CompletedProcess:
    """Runs ``command(tmp)`` (the compiler's argv, writing ``tmp``) and moves
    ``tmp`` to ``out`` when it succeeds. Raises FileNotFoundError when the
    compiler is missing."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(command(tmp), capture_output=True, text=True)
    if proc.returncode == 0:
        os.replace(tmp, out)
    else:
        tmp.unlink(missing_ok=True)
    return proc


def bind(path, symbols):
    """The library at ``path`` loaded with ``ctypes``, each of ``symbols``
    (``{name: (argtypes, restype)}``) declared, or ctypes would pass a
    pointer as a 32-bit int."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
