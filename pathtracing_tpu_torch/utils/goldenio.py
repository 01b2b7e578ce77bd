"""Reader for the oracle harness's "GOLD" container format.

See tools/oracle/harness.cc for the writer. Each file is a sequence of named
arrays: [u32 name_len][name][char dtype f|u|i][u32 itemsize][u32 ndim]
[u64 dims...][raw little-endian data].
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {
    (b"f", 4): np.float32,
    (b"u", 4): np.uint32,
    (b"u", 1): np.uint8,
    (b"i", 4): np.int32,
}


def load_golden(path: str) -> dict[str, np.ndarray]:
    arrays: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"GOLD":
            raise ValueError(f"{path}: bad magic {magic!r}")
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (name_len,) = struct.unpack("<I", head)
            name = f.read(name_len).decode()
            dtype_c = f.read(1)
            (itemsize,) = struct.unpack("<I", f.read(4))
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            dtype = _DTYPES[(dtype_c, itemsize)]
            count = int(np.prod(dims)) if ndim else 1
            data = np.fromfile(f, dtype=dtype, count=count)
            arrays[name] = data.reshape(dims)
    return arrays
