"""BMP writer, byte-compatible with the reference (reference: bmp.cc:7-63):
24bpp uncompressed, bottom-up rows, BGR channel order, 4-byte row padding,
hand-written 54-byte header."""

from __future__ import annotations

import struct

import numpy as np


def write_bmp(path: str, image_bgra: np.ndarray) -> None:
    """image_bgra: (H, W, 4) uint8 in BGRA order (tonemap output)."""
    h, w = image_bgra.shape[:2]
    out_pitch = (w * 3 + 3) // 4 * 4
    file_size = 54 + out_pitch * h

    header = bytearray(54)
    header[0:2] = b"BM"
    struct.pack_into("<I", header, 0x02, file_size)
    struct.pack_into("<I", header, 0x0A, 54)
    struct.pack_into("<I", header, 0x0E, 40)
    struct.pack_into("<I", header, 0x12, w)
    struct.pack_into("<I", header, 0x16, h)
    struct.pack_into("<H", header, 0x1A, 1)
    struct.pack_into("<H", header, 0x1C, 24)
    struct.pack_into("<I", header, 0x1E, 0)
    struct.pack_into("<I", header, 0x22, out_pitch * h)
    struct.pack_into("<I", header, 0x26, 2835)
    struct.pack_into("<I", header, 0x2A, 2835)

    rows = np.zeros((h, out_pitch), np.uint8)
    # bottom-up: output row y takes input row h-1-y, channels BGR
    rows[:, : w * 3] = image_bgra[::-1, :, :3].reshape(h, w * 3)

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rows.tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Reads a 24bpp BMP back to (H, W, 3) uint8 RGB (for validation)."""
    with open(path, "rb") as f:
        data = f.read()
    w = struct.unpack_from("<I", data, 0x12)[0]
    h = struct.unpack_from("<I", data, 0x16)[0]
    offset = struct.unpack_from("<I", data, 0x0A)[0]
    pitch = (w * 3 + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, count=pitch * h, offset=offset)
    rows = rows.reshape(h, pitch)[:, : w * 3].reshape(h, w, 3)
    bgr = rows[::-1]
    return bgr[..., ::-1]
