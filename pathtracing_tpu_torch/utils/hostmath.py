"""Host-side float32 matrix helpers (numpy).

Mirrors the scalar matrix algebra the reference keeps in ``math.hh:151-338``;
matrices are row-major ``np.float32 (N,N)`` arrays.  Only what the packer's
host types need is here (``inverse4`` for ``TlasInstance.create``); the
rest of the JAX package's ``utils/hostmath.py`` comes with the host pipeline.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def inverse4(a: np.ndarray) -> np.ndarray:
    """GLM-derived cofactor inverse in float32 (reference: math.hh:179-221).

    Kept operation-for-operation faithful so instance ``inv_transform``
    matrices match the reference bit-for-bit given identical inputs (the
    hard contract at bvh.hh:69-79).
    """
    r = a.astype(f32)

    c00 = r[2, 2] * r[3, 3] - r[3, 2] * r[2, 3]
    c02 = r[1, 2] * r[3, 3] - r[3, 2] * r[1, 3]
    c03 = r[1, 2] * r[2, 3] - r[2, 2] * r[1, 3]
    c04 = r[2, 1] * r[3, 3] - r[3, 1] * r[2, 3]
    c06 = r[1, 1] * r[3, 3] - r[3, 1] * r[1, 3]
    c07 = r[1, 1] * r[2, 3] - r[2, 1] * r[1, 3]
    c08 = r[2, 1] * r[3, 2] - r[3, 1] * r[2, 2]
    c10 = r[1, 1] * r[3, 2] - r[3, 1] * r[1, 2]
    c11 = r[1, 1] * r[2, 2] - r[2, 1] * r[1, 2]
    c12 = r[2, 0] * r[3, 3] - r[3, 0] * r[2, 3]
    c14 = r[1, 0] * r[3, 3] - r[3, 0] * r[1, 3]
    c15 = r[1, 0] * r[2, 3] - r[2, 0] * r[1, 3]
    c16 = r[2, 0] * r[3, 2] - r[3, 0] * r[2, 2]
    c18 = r[1, 0] * r[3, 2] - r[3, 0] * r[1, 2]
    c19 = r[1, 0] * r[2, 2] - r[2, 0] * r[1, 2]
    c20 = r[2, 0] * r[3, 1] - r[3, 0] * r[2, 1]
    c22 = r[1, 0] * r[3, 1] - r[3, 0] * r[1, 1]
    c23 = r[1, 0] * r[2, 1] - r[2, 0] * r[1, 1]

    f0 = np.array([c00, c00, c02, c03], dtype=f32)
    f1 = np.array([c04, c04, c06, c07], dtype=f32)
    f2 = np.array([c08, c08, c10, c11], dtype=f32)
    f3 = np.array([c12, c12, c14, c15], dtype=f32)
    f4 = np.array([c16, c16, c18, c19], dtype=f32)
    f5 = np.array([c20, c20, c22, c23], dtype=f32)

    v0 = np.array([r[1, 0], r[0, 0], r[0, 0], r[0, 0]], dtype=f32)
    v1 = np.array([r[1, 1], r[0, 1], r[0, 1], r[0, 1]], dtype=f32)
    v2 = np.array([r[1, 2], r[0, 2], r[0, 2], r[0, 2]], dtype=f32)
    v3 = np.array([r[1, 3], r[0, 3], r[0, 3], r[0, 3]], dtype=f32)

    sign_a = np.array([1, -1, 1, -1], dtype=f32)
    sign_b = np.array([-1, 1, -1, 1], dtype=f32)
    inv = np.stack(
        [
            (v1 * f0 - v2 * f1 + v3 * f2) * sign_a,
            (v0 * f0 - v2 * f3 + v3 * f4) * sign_b,
            (v0 * f1 - v1 * f3 + v3 * f5) * sign_a,
            (v0 * f2 - v1 * f4 + v2 * f5) * sign_b,
        ]
    ).astype(f32)

    det = f32(
        r[0, 0] * inv[0, 0]
        + r[0, 1] * inv[1, 0]
        + r[0, 2] * inv[2, 0]
        + r[0, 3] * inv[3, 0]
    )
    return (f32(1.0) / det * inv).astype(f32)
