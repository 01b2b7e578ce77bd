"""Host-side float32 matrix/vector helpers (numpy).

Mirrors the scalar matrix algebra the reference keeps in ``math.hh:151-338``.
All matrices are row-major ``np.float32 (N,N)`` arrays and the reference's
quirky product conventions are preserved:

  mul_m4v4(m, v)  = mᵀ · v      (reference: math.hh:228)
  mul_m4m4(b, a)  = a · b       (reference: math.hh:247-256)

These run on the host for scene/instance setup only (the JAX package's
``utils/hostmath.py``, the same bytes); the device-side batched equivalents
live in utils.vec.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def mul_m4v4(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """reference: math.hh:228 — mᵀ·v in row-major storage."""
    return (m.astype(f32).T @ v.astype(f32)).astype(f32)


def mul_m3v3(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """reference: math.hh:227."""
    return (m.astype(f32).T @ v.astype(f32)).astype(f32)


def mul_v3m3(v: np.ndarray, m: np.ndarray) -> np.ndarray:
    """reference: math.hh:224 — rows·v."""
    return (m.astype(f32) @ v.astype(f32)).astype(f32)


def mul_m4m4(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """reference: math.hh:247-256 — result[i][j] = a_row_i · b_col_j."""
    return (a.astype(f32) @ b.astype(f32)).astype(f32)


def expand_m3m4(m3: np.ndarray) -> np.ndarray:
    """reference: math.hh:268-276."""
    m = np.eye(4, dtype=f32)
    m[:3, :3] = m3
    return m


def extract_m4m3(m4: np.ndarray) -> np.ndarray:
    """reference: math.hh:278-285."""
    return np.ascontiguousarray(m4[:3, :3], dtype=f32)


def rotation_euler(euler: np.ndarray) -> np.ndarray:
    """Pitch→yaw→roll composition (reference: math.hh:305-318). Radians."""
    e = np.asarray(euler, dtype=f32)
    sp, cp = f32(np.sin(e[0])), f32(np.cos(e[0]))
    sy, cy = f32(np.sin(e[1])), f32(np.cos(e[1]))
    sr, cr = f32(np.sin(e[2])), f32(np.cos(e[2]))
    pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=f32)
    yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=f32)
    roll = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], dtype=f32)
    # mul_m3m3(roll, mul_m3m3(yaw, pitch)) = (pitch @ yaw) @ roll
    return expand_m3m4((pitch @ yaw) @ roll)


def rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle (reference: math.hh:294-303)."""
    axis = np.asarray(axis, dtype=f32)
    sa, ca = f32(np.sin(angle)), f32(np.cos(angle))
    ax, ay, az = axis
    K = np.array([[0, az, -ay], [-az, 0, ax], [ay, -ax, 0]], dtype=f32)
    R = np.eye(3, dtype=f32) + sa * K + (f32(1) - ca) * (K @ K).astype(f32)
    return expand_m3m4(R.astype(f32))


def scaling(scale: np.ndarray) -> np.ndarray:
    """reference: math.hh:320-328."""
    s = np.asarray(scale, dtype=f32)
    return np.diag([s[0], s[1], s[2], f32(1)]).astype(f32)


def translation(offset: np.ndarray) -> np.ndarray:
    """reference: math.hh:330-338 — offset lives in row 3."""
    m = np.eye(4, dtype=f32)
    m[3, :3] = np.asarray(offset, dtype=f32)
    return m


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


def create_tangent_np(normal: np.ndarray) -> np.ndarray:
    """reference: math.hh:419-428."""
    n = np.asarray(normal, dtype=f32)
    thr = 0.57735026918962576451
    if abs(n[0]) < thr:
        major = np.array([1, 0, 0], dtype=f32)
    elif abs(n[1]) < thr:
        major = np.array([0, 1, 0], dtype=f32)
    else:
        major = np.array([0, 0, 1], dtype=f32)
    t = np.cross(n, major).astype(f32)
    return (t / f32(np.sqrt(np.dot(t, t)))).astype(f32)


def create_tangent_space_np(normal: np.ndarray) -> np.ndarray:
    """Rows {tangent, bitangent, normal} (reference: math.hh:430-435)."""
    n = np.asarray(normal, dtype=f32)
    t = create_tangent_np(n)
    b = np.cross(n, t).astype(f32)
    return np.stack([t, b, n]).astype(f32)
