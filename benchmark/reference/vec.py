"""Structure-of-arrays vector math on tensors.

The reference models rays with ``float3`` structs processed one at a time
(reference: math.hh:11-148). The batched layout is the transpose: a "float3"
is three separate ``(R,)`` tensors, one element per ray. ``Vec3``/``Vec4``
are NamedTuples of component tensors with elementwise operators matching the
reference's semantics.

Every expression keeps the reference's operand order and association, and
none uses a fused op (``addcmul``, ``lerp``): eager PyTorch rounds after each
op, like the oracle built without FMA contraction.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

Array = Any


class Vec2(NamedTuple):
    x: Array
    y: Array

    def __add__(self, o):
        o = _as2(o)
        return Vec2(self.x + o.x, self.y + o.y)

    def __radd__(self, o):
        return _as2(o).__add__(self)

    def __sub__(self, o):
        o = _as2(o)
        return Vec2(self.x - o.x, self.y - o.y)

    def __rsub__(self, o):
        return _as2(o).__sub__(self)

    def __mul__(self, o):
        o = _as2(o)
        return Vec2(self.x * o.x, self.y * o.y)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        o = _as2(o)
        return Vec2(self.x / o.x, self.y / o.y)

    def __rtruediv__(self, o):
        return _as2(o).__truediv__(self)

    def __neg__(self):
        return Vec2(-self.x, -self.y)


class Vec3(NamedTuple):
    x: Array
    y: Array
    z: Array

    def __add__(self, o):
        o = _as3(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __radd__(self, o):
        return _as3(o).__add__(self)

    def __sub__(self, o):
        o = _as3(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        return _as3(o).__sub__(self)

    def __mul__(self, o):
        o = _as3(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        o = _as3(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __rtruediv__(self, o):
        return _as3(o).__truediv__(self)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


class Vec4(NamedTuple):
    x: Array
    y: Array
    z: Array
    w: Array

    @property
    def xyz(self) -> Vec3:
        return Vec3(self.x, self.y, self.z)

    def __add__(self, o):
        o = _as4(o)
        return Vec4(self.x + o.x, self.y + o.y, self.z + o.z, self.w + o.w)

    def __radd__(self, o):
        return _as4(o).__add__(self)

    def __sub__(self, o):
        o = _as4(o)
        return Vec4(self.x - o.x, self.y - o.y, self.z - o.z, self.w - o.w)

    def __rsub__(self, o):
        return _as4(o).__sub__(self)

    def __mul__(self, o):
        o = _as4(o)
        return Vec4(self.x * o.x, self.y * o.y, self.z * o.z, self.w * o.w)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        o = _as4(o)
        return Vec4(self.x / o.x, self.y / o.y, self.z / o.z, self.w / o.w)

    def __neg__(self):
        return Vec4(-self.x, -self.y, -self.z, -self.w)


def _as2(o) -> Vec2:
    return o if isinstance(o, Vec2) else Vec2(o, o)


def _as3(o) -> Vec3:
    return o if isinstance(o, Vec3) else Vec3(o, o, o)


def _as4(o) -> Vec4:
    return o if isinstance(o, Vec4) else Vec4(o, o, o, o)


def c32(v) -> float:
    """A constant rounded to float32 and handed back as a Python float, so
    that a tensor op takes it without promoting and at the value the JAX
    package's ``np.float32`` constants have."""
    return float(np.float32(v))


class _IeeeSqrt(torch.autograd.Function):
    """A float64 root rounded once to float32 (the IEEE result); the
    backward is ``torch.sqrt``'s, in float32: ``grad / (2 * result)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.sqrt(x.double()).float()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        return grad / (2 * out)


def sqrt(x):
    """IEEE square root, correctly rounded on every device, as the oracle's
    ``sqrtf``, XLA's and the CUDA kernels' (``--prec-sqrt=true``) are.
    PyTorch's vectorised CPU kernel is one ulp off on ~0.6 % of float32
    inputs, so on the CPU the root is taken in float64 and rounded once."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return _IeeeSqrt.apply(x)
    return torch.sqrt(x)


def dot2(a: Vec2, b: Vec2):
    return a.x * b.x + a.y * b.y


def dot3(a: Vec3, b: Vec3):
    """reference: math.hh:94 — left-to-right FMA-free sum."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    """reference: math.hh:125."""
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length3(a: Vec3):
    return sqrt(dot3(a, a))


def normalize3(a: Vec3) -> Vec3:
    return a / length3(a)


def maximum(a, b):
    """NaN-propagating max of a tensor with a tensor or a Python scalar."""
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def minimum(a, b):
    """NaN-propagating min of a tensor with a tensor or a Python scalar."""
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


def fabs3(a: Vec3) -> Vec3:
    return Vec3(torch.abs(a.x), torch.abs(a.y), torch.abs(a.z))


def clamp(v, lo, hi):
    """reference: math.hh:134-135 — fmin(fmax(v, lo), hi)."""
    return minimum(maximum(v, lo), hi)


def mix(a, b, t):
    """reference: math.hh:145 — a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def where3(c, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z)
    )


def where2(c, a: Vec2, b: Vec2) -> Vec2:
    return Vec2(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y))


def luminance(col: Vec3):
    """reference: math.hh:437-440 (Rec.709 weights)."""
    return dot3(col, Vec3(c32(0.2126), c32(0.7152), c32(0.0722)))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """reference: math.hh:442-445."""
    return i - n * (2.0 * dot3(n, i))


def refract(i: Vec3, n: Vec3, eta) -> Vec3:
    """reference: math.hh:447-453 — returns the zero vector on TIR."""
    ndoti = dot3(n, i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    tir = k < 0.0
    k = torch.where(tir, 1.0, k)  # guarded operand: no sqrt of a negative
    out = i * eta - n * (eta * ndoti + sqrt(k))
    zero = torch.zeros_like(k)
    return where3(tir, Vec3(zero, zero, zero), out)


def normalize3_safe(a: Vec3) -> Vec3:
    """normalize with a zero-length guard for select chains."""
    l = length3(a)
    l = torch.where(l == 0, 1.0, l)
    return a / l


def inv_erf(x):
    """Winitzki approximation, a=0.147 (reference: math.hh:455-463)."""
    ln1x2 = torch.log(1.0 - x * x)
    a = np.float32(0.147)
    p = np.float32(2.0) / (np.float32(math.pi) * a)
    k = ln1x2 * 0.5 + float(p)
    k2 = k * k
    return torch.sign(x) * sqrt(
        sqrt(k2 - ln1x2 * float(np.float32(1.0) / a)) - k
    )


class Mat3(NamedTuple):
    """Row-major 3x3 of Vec3 rows — batched (reference: math.hh:152)."""

    r0: Vec3
    r1: Vec3
    r2: Vec3

    def mul_vec(self, v: Vec3) -> Vec3:
        """mul_m3v3(m, v): column-vector product, i.e. vᵀ·m columns.

        reference: math.hh:227 — mul_m3v3(b, a) = mul_v3m3(a, transpose3(b)).
        """
        return Vec3(
            self.r0.x * v.x + self.r1.x * v.y + self.r2.x * v.z,
            self.r0.y * v.x + self.r1.y * v.y + self.r2.y * v.z,
            self.r0.z * v.x + self.r1.z * v.y + self.r2.z * v.z,
        )

    def vec_mul(self, v: Vec3) -> Vec3:
        """mul_v3m3(v, m): rows·v (reference: math.hh:224)."""
        return Vec3(dot3(self.r0, v), dot3(self.r1, v), dot3(self.r2, v))


def create_tangent(normal: Vec3) -> Vec3:
    """reference: math.hh:419-428 — branch on component < 1/sqrt(3)."""
    thr = c32(0.57735026918962576451)
    use_x = torch.abs(normal.x) < thr
    use_y = torch.logical_and(torch.logical_not(use_x), torch.abs(normal.y) < thr)
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    major = Vec3(
        torch.where(use_x, one, zero),
        torch.where(use_y, one, zero),
        torch.where(torch.logical_or(use_x, use_y), zero, one),
    )
    return normalize3(cross(normal, major))


def create_tangent_space(normal: Vec3) -> Mat3:
    """Rows = {tangent, bitangent, normal} (reference: math.hh:430-435)."""
    tangent = create_tangent(normal)
    bitangent = cross(normal, tangent)
    return Mat3(tangent, bitangent, normal)
