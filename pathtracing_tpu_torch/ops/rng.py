"""Bit-faithful PCG4D counter-based RNG (reference: math.hh:466-485).

The seed layout is ``{pixel_x, pixel_y, sample_index, STUDENT_ID}`` with one
warm-up step (reference: path_tracer.hh:659-660). Every sample owns an
independent counter, so samples split freely across tiles and devices.

State is four **int32** tensors holding the uint32 bit patterns: PyTorch's
``uint32`` lacks most arithmetic, while int32 multiply/add wrap mod 2^32 to
the same bits. The one place signedness shows is the right shift, which is
made logical by masking the sign-extended bits off.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from pathtracing_tpu_torch.utils.vec import Vec4

Array = Any

_MUL = 1664525
_ADD = 1013904223
_U2F = 2.3283064365386963e-10  # 1/2^32 (reference: math.hh:484)


class Seed(NamedTuple):
    """uint4 RNG state as four int32 tensors (uint32 bit patterns)."""

    x: Array
    y: Array
    z: Array
    w: Array


def _xorshift16(v):
    # logical >> 16 of the uint32 pattern held in an int32
    return v ^ ((v >> 16) & 0xFFFF)


def pcg4d(s: Seed) -> Seed:
    """One PCG4D step; returns the new state (= the uint4 output).

    reference: math.hh:466-473 — LCG, simultaneous cross multiply-add,
    xorshift 16, second cross multiply-add.
    """
    x = s.x * _MUL + _ADD
    y = s.y * _MUL + _ADD
    z = s.z * _MUL + _ADD
    w = s.w * _MUL + _ADD
    # seed += seed.yzxy * seed.wxyz  (simultaneous)
    x, y, z, w = x + y * w, y + z * x, z + x * y, w + y * z
    x = _xorshift16(x)
    y = _xorshift16(y)
    z = _xorshift16(z)
    w = _xorshift16(w)
    x, y, z, w = x + y * w, y + z * x, z + x * y, w + y * z
    return Seed(x, y, z, w)


def _to_f32(v) -> Array:
    # (float)uint32 then * 2^-32, matching C's conversion+scale
    # (reference: math.hh:477-484). The unsigned value goes through int64 so
    # the conversion to float32 rounds once.
    return (v.to(torch.int64) & 0xFFFFFFFF).to(torch.float32) * _U2F


def uniform4(s: Seed) -> tuple[Seed, Vec4]:
    """generate_uniform_random4 (reference: math.hh:475-485).

    Returns (new_state, float4 in [0,1]).
    """
    s = pcg4d(s)
    return s, Vec4(_to_f32(s.x), _to_f32(s.y), _to_f32(s.z), _to_f32(s.w))


def uniform4_masked(s: Seed, consume) -> tuple[Seed, Vec4]:
    """Per-lane conditional draw.

    Lanes where ``consume`` is False keep their previous state and their
    returned values are unspecified. This replicates the reference's
    *conditional* RNG consumption (the atmosphere early-outs at
    path_tracer.hh:513-525 skip the draw on some paths, desynchronizing
    naive ports).
    """
    nxt = pcg4d(s)
    out = Seed(
        torch.where(consume, nxt.x, s.x),
        torch.where(consume, nxt.y, s.y),
        torch.where(consume, nxt.z, s.z),
        torch.where(consume, nxt.w, s.w),
    )
    return out, Vec4(_to_f32(nxt.x), _to_f32(nxt.y), _to_f32(nxt.z), _to_f32(nxt.w))
