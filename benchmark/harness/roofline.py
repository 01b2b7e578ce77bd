"""The least time an H100 could take for a window's path work.

Operations: the path's own events, counted by the plain reference on the
checked pixels (camera samples, rays, shaded hits and misses, atmosphere
marches, NEE evaluations and transmittance marches, BSDF samples, light
samples and light pdfs), scaled to the window's samples, each charged the
float operations of its piece of device code. The table was counted from
the path kernels' source (``csrc/shading.cuh``, ``csrc/megakernel.cu``:
every float add, subtract, multiply, divide, square root and
transcendental is one; comparisons, selects and the RNG's integer work
none) and is frozen here, as the repository's ``chip_smoke.py`` had it in
``MK_FLOPS``. The walk is charged one triangle test a ray and no node
visit: the least any acceleration structure needs.

Bytes: each table of the scene read once (per triangle its 9 coordinates
and vertex ids, per vertex 12 floats, per instance 21 floats, per
subframe a camera and a light row, and the light tables) and each request's
output written once (12 bytes a pixel).

Peaks: NVIDIA's data sheet for one H100 SXM, float32 outside the tensor
cores and HBM3 bandwidth, at the full 700 W; the card's power limit is
recorded beside every share.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

TRI_TEST_FLOPS = 52
EVENT_FLOPS = {
    "samples": 85,        # film draw, Gaussian disk, camera ray
    "rays": 3 + TRI_TEST_FLOPS,  # reciprocal direction, one triangle test
    "shade_hits": 241,    # instance ray, triangle test, 10 attributes, normal,
                          # tangent space, position + the path update after it
    "shade_misses": 95,   # sun disk, tangent space, position + path update
    "atmo_marches": 1590,  # 8 primary x 4 secondary steps, phases, in-scatter
    "nee_evals": 236,     # cone sample, tangent space, bsdf_eval
    "nee_marches": 268,   # MIS weight + the 8-step transmittance march
    "bsdf_samples": 244,  # view, GGX VNDF, lobe pick, bsdf_core, new direction
    "light_samples": 297,  # CDF pick, point, pdf, emission, bsdf_eval, MIS
    "light_pdfs": 30,     # a closest hit's solid-angle pdf on an emitter
}


def flops(counts: dict, scale: float) -> float:
    """Float operations of the events ``counts`` (of the reference's
    samples) scaled by ``scale`` (window samples / reference samples)."""
    return scale * sum(EVENT_FLOPS[k] * counts.get(k, 0) for k in EVENT_FLOPS)


def least_seconds(flop: float, nbytes: float) -> tuple[float, str]:
    """(seconds, what bounds it): the larger of operations over the float32
    peak and bytes over the memory peak."""
    by_ops = flop / FP32_FLOPS
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
