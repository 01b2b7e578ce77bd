"""The transposes of the integrator's two custom-VJP gathers: the plain
versions of the K7 kernels (``ops/integrator.small_table_grad_plain``,
``vattr_grad3_plain``) against the JAX package's backward rules (``_stg_bwd``,
``_vg3_bwd``) called directly, the autograd Functions that run them
(``SmallTableGather``, ``VattrGather3``), and the kernels' wrappers on the
CPU (which refuse: the kernels run on the card only, in chip_smoke.py).

Inputs come from numpy with a fixed seed, with heavy duplication (every lane
of a frame lands on a few rows). Bars: on dyadic inputs (small multiples of
1/64, whose sums are exact in any order) the results are equal; on normal
floats within rtol 1e-6 and atol 1e-6 * max|ref|, the summation order of
index_add_ and of XLA's dot or scatter differing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops import integrator as jint
from pathtracing_tpu_torch.ops import cuda_gather_grad as CG
from pathtracing_tpu_torch.ops.integrator import (
    SmallTableGather,
    VattrGather3,
    small_table_gather,
    small_table_grad_plain,
    vattr_gather3,
    vattr_grad3_plain,
)

RNG = np.random.default_rng(7)


def _inputs(R, S, C, dyadic):
    # a few hot rows take most lanes, as on a frame
    idx = np.where(RNG.random(R) < 0.8, RNG.integers(0, 3, R), RNG.integers(0, S, R))
    if dyadic:
        g = RNG.integers(-64, 65, (R, C)).astype(np.float32) / np.float32(64)
    else:
        g = RNG.standard_normal((R, C)).astype(np.float32)
    return idx.astype(np.int32), g


def _close(got, ref, dyadic):
    if dyadic:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("S,C", [(32, 18), (32, 7), (5, 3)])
def test_small_table_grad_plain_matches_jax(S, C, dyadic):
    idx, g = _inputs(3000, S, C, dyadic)
    ref = jax.jit(lambda i, gg: jint._stg_bwd((i, S), gg)[0])(jnp.asarray(idx), jnp.asarray(g))
    got = small_table_grad_plain(torch.from_numpy(idx), torch.from_numpy(g), S)
    assert got.shape == (S, C) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(ref), dyadic)


@pytest.mark.parametrize("dyadic", [True, False])
def test_vattr_grad3_plain_matches_jax(dyadic):
    R, V, C = 2000, 1781, 12
    ti3 = np.where(RNG.random((R, 3)) < 0.8, RNG.integers(0, 3, (R, 3)),
                   RNG.integers(0, V, (R, 3))).astype(np.int32)
    if dyadic:
        g = RNG.integers(-64, 65, (R, 3, C)).astype(np.float32) / np.float32(64)
    else:
        g = RNG.standard_normal((R, 3, C)).astype(np.float32)
    g[RNG.random(R) < 0.5] = 0.0  # miss lanes: zero cotangents on hot rows
    ref = jax.jit(lambda t, gg: jint._vg3_bwd((t, V), gg)[0])(jnp.asarray(ti3), jnp.asarray(g))
    got = vattr_grad3_plain(torch.from_numpy(ti3), torch.from_numpy(g), V)
    assert got.shape == (V, C)
    _close(got.numpy(), np.asarray(ref), dyadic)


def test_autograd_functions_gradcheck():
    """Forward = the plain gather; backward = the plain transposes, checked
    against finite differences in float64 (CPU tensors take the plain
    versions); the index gets no gradient."""
    table = torch.from_numpy(RNG.standard_normal((5, 3))).requires_grad_(True)
    idx = torch.from_numpy(RNG.integers(0, 5, 40).astype(np.int32))
    assert torch.autograd.gradcheck(lambda t: SmallTableGather.apply(t, idx), (table,))
    vattr = torch.from_numpy(RNG.standard_normal((9, 4))).requires_grad_(True)
    ti3 = torch.from_numpy(RNG.integers(0, 9, (30, 3)).astype(np.int32))
    assert torch.autograd.gradcheck(lambda v: VattrGather3.apply(v, ti3), (vattr,))
    # forward bits are the gather's; the backward is the plain version's
    t32 = table.detach().float().requires_grad_(True)
    out = small_table_gather(t32, idx)
    assert torch.equal(out, t32.detach()[idx])
    gout = torch.from_numpy(RNG.standard_normal(out.shape).astype(np.float32))
    (gt,) = torch.autograd.grad(out, t32, gout)
    assert torch.equal(gt, small_table_grad_plain(idx, gout, 5))
    v32 = vattr.detach().float().requires_grad_(True)
    out3 = vattr_gather3(v32, ti3)
    assert out3.shape == (30, 3, 4) and torch.equal(out3, v32.detach()[ti3])
    g3 = torch.from_numpy(RNG.standard_normal(out3.shape).astype(np.float32))
    (gv,) = torch.autograd.grad(out3, v32, g3)
    assert torch.equal(gv, vattr_grad3_plain(ti3, g3, 9))


def test_wrappers_refuse_cpu_tensors_and_bad_shapes():
    before = (CG.small_table_launches, CG.vattr_launches)
    idx, g = _inputs(64, 32, 18, True)
    idx_t, g_t = torch.from_numpy(idx), torch.from_numpy(g)
    with pytest.raises(ValueError, match="CUDA"):
        CG.small_table_grad_cuda(idx_t, g_t, 32)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        CG.small_table_grad_cuda(idx_t, g_t[:, :, None], 32)
    ti3 = torch.zeros((64, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CG.vattr_grad3_cuda(ti3, torch.zeros((64, 3, 12)), 10)
    with pytest.raises(ValueError, match=r"\(R, 3, C\)"):
        CG.vattr_grad3_cuda(ti3, torch.zeros((64, 12)), 10)
    with pytest.raises(ValueError, match="at most 32"):
        CG.vattr_grad3_cuda(ti3, torch.zeros((64, 3, 33)), 10)
    # counted only where a kernel is launched; no way from the wrappers to the
    # plain versions
    assert (CG.small_table_launches, CG.vattr_launches) == before
    src = CG.SOURCE.parent.parent.joinpath("ops", "cuda_gather_grad.py").read_text()
    assert "except" not in src and "_plain(" not in src
    # K7a's block count depends on the row count alone (determinism)
    assert [CG.small_table_blocks(r) for r in (1, 2048, 2049, 2_073_600, 10**9)] == [
        1, 1, 2, 1013, CG.MAX_BLOCKS]
