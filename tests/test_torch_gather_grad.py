"""The transposes of the integrator's custom-VJP gathers: the plain
versions of the K7 kernels (``ops/integrator.small_table_grad_plain``,
``row_grad_plain``) against the JAX package's backward rules (``_stg_bwd``,
``_vg3_bwd``) called directly and against ``jax.vjp`` of a plain gather, the
autograd Functions that run them (``SmallTableGather``, ``RowGather``),
shade_hit's gradients through ``RowGather`` against the same graph with
plain indexing, and the kernels' wrappers on the CPU (which refuse: the
kernels run on the card only, in chip_smoke.py).

Inputs come from numpy with a fixed seed, with heavy duplication (every lane
of a frame lands on a few rows). Bars: on dyadic inputs (small multiples of
1/64, whose sums are exact in any order) the results are equal; on normal
floats within rtol 1e-6 and atol 1e-6 * max|ref|, the summation order of
index_add_ and of XLA's dot or scatter differing. shade_hit's gradients
through RowGather (sums in double) against PyTorch's index backward (sums in
float): rtol 1e-5, atol 1e-6 * max|ref|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops import integrator as jint
from pathtracing_tpu_torch.ops import cuda_gather_grad as CG
from pathtracing_tpu_torch.ops import integrator as tinteg
from pathtracing_tpu_torch.ops.integrator import (
    RowGather,
    SmallTableGather,
    row_gather,
    row_grad_plain,
    small_table_gather,
    small_table_grad_plain,
)
from pathtracing_tpu_torch.ops.traversal import ray_query
from pathtracing_tpu_torch.scene.golden import scene_device_from_golden
from pathtracing_tpu_torch.testing import golden, vec3_t

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
    """row_grad_plain on an (R, 3) index: the JAX package's ``_vg3_bwd``."""
    R, V, C = 2000, 1781, 12
    ti3 = np.where(RNG.random((R, 3)) < 0.8, RNG.integers(0, 3, (R, 3)),
                   RNG.integers(0, V, (R, 3))).astype(np.int32)
    if dyadic:
        g = RNG.integers(-64, 65, (R, 3, C)).astype(np.float32) / np.float32(64)
    else:
        g = RNG.standard_normal((R, 3, C)).astype(np.float32)
    g[RNG.random(R) < 0.5] = 0.0  # miss lanes: zero cotangents on hot rows
    ref = jax.jit(lambda t, gg: jint._vg3_bwd((t, V), gg)[0])(jnp.asarray(ti3), jnp.asarray(g))
    got = row_grad_plain(torch.from_numpy(ti3), torch.from_numpy(g), V)
    assert got.shape == (V, C)
    _close(got.numpy(), np.asarray(ref), dyadic)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("V,C", [(7, 21), (3162, 12)])
def test_row_grad_plain_one_column_index_matches_jax_vjp(V, C, dyadic):
    """row_grad_plain on an (R,) index (shade_hit's inst_f and tri_pos
    gathers): the transpose XLA derives for ``table[idx]`` (jax.vjp)."""
    idx, g = _inputs(2500, V, C, dyadic)
    g[RNG.random(len(idx)) < 0.5] = 0.0  # miss lanes: zero cotangents on hot rows
    table = jnp.zeros((V, C), jnp.float32)
    _, vjp = jax.vjp(lambda tab: tab[jnp.asarray(idx)], table)
    (ref,) = jax.jit(vjp)(jnp.asarray(g))
    got = row_grad_plain(torch.from_numpy(idx), torch.from_numpy(g), V)
    assert got.shape == (V, C) and got.dtype == torch.float32
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
    assert torch.autograd.gradcheck(lambda v: RowGather.apply(v, ti3), (vattr,))
    # forward bits are the gather's; the backward is the plain version's
    t32 = table.detach().float().requires_grad_(True)
    out = small_table_gather(t32, idx)
    assert torch.equal(out, t32.detach()[idx])
    gout = torch.from_numpy(RNG.standard_normal(out.shape).astype(np.float32))
    (gt,) = torch.autograd.grad(out, t32, gout)
    assert torch.equal(gt, small_table_grad_plain(idx, gout, 5))
    v32 = vattr.detach().float().requires_grad_(True)
    out3 = row_gather(v32, ti3)
    assert out3.shape == (30, 3, 4) and torch.equal(out3, v32.detach()[ti3])
    g3 = torch.from_numpy(RNG.standard_normal(out3.shape).astype(np.float32))
    (gv,) = torch.autograd.grad(out3, v32, g3)
    assert torch.equal(gv, row_grad_plain(ti3, g3, 9))


def test_row_gather_one_column_index_gradcheck():
    """RowGather on an (R,) index with heavy duplication, in double against
    finite differences; forward bits are the gather's."""
    table = torch.from_numpy(RNG.standard_normal((7, 21))).requires_grad_(True)
    idx = torch.from_numpy(np.where(RNG.random(60) < 0.7, 0,
                                    RNG.integers(0, 7, 60)).astype(np.int32))
    assert torch.autograd.gradcheck(lambda v: RowGather.apply(v, idx), (table,))
    out = row_gather(table, idx)
    assert torch.equal(out, table.detach()[idx])


@pytest.fixture(scope="module")
def shade_setup():
    """The golden scene, packed with the wide tables (so both fetches can
    read it), and the port's closest hits of 384 rays of rays.gold (misses
    included: their lanes read row 0)."""
    g, rg = golden("scene.gold"), golden("rays.gold")
    scene = scene_device_from_golden(g, wide=True, device="cpu")
    R = 384
    o, d = rg["origins"][:R], rg["dirs"][:R]
    full = lambda v: torch.full((R,), int(v), dtype=torch.int32)
    hit, _ = ray_query(scene, full(g["tlas"][0]), full(g["tlas"][1]), vec3_t(o), vec3_t(d),
                       0.0, 1e9, torch.ones(R, dtype=torch.bool))
    assert bool((hit.inst < 0).any()) and bool((hit.inst >= 0).any())
    return scene, hit, vec3_t(o), vec3_t(d)


def _shade_grads(scene, hit, o, d, packed, fields):
    """Gradients of a seeded weighted sum of shade_hit's outputs with
    respect to ``fields`` of the scene."""
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_(True) for k in fields}
    s = scene._replace(**leaves)
    light = tinteg.light_from_table(s.sf_light, torch.zeros(hit.thit.shape[0], dtype=torch.int32))
    info = tinteg.shade_hit(s, light, hit, o, d, packed=packed)
    outs = [info.thit, *info.pos, *info.tbn.r0, *info.tbn.r1, *info.tbn.r2, *info.albedo,
            info.alpha, info.roughness, info.metallic, info.transmission, info.eta]
    w = np.random.default_rng(11).standard_normal((len(outs), hit.thit.shape[0]))
    loss = sum((torch.from_numpy(wi.astype(np.float32)) * x).sum() for wi, x in zip(w, outs))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(fields, grads))


@pytest.mark.parametrize("packed", [False, True])
def test_shade_hit_row_gather_grads_match_plain_indexing(shade_setup, monkeypatch, packed):
    """shade_hit's inst_f / tri_pos (and vattr) gradients through RowGather
    equal those of the same graph with plain indexing (PyTorch's index
    backward), within rtol 1e-5; and every gather of those tables goes
    through RowGather."""
    scene, hit, o, d = shade_setup
    fields = ("inst_f",) if packed else ("inst_f", "tri_pos", "vattr")
    calls = []
    orig = tinteg.row_gather
    monkeypatch.setattr(tinteg, "row_gather",
                        lambda tab, i: calls.append(tuple(tab.shape)) or orig(tab, i))
    got = _shade_grads(scene, hit, o, d, packed, fields)
    want_calls = [tuple(scene.inst_f.shape)] + ([] if packed else [
        tuple(scene.vattr.shape), tuple(scene.tri_pos.shape)])
    assert calls == want_calls
    monkeypatch.setattr(tinteg, "row_gather", lambda tab, i: tab[i])
    ref = _shade_grads(scene, hit, o, d, packed, fields)
    for k in fields:
        a, b = got[k].numpy(), ref[k].numpy()
        assert np.abs(b).max() > 0, k
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=k)


def test_wrappers_refuse_cpu_tensors_and_bad_shapes():
    before = (CG.small_table_launches, CG.row_launches)
    idx, g = _inputs(64, 32, 18, True)
    idx_t, g_t = torch.from_numpy(idx), torch.from_numpy(g)
    with pytest.raises(ValueError, match="CUDA"):
        CG.small_table_grad_cuda(idx_t, g_t, 32)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        CG.small_table_grad_cuda(idx_t, g_t[:, :, None], 32)
    ti3 = torch.zeros((64, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CG.row_grad_cuda(ti3, torch.zeros((64, 3, 12)), 10)
    with pytest.raises(ValueError, match=r"index.shape \+ \(C,\)"):
        CG.row_grad_cuda(ti3, torch.zeros((64, 12)), 10)
    with pytest.raises(ValueError, match="at most 32"):
        CG.row_grad_cuda(ti3, torch.zeros((64, 3, 33)), 10)
    # at most 32 columns, and an index of one column or three, for (R,) too
    i1 = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CG.row_grad_cuda(i1, torch.zeros((64, 21)), 7)
    with pytest.raises(ValueError, match="at most 32"):
        CG.row_grad_cuda(i1, torch.zeros((64, 33)), 7)
    for bad in ((64, 2), (64, 4), (4, 16, 3)):
        with pytest.raises(ValueError, match=r"\(R,\) or \(R, 3\)"):
            CG.row_grad_cuda(torch.zeros(bad, dtype=torch.int32), torch.zeros((*bad, 12)), 7)
    # counted only where a kernel is launched; no way from the wrappers to the
    # plain versions
    assert (CG.small_table_launches, CG.row_launches) == before
    src = CG.SOURCE.parent.parent.joinpath("ops", "cuda_gather_grad.py").read_text()
    assert "except" not in src and "_plain(" not in src and "index_add" not in src
    # K7a's block count depends on the row count alone (determinism)
    assert [CG.small_table_blocks(r) for r in (1, 512, 513, 524_288, 10**9)] == [
        1, 1, 2, 1024, CG.MAX_BLOCKS]
