"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

The tests feed the same numpy inputs to a JAX function and to its
counterpart here (``device="cpu"``); these helpers move arrays in and out
of the port's SoA types. Imports no JAX. Importing this module pins PyTorch
to one thread: the test suite runs several worker processes side by side.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pathtracing_tpu_torch.utils.goldenio import load_golden
from pathtracing_tpu_torch.utils.vec import Vec3

torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"


def golden(name: str) -> dict[str, np.ndarray]:
    """Load ``tests/golden/<name>`` (the oracle's dumps are committed)."""
    return load_golden(str(GOLDEN_DIR / name))


def t(a, dtype=None) -> torch.Tensor:
    """numpy array -> CPU tensor (a copy; uint32 goes to its int32 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(a.copy())
    return out if dtype is None else out.to(dtype)


def vec3_t(a) -> Vec3:
    """(N, 3) numpy -> Vec3 of CPU tensors."""
    return Vec3(*(t(a[:, i]) for i in range(3)))


def n(x) -> np.ndarray:
    """tensor (or anything array-like, e.g. a JAX array) -> numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stack(components) -> np.ndarray:
    """A Vec (or any tuple of same-shape tensors/arrays) -> (N, k) numpy."""
    return np.stack([n(c) for c in components], axis=-1)


def rel_err(got, ref, eps) -> np.ndarray:
    return np.abs(got - ref) / (np.abs(ref) + eps)


def assert_same_tables(tscene, jscene) -> None:
    """The port's SceneDevice against the JAX package's: same field names in
    the same order, and every table the JAX scene has equal in shape, dtype
    and bytes (contiguous on the port's side); what it lacks is None here."""
    np_of_torch = {torch.float32: np.float32, torch.int32: np.int32, torch.int8: np.int8}
    assert tscene._fields == jscene._fields
    for k in tscene._fields:
        tv, jv = getattr(tscene, k), getattr(jscene, k)
        if jv is None:
            assert tv is None, k
            continue
        jv = np.asarray(jv)
        assert tuple(tv.shape) == jv.shape, k
        assert np_of_torch[tv.dtype] == jv.dtype, k
        assert tv.is_contiguous(), k
        assert n(tv).tobytes() == jv.tobytes(), k


def assert_hits_agree(hit_t, occ_t, hit_j, occ_j, atol_scale=1.0) -> None:
    """A ray query of the port against the JAX package's on the same rays:
    ``occluded`` and hit/miss equal, ids equal on >= 99.8 % of hits, ``thit``
    rtol 2e-5 / atol 1e-5, and where ids agree ``back`` equal and the
    barycentrics rtol 1e-4 / atol 1e-5 (differences of products: FMA
    contraction on the XLA side moves them by more ulps than it moves t).
    The atols are for the golden scene's coordinates (|x| <= 12): an error
    from rounding follows the ulps of the coordinates t and the
    barycentrics are computed from, so rays among larger coordinates pass
    ``atol_scale`` = their magnitude over 12."""
    np.testing.assert_array_equal(n(occ_t), n(occ_j))
    thit_t, thit_j = n(hit_t.thit), n(hit_j.thit)
    np.testing.assert_array_equal(thit_t < 0, thit_j < 0)
    h = thit_j >= 0
    np.testing.assert_allclose(thit_t[h], thit_j[h], rtol=2e-5, atol=1e-5 * atol_scale)
    same = (n(hit_t.inst) == n(hit_j.inst)) & (n(hit_t.prim) == n(hit_j.prim))
    assert (h & ~same).sum() <= 0.002 * max(h.sum(), 1), (h & ~same).sum()
    np.testing.assert_array_equal(n(hit_t.inst)[~h], -1)
    np.testing.assert_array_equal(n(hit_t.prim)[~h], 0)
    exact = h & same
    np.testing.assert_array_equal(n(hit_t.back)[exact], n(hit_j.back)[exact])
    for k in ("bary_u", "bary_v", "bary_w"):
        np.testing.assert_allclose(
            n(getattr(hit_t, k))[exact], n(getattr(hit_j, k))[exact],
            rtol=1e-4, atol=1e-5 * atol_scale,
        )
