"""Port's PCG4D vs the oracle's rng.gold and vs the JAX package: bit-exact.

The port carries the uint32 state as int32 bit patterns; every comparison
is on the bits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu_torch.ops import rng as trng
from pathtracing_tpu_torch.testing import golden, n, t


def _bits(seed) -> np.ndarray:
    return np.stack([n(c).view(np.uint32) for c in seed], axis=-1)


def _tseed(seeds: np.ndarray) -> trng.Seed:
    return trng.Seed(*(t(seeds[:, i]) for i in range(4)))


def test_pcg4d_states_match_golden():
    g = golden("rng.gold")
    s = _tseed(g["seeds"])
    for j in range(g["states"].shape[1]):
        s = trng.pcg4d(s)
        assert all(c.dtype == torch.int32 for c in s)
        np.testing.assert_array_equal(_bits(s), g["states"][:, j], err_msg=f"step {j}")


def test_uniform4_matches_golden_bitexact():
    g = golden("rng.gold")
    s = _tseed(g["seeds"])
    for j in range(g["uniforms"].shape[1]):
        s, u = trng.uniform4(s)
        got = np.stack([n(c) for c in u], axis=-1)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, g["uniforms"][:, j], err_msg=f"step {j}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_on_random_seeds(seed):
    """Random uint32 states (high bits set: the sign-extending shift and the
    unsigned float conversion are the places a signed carrier can go wrong)."""
    rs = np.random.default_rng(seed)
    seeds = rs.integers(0, 2**32, size=(4096, 4), dtype=np.uint64).astype(np.uint32)
    seeds[0] = 0xFFFFFFFF
    seeds[1] = 0x80000000
    js = jrng.Seed(*(jnp.asarray(seeds[:, i]) for i in range(4)))
    ts = _tseed(seeds)
    for _ in range(3):
        js, ju = jrng.uniform4(js)
        ts, tu = trng.uniform4(ts)
        np.testing.assert_array_equal(_bits(ts), np.stack([n(c) for c in js], -1))
        np.testing.assert_array_equal(
            np.stack([n(c) for c in tu], -1), np.stack([n(c) for c in ju], -1)
        )


def test_uniform4_masked_keeps_state_on_unconsumed_lanes():
    g = golden("rng.gold")
    seeds = g["seeds"]
    consume_np = np.array([True, False, True, False, True, False])
    s0 = _tseed(seeds)
    s1, u1 = trng.uniform4_masked(s0, torch.from_numpy(consume_np))
    nxt = trng.pcg4d(s0)
    np.testing.assert_array_equal(
        _bits(s1), np.where(consume_np[:, None], _bits(nxt), seeds)
    )
    # and equal to the JAX package's, values included on consumed lanes
    j0 = jrng.Seed(*(jnp.asarray(seeds[:, i]) for i in range(4)))
    j1, ju = jrng.uniform4_masked(j0, jnp.asarray(consume_np))
    np.testing.assert_array_equal(_bits(s1), np.stack([n(c) for c in j1], -1))
    np.testing.assert_array_equal(
        np.stack([n(c) for c in u1], -1)[consume_np],
        np.stack([n(c) for c in ju], -1)[consume_np],
    )
