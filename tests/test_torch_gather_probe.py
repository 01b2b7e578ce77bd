"""The row-gather probe (probes/gather_probe.py) vs the JAX tool it ports
(tools/gather_probe.py, loaded by path).

On the CPU ``gather_rows`` takes its plain version, one ``index_select``;
the harnesses ``chain`` and ``chain_window`` are held against the JAX tool's
functions of the same names driven with its XLA gather (``jnp.take``), and
``indep`` against the same scan the tool defines inside its ``main``. Sizes
are chosen so that every float32 sum is exact (table cells are 0.25 or 1.25,
at most 64 lanes, indices below 1024): results must be equal, not close.

The TPU kernel itself, ``pallas_gather``, cannot run here: it has no
interpret switch and is built from TPU-only primitives (asynchronous copies
on DMA semaphores, scalar prefetch). Its replacement, the CUDA kernel
``csrc/gather_rows.cu``, is compared with ``index_select`` on the card by
``chip_smoke.py``. What the kernel does besides copying, putting the
positions in slice order first, is held here through its plain version
(``bucket_order_plain``, ``gather_in_order_plain``) against numpy's stable
argsort and the JAX tool's XLA gather, with slices small enough that the
small table spans several."""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pathtracing_tpu_torch.probes import gather_probe as GP
from pathtracing_tpu_torch.testing import n

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_ROWS, WIDTH, LANES, REPS = 1024, 8, 64, 6


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gather_probe", ROOT / "tools" / "gather_probe.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2, (N_ROWS, WIDTH)).astype(np.float32) + 0.25
    idx0 = rng.integers(0, N_ROWS, LANES).astype(np.int32)
    idx_rows = rng.integers(0, N_ROWS, (REPS, LANES)).astype(np.int32)
    return table, idx0, idx_rows


def _xla_gather(t, i):
    return jnp.take(t, i, axis=0)


def test_plain_gather_equals_xla_gather(data):
    table, idx0, _ = data
    got = GP.gather_rows(torch.from_numpy(table), torch.from_numpy(idx0), k=4)
    assert got.shape == (LANES, WIDTH) and got.dtype == torch.float32
    assert n(got).tobytes() == np.asarray(_xla_gather(jnp.asarray(table), jnp.asarray(idx0))).tobytes()
    assert torch.equal(got, GP.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx0)))


def test_make_table_is_the_tools_table():
    a = GP.make_table(np.random.default_rng(0), 32, 8, "cpu")
    b = np.random.default_rng(0).integers(0, 2, (32, 8)).astype(np.float32) + 0.25
    assert n(a).tobytes() == b.tobytes()


@pytest.mark.parametrize("reps", [1, REPS])
def test_chain_equals_the_tools_chain(tool, data, reps):
    table, idx0, _ = data
    got = GP.chain(GP.gather_rows, torch.from_numpy(table), torch.from_numpy(idx0), reps, N_ROWS)
    want = jax.jit(
        lambda: tool.chain(_xla_gather, jnp.asarray(table), jnp.asarray(idx0), reps, N_ROWS)
    )()
    assert float(got) == float(want)


@pytest.mark.parametrize("window", [16, 256])
def test_chain_window_equals_the_tools_chain_window(tool, data, window):
    table, _, _ = data
    deltas = np.random.default_rng(1).integers(0, window, LANES).astype(np.int32)
    got = GP.chain_window(
        GP.gather_rows, torch.from_numpy(table), torch.from_numpy(deltas), REPS, N_ROWS, window
    )
    want = jax.jit(lambda: tool.chain_window(
        _xla_gather, jnp.asarray(table), jnp.asarray(deltas), REPS, N_ROWS, window
    ))()
    assert float(got) == float(want)


def test_indep_equals_the_tools_scan(data):
    table, _, idx_rows = data

    def tool_indep(tab, rows):  # tools/gather_probe.py, inside main()
        def body(acc, idx):
            rows = _xla_gather(tab, idx)
            return acc + rows[:, 0].sum(), None

        acc, _ = jax.lax.scan(body, jnp.float32(0), rows)
        return acc

    # the tool defines its scan inside main(), out of reach of an import: the
    # copy above is tied to it by its lines, so a change there fails here
    src = (ROOT / "tools" / "gather_probe.py").read_text()
    for line in (
        "def indep(table, idx_rows):",
        "rows = xla_gather(table, idx)",
        "return acc + rows[:, 0].sum(), None",
        "acc, _ = jax.lax.scan(body, jnp.float32(0), idx_rows)",
    ):
        assert line in src, line

    got = GP.indep(GP.gather_rows, torch.from_numpy(table), torch.from_numpy(idx_rows))
    assert float(got) == float(tool_indep(jnp.asarray(table), jnp.asarray(idx_rows)))


def test_harnesses_take_any_gather_function(data):
    """The harness result does not depend on which gather function computed
    the rows (what ``probe`` requires of kernel vs ``index_select``)."""
    table, idx0, idx_rows = (torch.from_numpy(a) for a in data)
    other = lambda t, i: t[i.long()]
    assert GP.chain(other, table, idx0, REPS, N_ROWS) == GP.chain(
        GP.gather_rows_plain, table, idx0, REPS, N_ROWS)
    assert GP.indep(other, table, idx_rows) == GP.indep(GP.gather_rows_plain, table, idx_rows)


def test_probe_table_and_batch_shapes():
    assert GP.TABLES == ((3680, 48), (458752, 128))
    assert GP.LANES == (8192, 2_073_600) and GP.WINDOWS == (4096, 16384, 65536)
    for _, width in GP.TABLES:
        assert (width * 4) % 16 == 0


# slice sizes that cut the 1024 x 8 test table (32-byte rows) into 32, 8 and
# 1 buckets
SLICES = {1024: 32, 4096: 8, 1 << 20: 1}


def _lists(idx0):
    rng = np.random.default_rng(2)
    return {
        "repeats": rng.integers(0, 64, LANES),
        "one_row": np.full(LANES, 5),
        "sorted": np.sort(idx0),
        "one_lane": idx0[:1],
        "ragged": idx0[:37],  # R not a multiple of any chunk (k..32)
    }


@pytest.mark.parametrize("slice_bytes", sorted(SLICES))
def test_bucket_order_is_a_stable_argsort_of_the_slices(data, slice_bytes):
    _, idx0, idx_rows = data
    shift = GP.slice_shift(N_ROWS, WIDTH, slice_bytes)
    assert (WIDTH * 4) << shift <= slice_bytes < (WIDTH * 4) << (shift + 1)
    assert GP.buckets(N_ROWS, WIDTH, N_ROWS, slice_bytes) == SLICES[slice_bytes]
    for idx in (idx0, idx_rows.reshape(-1), *_lists(idx0).values()):
        idx = idx.astype(np.int32)
        got = GP.bucket_order_plain(torch.from_numpy(idx), shift)
        assert n(got).tolist() == np.argsort(idx >> shift, kind="stable").tolist()


@pytest.mark.parametrize("name", ["repeats", "one_row", "sorted", "one_lane", "ragged"])
def test_gather_in_bucket_order_equals_xla_gather(data, name):
    table, idx0, _ = data
    idx = _lists(idx0)[name].astype(np.int32)
    R = idx.shape[0]
    # the XLA gather at the 64 lanes the file already compiles, then cut to R
    padded = np.zeros(LANES, np.int32)
    padded[:R] = idx
    want = np.asarray(_xla_gather(jnp.asarray(table), jnp.asarray(padded)))[:R]
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    for slice_bytes in SLICES:
        order = GP.bucket_order_plain(i, GP.slice_shift(N_ROWS, WIDTH, slice_bytes))
        got = GP.gather_in_order_plain(t, i, order)
        assert n(got).tobytes() == want.tobytes()
        assert torch.equal(got, GP.gather_rows_plain(t, i))


def test_slice_rule_on_the_probe_tables():
    """The small table fits one slice; the large one is cut into slices of
    at most SLICE_BYTES, bucketed only where the batch has a position per
    table row (the render tile's lanes), not at 8,192 lanes."""
    (n_small, w_small), (n_large, w_large) = GP.TABLES
    assert n_small * w_small * 4 <= GP.SLICE_BYTES
    for lanes in GP.LANES:
        assert GP.buckets(n_small, w_small, lanes) == 1
    shift = GP.slice_shift(n_large, w_large)
    assert (w_large * 4) << shift <= GP.SLICE_BYTES
    assert GP.buckets(n_large, w_large, GP.LANES[-1]) == -(-n_large >> shift) == 28
    assert GP.buckets(n_large, w_large, GP.LANES[0]) == 1
    # a huge table of narrow rows: slices grow so that at most MAX_BUCKETS remain
    assert GP.buckets(1 << 30, 4, 1 << 30) == GP.MAX_BUCKETS
