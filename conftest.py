"""Time limits and the ``slow`` selection for the test suite under ``tests/``.

Every test under ``tests/`` runs its setup and call under a time limit: a
``SIGALRM`` handler fails the test where it stands, so a Python-level wait (a
child process, a queue, a sleep) ends as an ordinary failure and the run goes
on; code stuck inside a native call fails when it returns to Python. A test
names its own limit with ``@pytest.mark.limit(seconds)``, or through
``LIMITS`` below where its file is one of the JAX reference package's.

``slow`` marks the JAX reference package's slowest tests, listed in ``SLOW``:
the tier-1 run leaves them out (``-m 'not slow'``), ``-m slow`` runs only them.
Tests of other directories (``benchmark/tests``) are left as they are.
"""

import pathlib
import signal

import pytest

ROOT = pathlib.Path(__file__).resolve().parent
TESTS = ROOT / "tests"

# Seconds a test's setup and call may take together (a module fixture's cost
# falls on the test that first asks for it): about 3x the slowest tier-1 test
# of the JAX package (121 s with 7 workers busy), capped at 300 s. A slow test
# gets about 3x the slowest of them (924-1004 s).
DEFAULT_LIMIT_S = 300
SLOW_LIMIT_S = 3000

# The JAX package's tests that take over 125 s each, a module fixture's cost
# counted against the tests that use it (test_diff.py's ``loss_and_grads``).
SLOW = frozenset({
    "test_adaptive.py::test_equal_budget_lower_error",
    "test_arealights.py::test_cornell_variance_reduction",
    "test_arealights.py::test_unbiased_vs_bsdf_only",
    "test_diff.py::test_gradients_finite",
    "test_diff.py::test_grad_matches_finite_difference[sf_cam-0.0001-0.15]",
    "test_diff.py::test_grad_matches_finite_difference[sf_light-0.001-0.08]",
    "test_diff.py::test_grad_matches_finite_difference[tri_pos-0.001-0.15]",
    "test_diff.py::test_grad_matches_finite_difference[vattr-0.001-0.08]",
    "test_diff.py::test_inverse_pose_converges",
    "test_diff.py::test_inverse_rendering_converges",
    "test_diff_fast.py::test_fast_grads_match_slow[False]",
    "test_diff_fast.py::test_fast_grads_match_slow[True]",
    "test_diff_fast.py::test_frame_fast_grads_match_slow",
    "test_megakernel.py::test_megakernel_sample_base_and_period",
    "test_parallel.py::test_sharded_fast_grad_matches",
    "test_parallel.py::test_sharded_grad_matches_single_device[2-4-False]",
    "test_parallel.py::test_sharded_grad_matches_single_device[4-2-True]",
})

# Limits of the JAX package's tests that need more than the default: the
# full-scene parity test waits up to 1800 s on the reference binary and the
# JAX render of the whole scene (it skips without the reference data).
LIMITS = {
    "test_full_scene_parity.py::test_frame0_matches_reference_binary": 1900,
}

_PREVIOUS_HANDLER = pytest.StashKey()


def _key(item) -> str | None:
    """``file::name`` of a test under ``tests/``, None elsewhere."""
    if item.path.parent != TESTS:
        return None
    return f"{item.path.name}::{item.name}"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: a test of the JAX reference package too slow for the tier-1 "
        "run (-m 'not slow'); run these with -m slow",
    )
    config.addinivalue_line(
        "markers",
        "limit(seconds): this test's time limit for setup and call, in place "
        f"of the default {DEFAULT_LIMIT_S} s ({SLOW_LIMIT_S} s for a slow test)",
    )
    if not hasattr(config, "workerinput") and _runs_tests(config):
        _build_native_libraries()


def _runs_tests(config) -> bool:
    """Whether this session collects from ``tests/`` of a checkout that holds
    the JAX package."""
    if not (ROOT / "pathtracing_tpu").is_dir():
        return False
    for arg in config.args:
        path = (config.invocation_params.dir / arg.split("::")[0]).resolve()
        if path == TESTS or TESTS in path.parents or path in TESTS.parents:
            return True
    return False


def _build_native_libraries():
    """Build the JAX package's native libraries once, before xdist starts
    its workers. Each worker would otherwise compile them straight to their
    final paths under ``build/native/``, and a worker that loads one while
    another writes it fails ("file too short")."""
    from pathtracing_tpu.accel import native
    from pathtracing_tpu.io import native_loader

    native.get_lib()
    native.get_wide_lib()
    native_loader._get_lib()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Mark the tests of ``SLOW`` before ``-m`` selects."""
    for item in items:
        if _key(item) in SLOW:
            item.add_marker(pytest.mark.slow)


def _limit_of(item) -> float:
    mark = item.get_closest_marker("limit")
    if mark:
        return float(mark.args[0])
    if _key(item) in LIMITS:
        return float(LIMITS[_key(item)])
    if item.get_closest_marker("slow"):
        return float(SLOW_LIMIT_S)
    return float(DEFAULT_LIMIT_S)


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    """Arm the test's time limit."""
    if _key(item) is not None:
        limit = _limit_of(item)

        def on_alarm(signum, frame):
            pytest.fail(
                f"{item.nodeid} ran past its time limit of {limit:g} s "
                "(setup and call)"
            )

        item.stash[_PREVIOUS_HANDLER] = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, limit)
    yield


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_teardown(item):
    if _PREVIOUS_HANDLER in item.stash:
        signal.setitimer(signal.ITIMER_REAL, 0)
        previous = item.stash[_PREVIOUS_HANDLER]
        signal.signal(signal.SIGALRM,
                      signal.SIG_DFL if previous is None else previous)
        del item.stash[_PREVIOUS_HANDLER]
    yield
