"""The per-test time limit and the ``slow`` selection of the repo's root
``conftest.py``.

A small pytest session in a child process runs under a copy of that conftest
and three tests under a 1 s limit: one sleeps past it, one waits past it on a
child process of its own, one ends in time. The first two fail with the
limit's message, the third passes, and the session reaches its end long before
the sleeps would have.
"""

import importlib.util
import pathlib
import shutil
import subprocess
import sys
import time

TESTS = pathlib.Path(__file__).resolve().parent
ROOT_CONFTEST = TESTS.parent / "conftest.py"

INNER = '''
import subprocess
import sys
import time

import pytest


@pytest.mark.limit(1)
def test_sleeps_past():
    time.sleep(60)


@pytest.mark.limit(1)
def test_waits_on_child_past():
    subprocess.run([sys.executable, "-c", "import time; time.sleep(60)"])


@pytest.mark.limit(1)
def test_in_time():
    time.sleep(0.1)
'''


def _pytest(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *args],
        cwd=str(cwd), capture_output=True, text=True, timeout=120,
    )


def test_limit_fails_late_tests_and_the_run_goes_on(tmp_path):
    shutil.copy(ROOT_CONFTEST, tmp_path / "conftest.py")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_inner.py").write_text(INNER)
    start = time.monotonic()
    r = _pytest(["-q", "tests/test_inner.py"], tmp_path)
    seconds = time.monotonic() - start
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    assert "2 failed, 1 passed" in out, out
    for name in ("test_sleeps_past", "test_waits_on_child_past"):
        assert (f"tests/test_inner.py::{name} ran past its time limit of 1 s"
                in out), out
    assert seconds < 45, (seconds, out)


def test_slow_selects_exactly_the_listed_jax_reference_tests():
    """``-m slow`` collects the root conftest's ``SLOW`` list and nothing
    else, all in files that import nothing of the port: the port's tests all
    stay in the tier-1 run."""
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT_CONFTEST)
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    r = _pytest(["--collect-only", "-q", "-m", "slow", "tests/"], TESTS.parent)
    assert r.returncode == 0, r.stdout + r.stderr
    selected = {line.removeprefix("tests/") for line in r.stdout.splitlines()
                if "::" in line}
    assert selected == set(root_conftest.SLOW), r.stdout
    for name in {key.split("::")[0] for key in selected}:
        assert not name.startswith("test_torch_"), name
        assert "pathtracing_tpu_torch" not in (TESTS / name).read_text(), name
