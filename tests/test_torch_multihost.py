"""Frames over hosts (parallel/multihost.py) through the port's demo,
``python -m pathtracing_tpu_torch.parallel.multihost_demo``, on the CPU: two
processes join one ``torch.distributed`` group (``gloo``, a coordinator on
127.0.0.1), sum one per process with an ``all_reduce``, take the golden
scene's frames round-robin and write them; the same frames rendered by one
process must be byte-identical. 64 x 36 x 2 spp x 4 frames (~30 s)."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_two_process_demo(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "pathtracing_tpu_torch.parallel.multihost_demo",
         "--device", "cpu", "--processes", "2", "--size", "64x36", "--spp", "2",
         "--frames", "4", "--out", str(tmp_path), "--timeout", "180"],
        cwd=str(ROOT), timeout=240, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    result = lines[-1]
    assert result["ok"] and result["exit_codes"] == [0, 0]
    assert result["missing"] == [] and result["differ_from_single"] == []
    hosts = sorted((x["host"], x["frames"]) for x in lines if "host" in x and
                   len(x["frames"]) == 2)
    assert hosts == [(0, [0, 2]), (1, [1, 3])]
    for f in range(4):
        blob = (tmp_path / f"frame_{f:04d}.bmp").read_bytes()
        assert blob == (tmp_path / "single" / f"frame_{f:04d}.bmp").read_bytes()
