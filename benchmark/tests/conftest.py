"""Tests of the benchmark's harness and plain reference, on the CPU at tiny
sizes (``python -m pytest benchmark/tests -q`` from the checkout's root).
Tests that need a CUDA device carry the ``chip`` marker and skip without
one; the decision is made inside the fixture, never at import time."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (the H100 the benchmark runs on)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda")


def tiny_cell(name, width=16, height=9, spp=2, pixels=6):
    """A cell of BENCHMARK.json cut to a CPU test's size."""
    from benchmark.harness import spec

    cell = spec.find_cell(name)
    cell.config["render"].update(image_width=width, image_height=height)
    if cell.config["scene"] == "animation":
        cell.config["render"]["samples_per_pixel"] = spp
    cell.traffic["samples"]["spp"] = min(cell.traffic["samples"]["spp"], spp)
    cell.traffic["check"]["pixels"] = pixels
    return cell
