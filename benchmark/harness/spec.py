"""What a run measures, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics. Everything that belongs to one
configuration, one traffic mix or one per-layer metric lies in a file of its
own, found by that name:

    benchmark/configs/<config>.json     the scene and its render settings
    benchmark/traffic/<traffic>.json    the loop: what each request renders
    benchmark/limits/<cell>.json        the limits of the output check
    benchmark/metrics/<metric>.py       a reader: read(run) -> number | None
    benchmark/scenes/<scene>.py         a configuration's scene: its inputs,
                                        the program's loader, the reference's
                                        frames
    benchmark/routes/<entry>.py         a mix's call into the renderer and
                                        the kernel counter it checks
    benchmark/tables/<tables>.py        a mix's packing of the tables

A later cell, mix or metric is added as new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: pathlib.Path = BENCH_DIR


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, bench_dir=BENCH_DIR) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its files read."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    bench_dir = pathlib.Path(bench_dir)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    # a per-layer metric without a list is read wherever its end-to-end
    # metric is reported
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        bench_dir=bench_dir,
    )


_MODULES = {}


def find_module(kind: str, name: str, bench_dir=BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark (kind: ``metrics``,
    ``scenes``, ``routes`` or ``tables``), loaded once. An unknown name
    raises ValueError."""
    path = (pathlib.Path(bench_dir) / kind / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            known = sorted(p.stem for p in path.parent.glob("[!_]*.py"))
            raise ValueError(f"no {kind} module {name!r}; there are {known}")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metric_reader(name: str, bench_dir=BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    return find_module("metrics", name, bench_dir).read
