"""The system under test: the PyTorch and CUDA port, driven through its
public entry points. The program is imported when a run starts, never at
import time, and only here and in the modules this one finds by name.

A configuration names its scene (``scene``) and render settings
(``render``); a traffic mix names its route into the renderer (``route``):

  entry        the call that renders a request: ``routes/<entry>.py``
  tables       the packing of the scene's tables: ``tables/<tables>.py``
  write_bmp    write each frame's BGRA image, as the CLI does

The scene is ``scenes/<scene>.py``: its loader loads the scene and packs
what does not change between frames, and ``prepare`` gives the tables of
one request (for the animated scene the CLI's frame set-up, which the loop
runs on a worker thread for frame N+1 while frame N renders).
"""

from __future__ import annotations

import os
import tempfile

from benchmark.harness import spec


class System:
    def __init__(self, config: dict, traffic: dict, device, rec, data_dir: str,
                 bench_dir=spec.BENCH_DIR):
        import torch

        from pathtracing_tpu_torch.config import RenderConfig

        self.cfg = RenderConfig(**config["render"])
        self.route = traffic["route"]
        self.device = torch.device(device)
        self.rec = rec
        self.data_dir = data_dir
        self.scene = spec.find_module("scenes", config["scene"], bench_dir)
        self.entry = spec.find_module("routes", self.route["entry"], bench_dir)
        self.tables = spec.find_module("tables", self.route["tables"], bench_dir)
        self.program = None
        self.bmp_path = os.path.join(tempfile.gettempdir(), "bench_frame.bmp")

    def load(self) -> None:
        """Load the scene and pack what does not change between frames."""
        self.program = self.scene.Program(self.cfg, self.tables, self.data_dir,
                                          self.device, self.rec)

    def prepare(self, req):
        """The device tables that ``req`` renders from."""
        return self.program.prepare(req)

    def render(self, req, tables):
        """(colours (H, W, 3) float32, BGRA (H, W, 4) uint8) on the host."""
        with self.rec.span("render_entry", req.index):
            colors, image = self.entry.render(self.cfg, tables, req, self.route, self.device)
        if self.route.get("write_bmp", False):
            from pathtracing_tpu_torch.io.bmp import write_bmp

            with self.rec.span("write_bmp", req.index):
                write_bmp(self.bmp_path, image)
        return colors, image

    def launches(self) -> int:
        """Launches of the route's path kernel since the last reset."""
        return self.entry.counter(self.route).launches

    def reset_launches(self) -> None:
        self.entry.counter(self.route).reset_launches()

    def close(self) -> None:
        """Drop every device table of the program."""
        self.program = None
        if os.path.exists(self.bmp_path):
            os.remove(self.bmp_path)
