"""The one traffic generator, and the closed loop that drives the system.

A traffic mix is data (``benchmark/traffic/<name>.json``):

  frames    a list of frame indices: request i renders
            frames[(seed + i) % len(frames)] ([0]: one frame, a static scene)
  samples   {"spp", "ranges"}: request i renders samples
            [spp * r, spp * (r + 1)) of every pixel, with
            r = (seed + i) % ranges (ranges 1: samples [0, spp))
  clients   1: one client, the next request issued when the last one's
            BGRA bytes are on the host (a closed loop)
  pipeline  true: the tables of request i + 1 are prepared on a worker
            thread while request i renders (the CLI's frame loop)
  check     {"pixels": n}: pixels of each request kept for the output check

Every seed gives the same work in another order: a window runs through the
same cycle of frames or sample ranges from a place the seed picks, and the
seed picks the pixels it checks.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    frame: int
    sample_base: int
    spp: int


def request(traffic: dict, seed: int, i: int) -> Request:
    fr, sm = traffic["frames"], traffic["samples"]
    frame = fr[(seed + i) % len(fr)]
    r = (seed + i) % sm["ranges"]
    return Request(i, frame, sm["spp"] * r, sm["spp"])


def check_pixels(seed: int, req: Request, n_pixels: int, n: int) -> np.ndarray:
    """The pixels of ``req`` the output check compares, drawn from the seed."""
    s = seed % (1 << 64)
    g = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, req.index % (1 << 32)])
    return np.sort(g.choice(n_pixels, size=min(n, n_pixels), replace=False))


@dataclasses.dataclass
class Done:
    """A finished request: its times and the pixels kept for the check."""

    req: Request
    issued: float
    done: float
    samples: int
    pixels: np.ndarray
    colors: np.ndarray   # (n, 3) float32
    bgra: np.ndarray     # (n, 4) uint8

    @property
    def latency(self) -> float:
        return self.done - self.issued


class ClosedLoop:
    """One client: prepare, render, keep the checked pixels, repeat."""

    def __init__(self, system, traffic: dict, seed: int, rec):
        if traffic.get("clients", 1) != 1:
            raise ValueError("the closed loop drives one client")
        self.system = system
        self.traffic = traffic
        self.seed = seed
        self.rec = rec
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="setup") \
            if traffic.get("pipeline", False) else None
        self.next = None
        self.n_check = traffic["check"]["pixels"]

    def _prepare_async(self, i: int):
        req = request(self.traffic, self.seed, i)
        if self.pool is None:
            return req, None
        return req, self.pool.submit(self.system.prepare, req)

    def _tables(self, req, fut):
        with self.rec.span("setup_wait", req.index):
            return fut.result() if fut is not None else self.system.prepare(req)

    def warm(self) -> None:
        """One request of the cell's own shapes (request -1), and request
        0's tables prepared, as in the steady state."""
        req, fut = self._prepare_async(-1)
        tables = self._tables(req, fut)
        self.next = self._prepare_async(0)
        self.system.render(req, tables)

    def run(self, seconds: float) -> tuple[list[Done], float, float]:
        """Requests from 0 until ``seconds`` have passed; each that starts
        before then runs to its end. Returns (done, window start, window
        end)."""
        if self.next is None:
            self.next = self._prepare_async(0)
        W = self.system.cfg.image_width
        H = self.system.cfg.image_height
        out = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            issued = time.perf_counter()
            req, fut = self.next
            tables = self._tables(req, fut)
            self.next = self._prepare_async(i + 1)
            colors, image = self.system.render(req, tables)
            done = time.perf_counter()
            px = check_pixels(self.seed, req, W * H, self.n_check)
            out.append(Done(req, issued, done, W * H * req.spp, px,
                            colors.reshape(-1, 3)[px].copy(),
                            image.reshape(-1, 4)[px].copy()))
            i += 1
        return out, t0, out[-1].done if out else time.perf_counter()

    def close(self) -> None:
        """Wait for the worker's last preparation and stop the worker."""
        if self.next is not None and self.next[1] is not None:
            self.next[1].result()
        self.next = None
        if self.pool is not None:
            self.pool.shutdown(wait=True)
