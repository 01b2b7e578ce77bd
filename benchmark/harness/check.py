"""The output check: what the timed path produced against the plain
reference (``benchmark/reference``), on the pixels the seed picked.

For every request of the window, the harness kept the colours and BGRA
bytes of some pixels. The reference builds the scene again from the
benchmark's input files (by the scene module's ``reference``: animation,
placement and all), traces the same
samples of those pixels and averages them. Two numbers are compared, each
with its limit (``benchmark/limits/<cell>.json``):

  far_pct       the share of checked colour channels (in %) whose gap to
                the reference exceeds 2e-4 + 2e-4 * |reference|
  bgra_far      the checked BGRA bytes more than 1 apart from the
                reference's tonemap of the program's own colours

The control puts the reference itself, computed in bfloat16, in the
program's place (``control``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ATOL = RTOL = 2e-4


def bf16(t):
    """Round a float32 tensor to bfloat16 and back: the control's
    precision."""
    import torch

    return t.to(torch.bfloat16).to(torch.float32)


@dataclasses.dataclass
class Reference:
    """The reference's view of a cell: its scene, rendered on request."""

    config: dict
    data_dir: str
    device: object
    lowp: object = None
    bench_dir: object = None

    def __post_init__(self):
        from benchmark.harness import spec
        from benchmark.reference.config import RenderConfig

        self.cfg = RenderConfig(**self.config["render"])
        scene = spec.find_module("scenes", self.config["scene"],
                                 self.bench_dir or spec.BENCH_DIR)
        self._build = scene.reference(self.cfg, self.data_dir, self.device, lowp=self.lowp)
        self._frames = {}
        self.frame_bytes = {}  # frame -> bytes of its tables

    def frame(self, index: int):
        """The tables of frame ``index`` (the last one built is kept)."""
        import torch

        if index not in self._frames:
            fr = self._build(index)
            self._frames = {index: fr}
            self.frame_bytes[index] = sum(v.numel() * v.element_size()
                                          for v in vars(fr).values()
                                          if isinstance(v, torch.Tensor))
        return self._frames[index]

    def colors(self, items, counts=None):
        """(sum of pixels, 3) float32 on the host: the reference's average
        of each item's samples at its kept pixels, items in order."""
        import torch

        from benchmark.reference.integrator import render_pixels

        W = self.cfg.image_width
        by_frame = {}
        for k, it in enumerate(items):
            by_frame.setdefault(it.req.frame, []).append(k)
        res = [None] * len(items)
        for f, ks in by_frame.items():
            fr = self.frame(f)
            spps = {items[k].req.spp for k in ks}
            for spp in spps:
                kk = [k for k in ks if items[k].req.spp == spp]
                px = np.concatenate([items[k].pixels for k in kk]).astype(np.int32)
                base = np.concatenate([np.full(len(items[k].pixels), items[k].req.sample_base,
                                               np.int32) for k in kk])
                t = lambda a: torch.from_numpy(a).to(self.device)
                c = render_pixels(self.cfg, fr, t(px % W), t(px // W), t(base), spp,
                                  counts=counts, lowp=self.lowp).cpu().numpy()
                a = 0
                for k in kk:
                    n = len(items[k].pixels)
                    res[k] = c[a:a + n]
                    a += n
        return np.concatenate(res) if res else np.zeros((0, 3), np.float32)

    def bgra(self, colors: np.ndarray) -> np.ndarray:
        """The reference's tonemap of (n, 3) colours: (n, 4) uint8 BGRA."""
        import torch

        from benchmark.reference.tonemap import tonemap
        from benchmark.reference.vec import Vec3

        c = torch.from_numpy(np.ascontiguousarray(colors, np.float32)).to(self.device)
        b, g, r, a = tonemap(Vec3(c[:, 0], c[:, 1], c[:, 2]))
        return torch.stack([b, g, r, a], -1).cpu().numpy()


def compare(colors: np.ndarray, bgra: np.ndarray, ref_colors: np.ndarray,
            ref_bgra_of_colors: np.ndarray) -> dict:
    """The numbers compared: far_pct and bgra_far (see the module)."""
    gap = np.abs(colors.astype(np.float64) - ref_colors.astype(np.float64))
    bar = ATOL + RTOL * np.abs(ref_colors.astype(np.float64))
    far = ~(gap <= bar)  # a NaN on either side is far
    byte_gap = np.abs(bgra.astype(np.int16) - ref_bgra_of_colors.astype(np.int16))
    return {
        "far_pct": float(100.0 * far.mean()) if far.size else 100.0,
        "bgra_far": int((byte_gap > 1).sum()),
    }


def judge(numbers: dict, limits: dict) -> bool:
    """Whether every number is within its limit."""
    return all(v <= limits[k]["limit"] for k, v in numbers.items())


def far_entries(items, colors, ref_colors, top: int = 8) -> list[str]:
    """The checked channels past the bar, farthest first: request, frame,
    pixel, channel, the program's value and the reference's."""
    gap = np.abs(colors.astype(np.float64) - ref_colors.astype(np.float64))
    rel = gap / (ATOL + RTOL * np.abs(ref_colors.astype(np.float64)))
    owner = np.concatenate([np.full(len(it.pixels), k) for k, it in enumerate(items)])
    pixel = np.concatenate([it.pixels for it in items])
    out = []
    for flat in np.argsort(-np.nan_to_num(rel, nan=np.inf), axis=None)[:top]:
        i, c = divmod(int(flat), 3)
        if not rel[i, c] > 1:
            break
        it = items[owner[i]]
        out.append(f"far request {it.req.index} frame {it.req.frame} pixel {pixel[i]} "
                   f"channel {c} program {colors[i, c]!r} reference {ref_colors[i, c]!r}")
    return out


def check_window(ref: Reference, items, counts=None) -> tuple[dict, list[str]]:
    """The numbers of a window's kept pixels against the reference, and the
    channels past the bar."""
    colors = np.concatenate([it.colors for it in items])
    bgra = np.concatenate([it.bgra for it in items])
    rc = ref.colors(items, counts=counts)
    return compare(colors, bgra, rc, ref.bgra(colors)), far_entries(items, colors, rc)


def control(ref: Reference, low: Reference, items) -> dict:
    """The control's numbers: the reference computed in bfloat16 in the
    program's place, against the reference."""
    rc = ref.colors(items)
    lc = low.colors(items)
    return compare(lc, low.bgra(lc), rc, ref.bgra(lc))
