"""Golden-image validator, CLI-compatible with the reference's validator.py
(reference: validator.py:15-70): per-frame PSNR of own frame_%04d.bmp
(downscaled 2x by local mean) against reference %04d.png, pass bar 32 dB,
writes validation_result.txt.

    python -m pathtracing_tpu_torch.validate REFERENCE_DIR OWN_DIR [--frames N]

Also doubles as the corruption/missing-frame detector for resumable runs.
The JAX package's ``validate.py``; PNG references are read with PIL,
imported only when a PNG is read.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

FRAME_COUNT = 1800
ACCEPT_MIN_PSNR = 32
RESIZE_FACTOR = 2


def downscale_local_mean(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    img = img[: h2 * factor, : w2 * factor].astype(np.float64)
    return img.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    if mse == 0:
        return float("inf")
    return 10 * np.log10(255.0**2 / mse)


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".bmp"):
        from pathtracing_tpu_torch.io.bmp import read_bmp

        return read_bmp(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("reference_dir")
    ap.add_argument("own_dir")
    ap.add_argument("--frames", type=int, default=FRAME_COUNT)
    ap.add_argument("--min-psnr", type=float, default=ACCEPT_MIN_PSNR)
    ap.add_argument("--allow-missing-reference", action="store_true")
    args = ap.parse_args(argv)

    lines = []
    success = True
    sum_psnr = 0.0
    min_psnr = 1000.0
    max_psnr = 0.0
    compared = 0
    for i in range(args.frames):
        name = f"{i:04d}"
        ref_path = os.path.join(args.reference_dir, f"{name}.png")
        own_path = os.path.join(args.own_dir, f"frame_{name}.bmp")
        report = f"{name}: "
        if not os.path.exists(ref_path):
            if args.allow_missing_reference:
                continue
            print("Reference files are incomplete, quitting!!!")
            print(f"{ref_path} is missing.")
            return 1
        if not os.path.exists(own_path):
            report += "(missing image)"
            success = False
        else:
            ref_img = _read_image(ref_path)
            own_img = downscale_local_mean(
                _read_image(own_path), RESIZE_FACTOR
            ).astype(np.uint8)
            p = psnr(ref_img, own_img)
            sum_psnr += p
            min_psnr = min(min_psnr, p)
            max_psnr = max(max_psnr, p)
            compared += 1
            report += str(p)
            if p < args.min_psnr:
                success = False
                report += " BAD, BROKEN IMAGE?"
            else:
                report += " GOOD"
        lines.append(report)
        print(report)

    outcome = (
        "Validation result: successful.\n"
        if success
        else "Validation result: failure.\n"
    )
    outcome += f"Sum PSNR: {sum_psnr}\n"
    outcome += f"Min PSNR: {min_psnr}\n"
    outcome += f"Max PSNR: {max_psnr}\n"
    print(outcome)
    with open("validation_result.txt", "w") as f:
        f.write("\n".join(lines) + "\n" + outcome)
    return 0 if success else 1


if __name__ == "__main__":
    sys.exit(main())
