"""The output check's control, and the readings its limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 --requests 14

For each seed, the requests a run of the cell would make (``--requests`` of
them, the pixels the seed picks) are rendered by the plain reference twice:
in float32, and in bfloat16 (``check.bf16``: its tables and its path state
rounded at every bounce) in the program's place. It prints, per seed, the
numbers the check compares for the bfloat16 control against the float32
reference: the control's reading, which has to fail the cell's limit. Runs
on the card; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import torch

    from benchmark.harness import check as chk
    from benchmark.harness import loops, spec
    from benchmark.harness.main import data_dir

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)

    cell = spec.find_cell(args.workload)
    dev = torch.device("cuda")
    ddir = data_dir(cell.config)
    ref = chk.Reference(cell.config, ddir, dev)
    low = chk.Reference(cell.config, ddir, dev, lowp=chk.bf16)
    W = cell.config["render"]["image_width"]
    H = cell.config["render"]["image_height"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        items = []
        for i in range(args.requests):
            req = loops.request(cell.traffic, seed, i)
            px = loops.check_pixels(seed, req, W * H, cell.traffic["check"]["pixels"])
            items.append(loops.Done(req, 0.0, 0.0, 0, px, None, None))
        numbers = chk.control(ref, low, items)
        limits = {k: cell.limits[k]["limit"] for k in numbers}
        print(json.dumps({"workload": cell.name, "seed": seed, "control": numbers,
                          "limits": limits, "fails": not chk.judge(numbers, cell.limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
