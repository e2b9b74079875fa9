"""The readings that the cells' limits are set from, many seeds in one
process (set-up is paid once for the imports and the kernel library):

    python -m perfbench.core.calibrate --workload <cell> \\
        --seeds 11,12,13 [--seconds 4] [--control] [--fault <name>]

Without `--control`: the program's own runs, each a short window and the
cell's check (the lower readings). With `--control`: the cell's driver's
`control`, the reference in the program's place in TF32, the nearest
precision below the configurations' f32 with TF32 off, judged by the f32
reference exactly as the program is (the upper readings). `--fault`: the
program with a fault planted under the timed path (train: half_batch,
state_unchanged; serve: altered_answer). One JSON line per seed.

    python -m perfbench.core.calibrate --workload c2f_r50.serve_open \\
        --seeds 5 --rates 8,10,12,14 --seconds 20

sweeps an open-loop cell's arrival rate on one server (its driver's
`sweep`); one JSON line per rate.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def main(argv=None):
    from . import cell as cells
    from . import spec as specs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rates", default=None)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    spec = cells.load(args.workload)
    driver = specs.driver(spec["cell"]["driver"])
    if args.rates:
        driver.sweep(spec, int(args.seeds.split(",")[0]),
                     [float(r) for r in args.rates.split(",")],
                     args.seconds, device)
        return 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.control:
            checks = driver.control(spec, seed, device)
        else:
            res = cells.run(spec, seed, args.seconds, False, device, t,
                            fault=args.fault)
            checks = res["checks"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
