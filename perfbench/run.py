"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell's model with weights drawn on the device from the seed,
warms up the cell's own shapes (set-up), measures for `--seconds`, checks
what the timed path produced against the reference, and prints, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks` (each compared number with its limit; also the last lines of
standard error). Earlier lines carry details: launch counts, the open
loop's lateness, the reference's readings.

Exits non-zero with no result line when no CUDA card is present (or fewer
than the cell asks for), when the measured package is missing, or when
JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
# every kernel and compile cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "datr_tpu"}


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & BANNED)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from perfbench.core import cell

    spec = cell.load(args.workload)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 3
    lib = ROOT / "build" / "datr_torch" / "libdatr_torch_kernels.so"
    print(json.dumps({"kernel_library_built_before": lib.exists()}),
          flush=True)
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"perfbench: this process loaded {found}", file=sys.stderr)
        return 4
    line, checks = cell.result_line(spec, result, bool(args.trace),
                                    torch.device("cuda", 0))
    for d in result.get("details", []):
        print(json.dumps(d), flush=True)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
