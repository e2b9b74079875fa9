"""Stage a dataset tree onto fast local disk before training (the port's
own copy of tools/stage_data.py: pure Python, no JAX).

Capability match for the reference's `preparing_dataset`
(datasets/data_util.py:117-169 + util/static_data_path.py): it copies / unzips
dataset artifacts from a shared source onto node-local storage on rank 0,
keyed by a machine-specific static path table. Here the same staging is a
standalone tool with explicit paths (no hardcoded table), suitable for
copying from slow shared storage (NFS/FUSE-mounted buckets) onto a GPU
node's local SSD before pointing `--data_root` at it.

Usage:
  python -m datr_torch.tools.stage_data SRC DST [--unzip] [--overwrite]

- SRC a directory: recursively copied to DST (skips files that already
  exist with the same size, so re-staging is incremental).
- SRC a .zip: extracted under DST (--unzip implied).
- Prints a one-line JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import zipfile


def stage_tree(src: str, dst: str, overwrite: bool = False):
    """Copy the tree `src` into `dst`, skipping files already there with
    the same size. Returns (copied, skipped)."""
    copied = skipped = 0
    for root, _dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        out_dir = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(out_dir, exist_ok=True)
        for f in files:
            s = os.path.join(root, f)
            d = os.path.join(out_dir, f)
            if (not overwrite and os.path.exists(d)
                    and os.path.getsize(d) == os.path.getsize(s)):
                skipped += 1
                continue
            shutil.copyfile(s, d)
            copied += 1
    return copied, skipped


def stage_zip(src: str, dst: str):
    """Extract the zip archive `src` under `dst`. Returns its entries."""
    os.makedirs(dst, exist_ok=True)
    with zipfile.ZipFile(src) as z:
        z.extractall(dst)
        return len(z.namelist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--unzip", action="store_true",
                    help="treat SRC as a zip archive (implied by .zip)")
    ap.add_argument("--overwrite", action="store_true",
                    help="copy even when an identically-sized file exists")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.unzip or args.src.endswith(".zip"):
        n = stage_zip(args.src, args.dst)
        summary = {"mode": "unzip", "files": n}
    else:
        copied, skipped = stage_tree(args.src, args.dst, args.overwrite)
        summary = {"mode": "copy", "copied": copied, "skipped": skipped}
    summary["seconds"] = round(time.time() - t0, 2)
    summary["dst"] = args.dst
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
