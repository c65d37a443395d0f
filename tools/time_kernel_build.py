"""Time the port's kernel build two ways, each from nothing in a fresh
directory under build/:

* one ``nvcc`` call over every ``csrc/*.cu``, which compiles the sources
  one after the other;
* ``ops/native.build``: one ``nvcc`` process per source, all started
  together, then a link.

    python3 tools/time_kernel_build.py [--repeat 2]

Needs the CUDA toolkit (no card).  The two builds alternate in order from
one repeat to the next.  Prints one JSON object with the host's CPU count
and every build time in seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seam_match_rcnn_tpu_torch.ops import native  # noqa: E402


def one_call(out_dir: Path) -> None:
    units = [str(s) for s in native._sources() if s.suffix == ".cu"]
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "libone.so"), *units], check=True, capture_output=True)


def parallel(out_dir: Path) -> None:
    native.BUILD_DIR = out_dir
    native.build()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    ways = {"one_call_s": one_call, "parallel_s": parallel}
    times = {k: [] for k in ways}
    for rep in range(args.repeat):
        for name in (list(ways) if rep % 2 == 0 else list(ways)[::-1]):
            out_dir = ROOT / "build" / "time_kernel_build" / f"{name}{rep}"
            shutil.rmtree(out_dir, ignore_errors=True)
            out_dir.mkdir(parents=True)
            t0 = time.perf_counter()
            ways[name](out_dir)
            times[name].append(round(time.perf_counter() - t0, 3))
    shutil.rmtree(ROOT / "build" / "time_kernel_build", ignore_errors=True)
    print(json.dumps({"cpus": os.cpu_count(), "sources": len(
        [s for s in native._sources() if s.suffix == ".cu"]), **times}))


if __name__ == "__main__":
    main()
