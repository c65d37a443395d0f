"""Where kernel K4 (``csrc/pairwise.cu``) spends its time, phase by phase, on one GPU.

    python3 tools/probe_pairwise_phases.py [--out build/pairwise_phases.json]

Builds a copy of ``csrc/pairwise.cu`` under ``build/probe_pairwise_phases/``
in which thread 0 of block (0, 0) reads the SM clock (``clock64``) at the
kernel's phase boundaries: the copies of the first STAGES - 1 k-tiles
issued; then per k-tile, the next tile's data landed (the wait and the
barrier), the next tile's rank-1 pass done, this tile's multiply (with the
copies of a later tile) done; the loop's end; the rank-1 terms reduced; the epilogue's
stores issued.  It runs the copy at 1 x 1000 and 64 x 1000 (the short tile)
and 1000 x 1000 (the tall one) on seeded inputs, checks each output against
the plain version, and prints one JSON object of cycles per phase (the
per-tile phases summed over the k-tiles) with the SM clock read after the
runs and the card's name and power limit, written to ``--out`` too.  Block
(0, 0) stands for the others, which run the same phases on other data.
Needs the CUDA toolkit and a CUDA device; the build flags are
``ops/native.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seam_match_rcnn_tpu_torch.ops import cuda_kernels, native  # noqa: E402
from seam_match_rcnn_tpu_torch.ops.pairwise import pairwise_match_scores  # noqa: E402

MAX_TILES = 9


def mark(i: str) -> str:
    return ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
            f"g_clock[{i}] = clock64();")


def instrumented(src: str) -> str:
    """``csrc/pairwise.cu`` with the clock reads; each anchor must exist once."""
    def put(s, anchor, new):
        if s.count(anchor) != 1:
            raise SystemExit(f"probe_pairwise_phases: anchor not found once: {anchor!r}")
        return s.replace(anchor, new)

    s = put(src, "namespace {\n", "namespace {\n__device__ long long g_clock[64];\n")
    s = put(s, "  const int KT = (C + BK - 1) / BK;\n",
            "  const int KT = (C + BK - 1) / BK;\n  " + mark("0") + "\n")
    s = put(s, "  // A thread with a few outputs keeps one sum",
            "  " + mark("1") + "\n  // A thread with a few outputs keeps one sum")
    s = put(s, "    __syncthreads();  // everyone's have",
            f"    __syncthreads();  if (kt < {MAX_TILES}) {{ {mark('2 + kt * 3')} }}"
            "  // everyone's have")
    s = put(s, "    const S& sl = slot[kt % STAGES];\n",
            f"    if (kt < {MAX_TILES}) {{ {mark('3 + kt * 3')} }}\n"
            "    const S& sl = slot[kt % STAGES];\n")
    s = put(s, "    cp_async_commit();\n  }\n  cp_async_wait<0>();\n",
            f"    if (kt < {MAX_TILES}) {{ {mark('4 + kt * 3')} }}\n    cp_async_commit();\n  }}\n"
            f"  {mark('40')}\n  cp_async_wait<0>();\n")
    s = put(s, "  const float c0 = b[1] - b[0];\n",
            "  " + mark("41") + "\n  const float c0 = b[1] - b[0];\n")
    s = put(s, "    }\n  }\n}\n\ntemplate <int BM, int BN, int STAGES>\nint launch(",
            "    }\n  }\n  " + mark("42") + "\n}\n\ntemplate <int BM, int BN, int STAGES>\n"
            "int launch(")
    return s + ('\nextern "C" int seam_probe_clocks(long long* out) {\n'
                "  return (int)cudaMemcpyFromSymbol(out, g_clock, 64 * sizeof(long long));\n}\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/pairwise_phases.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_pairwise_phases: no CUDA device")
    build = ROOT / "build" / "probe_pairwise_phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "pairwise_phases.cu"
    src.write_text(instrumented((native.CSRC / "pairwise.cu").read_text()))
    lib_path = build / "libpairwise_phases.so"
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC), "-shared",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.seam_pairwise_scores
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((2, 256), generator=gen, device=dev) * 0.05
    b = torch.randn(2, generator=gen, device=dev)
    gallery = torch.randn((1000, 256), generator=gen, device=dev)
    clocks = (ctypes.c_longlong * 64)()
    report = {"cases": []}
    for q in (1, 64, 1000):
        x = torch.randn((q, 256), generator=gen, device=dev)
        out = torch.empty((q, 1000), device=dev)
        rows = cuda_kernels.pairwise_tile_rows(q)
        for _ in range(3):  # the last launch is read, with its code and data warm
            native.check(fn(x.data_ptr(), gallery.data_ptr(), w.data_ptr(), b.data_ptr(),
                            out.data_ptr(), q, 1000, 256, rows, native.stream(dev)),
                         "pairwise_scores")
            torch.cuda.synchronize()
        err = float((out - pairwise_match_scores(x, gallery, w, b)).abs().max())
        native.check(lib.seam_probe_clocks(clocks), "seam_probe_clocks")
        t = [c - clocks[0] for c in clocks]
        bk = int(re.search(r"constexpr int BK = (\d+)", src.read_text()).group(1))
        tiles = min((256 + bk - 1) // bk, MAX_TILES)
        prev, phases = t[1], {"copies_issued": t[1], "wait_and_barrier": 0,
                              "rank1_next_tile": 0, "multiply_and_copies": 0}
        for kt in range(tiles):
            for name, i in (("wait_and_barrier", 2), ("rank1_next_tile", 3),
                            ("multiply_and_copies", 4)):
                phases[name] += t[i + kt * 3] - prev
                prev = t[i + kt * 3]
        phases["drain"] = t[40] - prev
        phases["rank1_reduce"] = t[41] - t[40]
        phases["epilogue"] = t[42] - t[41]
        report["cases"].append({"shape": f"{q}x1000", "tile_rows": rows, "max_abs_err": err,
                                "total_cycles": t[42], "cycles": phases})
    report["sm_clock_mhz_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(report)
    print(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")


if __name__ == "__main__":
    main()
