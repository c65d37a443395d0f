"""K1's numerics on one GPU: how far the tensor-core stem lands from its plain
version (cuDNN's f32 conv) and from the exactly summed stem, with and
without the kernel's recompute of the conv values whose f32 sums cancel.

    python3 tools/probe_stem_numerics.py [--out build/probe_stem_numerics.json]

Builds ``csrc/stem.cu`` twice into libraries of its own under
``build/probe_stem/``: as it is, and with ``REDO_EXP`` so low that no value
is recomputed (all sums on the tensor cores).  On the inputs of the card
test ``test_stem_kernel_matches_plain`` (seed H, weights x 0.2, shift
N(0, 1)) and on ``chip_smoke.py``'s K1 input, counts the values more than
one bf16 ulp from the plain version (the card test's rule) and from the
exact stem (the conv summed in f64 and rounded once to f32, then the f32
shift, relu, max and bf16), and times both builds at [11, 3, 800, 1344]
(CUDA-event median of 20).  Prints one JSON object (with the card's name
and power limit) and writes it to ``--out``.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seam_match_rcnn_tpu_torch.ops import cuda_stem, native  # noqa: E402

CASES = ((1, 64, 96), (2, 200, 336), (1, 68, 100), (1, 800, 1344))


def build(tag: str, redo_exp: int) -> ctypes.CDLL:
    out = ROOT / "build" / "probe_stem"
    out.mkdir(parents=True, exist_ok=True)
    src = (native.CSRC / "stem.cu").read_text()
    src, n = re.subn(r"constexpr int REDO_EXP = -?\d+;", f"constexpr int REDO_EXP = {redo_exp};",
                     src)
    assert n == 1, "REDO_EXP not found in stem.cu"
    cu, lib = out / f"stem_{tag}.cu", out / f"libstem_{tag}.so"
    cu.write_text(src)
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC), "-shared",
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.seam_stem_forward.argtypes = native._SIGNATURES["seam_stem_forward"]
    dll.seam_stem_forward.restype = ctypes.c_int
    return dll


def run(dll, x, cw, sc, sh):
    wf, bias = cuda_stem.fold_stem_weights(cw, sc, sh)
    wt = F.pad(wf.reshape(64, cuda_stem.STEM_TAPS),
               (0, cuda_stem.STEM_WEIGHT_ROW - cuda_stem.STEM_TAPS))
    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 4, w // 4), dtype=torch.bfloat16, device=x.device)
    status = dll.seam_stem_forward(x.data_ptr(), wt.data_ptr(), bias.contiguous().data_ptr(),
                                   out.data_ptr(), b, h, w, int(x.dtype == torch.float32), 0,
                                   native.stream(x.device))
    assert status == 0, status
    return out


def exact_stem(x, cw, sc, sh):
    wf, bias = cuda_stem.fold_stem_weights(cw, sc, sh)
    y = F.conv2d(x.to(torch.bfloat16).double(), wf.double(), stride=2, padding=3).float()
    y = F.relu(y + bias[None, :, None, None])
    return F.max_pool2d(y, 3, stride=2, padding=1).to(torch.bfloat16)


def beyond_ulp(got, ref) -> int:
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    return int(((got - ref).abs() > ulp).sum())


def inputs(dev):
    for b, h, w in CASES:
        rng = np.random.RandomState(h)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        x = t(rng.randn(b, 3, h, w))
        cw = t(rng.randn(64, 3, 7, 7) * 0.2)
        yield f"card test {b}x3x{h}x{w}", (x, cw, t(0.5 + rng.rand(64)), t(rng.randn(64)))
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    yield "chip_smoke 11x3x800x1344", (t(rng.randn(11, 3, 800, 1344)).to(torch.bfloat16),
                                       t(rng.randn(64, 3, 7, 7) * 0.1), t(0.5 + rng.rand(64)),
                                       t(rng.randn(64) * 0.1))


def median_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/probe_stem_numerics.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_stem_numerics: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = {"recompute": build("recompute", int(re.search(
        r"REDO_EXP = (-?\d+)", (native.CSRC / "stem.cu").read_text()).group(1))),
        "tensor cores only": build("tc_only", -126)}
    report = {"cases": []}
    for name, (x, cw, sc, sh) in inputs(dev):
        plain = cuda_stem.stem_plain(x, cw, sc, sh, torch.bfloat16)
        exact = exact_stem(x, cw, sc, sh)
        row = {"input": name, "values": plain.numel(),
               "plain_beyond_1ulp_of_exact": beyond_ulp(plain, exact)}
        for tag, dll in libs.items():
            got = run(dll, x, cw, sc, sh)
            row[tag] = {"beyond_1ulp_of_plain": beyond_ulp(got, plain),
                        "beyond_1ulp_of_exact": beyond_ulp(got, exact),
                        "differ_from_plain": int((got != plain).sum())}
        report["cases"].append(row)
        print(json.dumps(row), flush=True)
    x, cw, sc, sh = next(v for k, v in inputs(dev) if k.startswith("chip_smoke"))
    for dtype in (torch.bfloat16, torch.float32):
        xi = x.to(dtype)
        for tag, dll in list(libs.items()) * 2:
            report.setdefault("ms", []).append(
                {"build": tag, "input": str(dtype), "ms": median_ms(lambda: run(dll, xi, cw, sc,
                                                                                 sh))})
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
