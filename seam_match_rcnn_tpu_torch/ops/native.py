"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into one shared library with a
plain C interface, loaded with ``ctypes``; no PyTorch headers are involved,
so a build takes seconds.  The library is named by a hash of the sources
and the flags, under ``build/seam_torch_kernels/`` at the root of the
checkout, and is rebuilt only when that hash changes.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` turns a non-zero status into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seam_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3",
    # no automatic multiply-add contraction: the RoIAlign geometry must round
    # like the plain PyTorch version's separate ops; kernels that want an FMA
    # call fmaf() explicitly
    "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, bias, out, B, H, W, x is f32, out is f32, stream
    "seam_stem_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # pooled rows, pooled columns, recompute exponent (int* each)
    "seam_stem_tile": [_P, _P, _P],
    # 4 level pointers, 4 heights, 4 widths, 4 scales, rois, out,
    # N, R, C, output_size, sampling_ratio, is_bf16, stream
    "seam_roi_align_forward": [_P] * 4 + [_I] * 8 + [_F] * 4
    + [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # 4 gradient level pointers, 4 heights, 4 widths, 4 scales,
    # cotangent, rois, N, R, C, output_size, sampling_ratio, out is bf16, stream
    "seam_roi_align_adjoint": [_P] * 4 + [_I] * 8 + [_F] * 4
    + [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # 4 level pointers, 4 heights, 4 widths, 4 scales, rois, out,
    # N, R, C, output_size, sampling_ratio, is_bf16, stream
    "seam_roi_align_patch": [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 2 + [_I] * 6 + [_P],
    # 4 int8 level pointers, 4 heights, 4 widths, 4 scales, rois, channel
    # scales, out, N, R, C, output_size, sampling_ratio, out_bf16, stream
    "seam_roi_align_patch_int8": [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P] * 3 + [_I] * 6 + [_P],
    # seqs, mask, 11 weight pointers, out, S, T, stream
    "seam_nlb_aggregate": [_P] * 14 + [_I, _I, _P],
    # x, y, w, b, out, Q, G, C, tile rows, stream
    "seam_pairwise_scores": [_P] * 5 + [_I] * 4 + [_P],
    # y, scale, shift, residual, residual scale, residual shift, out,
    # numel, C, H*W, residual kind, relu, is f32, 16-byte aligned, stream
    "seam_bn_epilogue_forward": [_P] * 7 + [_I] * 7 + [_P],
    # grad, out, scale, residual scale, grad_y, grad_r,
    # numel, C, H*W, residual kind, relu, is f32, 16-byte aligned, stream
    "seam_bn_epilogue_backward": [_P] * 6 + [_I] * 7 + [_P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of seam_match_rcnn_tpu_torch need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libseam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    nvcc's output, with the ``-Xptxas -v`` register and spill report, is
    kept beside the library as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    units = [src for src in _sources() if src.suffix == ".cu"]
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in units]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(units, objs)]
    report, failed = "", []
    for src, proc in zip(units, procs):
        log = proc.communicate()[0]
        report += f"== {src.name}\n{log}"
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        report += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{report}")
    out.with_suffix(".log").write_text(report)
    os.replace(tmp, out)  # atomic: concurrent builders never load a torn file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.seam_cuda_error_string.argtypes = [ctypes.c_int]
        lib.seam_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().seam_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def ptr(t) -> int:
    """A tensor's data pointer as a launch takes it (ctypes converts the int
    for a ``c_void_p`` argument)."""
    return t.data_ptr()


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a ``torch.device`` with
    its index), as the raw handle a launch takes.  The private call is the
    one Triton's launcher makes: ``torch.cuda.current_stream(device)`` builds
    a Stream object, which costs several microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device(dev):
    """The context in which to launch on ``dev``: none when ``dev`` is the
    current device (the common case, and entering ``torch.cuda.device``
    costs microseconds a launch), else ``torch.cuda.device(dev)``."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def require(cond: bool, name: str, what: str) -> None:
    """Input check of a kernel wrapper: raise on what the kernel does not take."""
    if not cond:
        raise ValueError(f"{name}: {what}")
